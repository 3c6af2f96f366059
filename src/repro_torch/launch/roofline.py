"""The roofline model of the port on an H100 (a port of
``benchmarks/roofline.py``, inside the package): the three per-device
terms of a dry-run record (``launch/dryrun.py``),

    compute    = FLOPs a device / the peak for the matmuls' dtype
    memory     = bytes a device moves / HBM bandwidth
    collective = collective bytes a device / link bandwidth, the
                 tensor-parallel all-reduces and gathers of the model
                 group over its own link (NVLink where M <= 8) beside
                 the data group's

and the bytes and operations of every hand-written kernel's launch
(:func:`kernel_cost`), from which ``chip_smoke.py`` takes each kernel's
bound and the dry run each launch's share of a step.

The constants are the H100 SXM's data-sheet figures, not measurements:
3.35 TB/s of HBM3, 989 TFLOP/s of dense bf16 on the tensor cores, 67
TFLOP/s of float32 outside them (TF32 stays off, as ``chip_smoke.py``
sets it), NVLink 4 at 450 GB/s a direction inside one 8-GPU node, and
one 400 Gb/s NIC a GPU (50 GB/s) between nodes, which the collective
term takes once a mesh has more than 8 devices.

``model_flops`` is 6ND for training and 2ND for inference (N the active
parameters, D the global tokens); ``useful_ratio`` = model FLOPs / (FLOPs
a device x devices) shows what the step computes beyond it (remat,
attention, the compression).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--tag T]

reads ``artifacts/dryrun/*.json`` and writes ``artifacts/roofline.md``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import torch

#: HBM3 bandwidth, bytes/s (H100 SXM data sheet)
HBM_BW = 3.35e12
#: peak operations/s by the dtype of the operands: bf16 dense on the
#: tensor cores, float32 outside them (TF32 off)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: NVLink 4, bytes/s a direction, inside one 8-GPU node
LINK_BW = 450e9
#: one 400 Gb/s NIC a GPU, bytes/s, between nodes
NET_BW = 50e9
#: GPUs of one NVLink node: a larger mesh's collectives cross the network
NODE_GPUS = 8
#: one card's memory, bytes (the data sheet's 80 GB)
DEVICE_BYTES = 80e9

ART_DIR = "artifacts/dryrun"


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def live_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (window > 0: sliding-window) mask
    keeps in a sequence of S positions."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _topk_compress(rows, n, iters=24, elem=4):
    elems = rows * n
    return (3.0 * elem * elems + 4.0 * rows, 3.0 * (iters + 4) * elems,
            torch.float32)


def _topk_compact(rows, n, kcap, iters=24, elem=4):
    elems = rows * n
    return (2.0 * elem * elems + (4.0 + elem) * rows * kcap + 4.0 * rows,
            3.0 * (iters + 4) * elems, torch.float32)


def _qsgd(rows, n, elem=4):
    return 3.0 * elem * rows * n, 12.0 * rows * n, torch.float32


def _sparse_gemm(M, n, R, kcap=None, nnz=None, x_bytes=2):
    if nnz is None:
        nnz = R * kcap
    return (8.0 * nnz + float(x_bytes) * M * n + 4.0 * M * R,
            2.0 * M * nnz, torch.float32)


def _qdq_gemm(M, n, R, x_bytes=2):
    return (1.0 * R * n + 4.0 * R + float(x_bytes) * M * n + 4.0 * M * R,
            2.0 * M * R * n, torch.float32)


def _paged_decode(B, H, KV, hd, P, page_size=16, tokens=None, quant=False,
                  elem=2):
    if tokens is None:
        tokens = B * P * page_size
    page = 1 if quant else elem
    nbytes = (2.0 * tokens * KV * hd * page + (8.0 * tokens if quant else 0)
              + 2 * float(elem) * B * H * hd + 4.0 * B * P + 4.0 * B)
    return nbytes, 4.0 * H * hd * tokens, torch.float32


def _flash_decode(B, H, KV, hd, C, tokens=None, elem=2):
    if tokens is None:
        tokens = B * C
    nbytes = (2.0 * tokens * KV * hd * elem + B * C
              + 2 * float(elem) * B * H * hd)
    return nbytes, 4.0 * H * hd * tokens, torch.float32


def _flash_attention(B, S, H, KV, D, window=-1, elem=2):
    pairs = B * live_pairs(S, window)
    return (float(elem) * B * S * D * (2 * H + 2 * KV), 4.0 * D * H * pairs,
            torch.bfloat16 if elem == 2 else torch.float32)


_COSTS = {"topk_compress": _topk_compress, "topk_compact": _topk_compact,
          "qsgd": _qsgd, "sparse_gemm": _sparse_gemm, "qdq_gemm": _qdq_gemm,
          "paged_decode": _paged_decode, "flash_decode": _flash_decode,
          "flash_attention": _flash_attention}


def kernel_cost(kernel: str, **shape) -> tuple:
    """(bytes, operations, the operations' dtype) of one launch of
    ``kernel`` (a ``launch_stats.LAUNCHES`` key) at ``shape``: each input
    read once and each output written once, and the operations it does
    on them.

    * ``topk_compress`` (rows, n, iters=24, elem=4): read the
      accumulator, write the survivors and the memory, a count a row;
      3 (iters + 4) operations an element (the bisection's compares and
      counts);
    * ``topk_compact`` (rows, n, kcap, iters=24, elem=4): read the
      accumulator, write the memory and kcap (int32 idx, val) slots and
      a count a row;
    * ``qsgd`` (rows, n, elem=4): read x and the uniforms, write the
      levels; 12 operations an element;
    * ``sparse_gemm`` (M, n, R, kcap, nnz=None, x_bytes=2): read the nnz
      live (idx, val) slots and x once, write [M, R] float32; 2 M nnz;
    * ``qdq_gemm`` (M, n, R, x_bytes=2): int8 levels, a scale a row, x,
      the [M, R] float32 output; 2 M R n;
    * ``paged_decode`` (B, H, KV, hd, P, page_size, tokens=None,
      quant=False, elem=2): K and V of the live tokens (int8 with a
      scale a slot each when ``quant``), q and the output, the tables
      and lengths; 4 H hd a token;
    * ``flash_decode`` (B, H, KV, hd, C, tokens=None, elem=2): K and V of
      the valid slots, the [B, C] mask, q and the output;
    * ``flash_attention`` (B, S, H, KV, D, window=-1, elem=2): q, k, v and
      the output once; 4 D H a live (query, key) pair, on the bf16
      tensor cores when ``elem`` is 2.

    Where the work depends on the data (``nnz``, ``tokens``), pass this
    run's count; left out, it is the most the shapes allow (every slot
    live), as a dry run on ``meta`` has no data to count."""
    if kernel not in _COSTS:
        raise ValueError(f"unknown kernel {kernel!r}; have {sorted(_COSTS)}")
    return _COSTS[kernel](**shape)


def bound_ms(nbytes: float, ops: float,
             dtype: torch.dtype = torch.float32) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card takes to
    move ``nbytes`` or do ``ops`` at the peak for ``dtype``, the
    larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bytes_moved(kernel: str, rows: int, row_len: int, k: int,
                       kcap: Optional[int] = None,
                       dtype_bytes: int = 4) -> float:
    """Minimum HBM traffic (bytes) of one compression-kernel launch:
    ``repro``'s signature (its ``benchmarks/roofline.py``) over
    :func:`kernel_cost`'s bytes, ``k`` unused as there."""
    shape = dict(rows=rows, n=row_len, elem=dtype_bytes)
    if kernel == "topk_compact":
        if kcap is None:
            raise ValueError("topk_compact bytes model needs kcap")
        shape["kcap"] = kcap
    elif kernel not in ("topk_compress", "qsgd"):
        raise ValueError(f"unknown kernel {kernel!r}")
    return kernel_cost(kernel, **shape)[0]


def hbm_bound_us(bytes_moved: float) -> float:
    """The roofline floor: time (µs) to move ``bytes_moved`` at HBM_BW."""
    return bytes_moved / HBM_BW * 1e6


def pct_hbm_bound(measured_us: float, bytes_moved: float) -> float:
    """The HBM floor as a percentage of the measured time (above 100:
    the model under-counts)."""
    return 100.0 * hbm_bound_us(bytes_moved) / max(measured_us, 1e-9)


# ---------------------------------------------------------------------------
# dry-run records
# ---------------------------------------------------------------------------


def model_flops(rec: dict) -> float:
    n = rec.get("active_params", rec.get("params", 0))
    if rec["kind"] == "train":
        tokens = rec["seq_len"] * rec["global_batch"]
        return 6.0 * n * tokens
    if rec["kind"] == "prefill":
        tokens = rec["seq_len"] * rec["global_batch"]
        return 2.0 * n * tokens
    return 2.0 * n * rec["global_batch"]  # decode: one token per sequence


def link_bw(n_devices: int) -> float:
    """The collective term's bandwidth: NVLink inside one node, the
    network past ``NODE_GPUS`` devices."""
    return LINK_BW if n_devices <= NODE_GPUS else NET_BW


def collective_s(step: dict, n_devices: int, model_axis: int = 1) -> float:
    """A step's collective term: the model group's bytes (the
    tensor-parallel all-reduces and gathers, ``collectives_by_group``)
    over the link of ``model_axis`` devices, every other byte over the
    link of the whole mesh; a record without the split, every byte over
    the mesh's link."""
    groups = step.get("collectives_by_group")
    if not groups:
        return step["collectives"]["total"] / link_bw(n_devices)
    tp = groups.get("model", {}).get("total", 0)
    rest = step["collectives"]["total"] - tp
    return tp / link_bw(model_axis) + rest / link_bw(n_devices)


HINTS = {
    "compute": "reduce recompute (remat policy) / increase arithmetic "
               "intensity per chip",
    "memory": "fuse/stream weight reads; shard more state (ZeRO); "
              "larger per-chip batch amortizes weight traffic",
    "collective": "overlap or shrink collectives: compressed/sparse "
                  "aggregation, fewer all-gathers (act resharding), "
                  "bigger H (fewer syncs)",
}


def analyze(rec: dict, step_name: Optional[str] = None) -> Optional[dict]:
    """The three terms of a record's step (default: ``sync_step`` where
    there is one), its dominant term, model FLOPs and ``useful_ratio``,
    with ``repro``'s keys; the compute peak is the one for the record's
    matmul ``dtype`` (bf16 where it names none)."""
    if rec.get("status") != "ok":
        return None
    steps = rec["steps"]
    name = step_name or ("sync_step" if "sync_step" in steps
                         else next(iter(steps)))
    st = steps[name]
    chips = rec["n_devices"]
    peak = PEAK_FLOPS[getattr(torch, rec.get("dtype", "bfloat16"))]
    t_comp = st["flops"] / peak
    t_mem = st["bytes_accessed"] / HBM_BW
    t_coll = collective_s(st, chips, rec.get("model_axis", 1))
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec)
    ratio = mf / (st["flops"] * chips) if st["flops"] > 0 else float("nan")
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "step": name,
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dom,
        "model_flops": mf,
        "useful_ratio": ratio,
        "temp_gib": st["memory"]["temp_bytes"] / 2 ** 30,
        "arg_gib": st["memory"]["argument_bytes"] / 2 ** 30,
        "hint": HINTS[dom],
    }


def load_records(art_dir: str = ART_DIR, tag: str = "") -> list:
    """The records in ``art_dir``: untagged ones, or those of ``tag``."""
    recs = []
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        base = os.path.basename(fn)
        if tag:
            if not base.endswith(f"__{tag}.json"):
                continue
        elif base.count("__") >= 3:
            continue  # tagged experiment artifacts are not baselines
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | mesh | step | compute s | memory s | "
           "collective s | dominant | useful | temp GiB |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['step']} | "
            f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | "
            f"{r['t_collective_s']:.3e} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['temp_gib']:.2f} |")
    return "\n".join(lines)


def matrix_table(recs: list) -> str:
    """The records beside their terms: parameters, one device's argument
    and temp GB (10^9 bytes) of the step ``analyze`` reads, whether the
    busier step fits one card, FLOPs, the three terms, the dominant one
    and ``useful_ratio``; a record that is not ``ok`` by its status."""
    lines = ["| arch | shape | mesh | params | arg GB | temp GB | fits | "
             "FLOPs | compute s | memory s | collective s | dominant | "
             "useful |", "|---" * 13 + "|"]
    for rec in recs:
        a = analyze(rec)
        if a is None:
            lines.append(f"| {rec['arch']} | {rec['shape']} | "
                         f"{rec['mesh']} | {rec['status']}"
                         + " |" * 10)
            continue
        mem = rec["steps"][a["step"]]["memory"]
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{rec['params'] / 1e9:.2f} B | "
            f"{mem['argument_bytes'] / 1e9:.1f} | "
            f"{mem['temp_bytes'] / 1e9:.1f} | "
            f"{'yes' if rec['fits'] else 'no'} | "
            f"{rec['steps'][a['step']]['flops']:.3g} | "
            f"{a['t_compute_s']:.3g} | {a['t_memory_s']:.3g} | "
            f"{a['t_collective_s']:.3g} | {a['dominant']} | "
            f"{a['useful_ratio']:.2f} |")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> str:
    """Analyze the records and write the table; returns its text."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--art-dir", default=ART_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="artifacts/roofline.md")
    ap.add_argument("--wide", action="store_true",
                    help="every record with its memory, fit and FLOPs "
                         "beside the terms (matrix_table)")
    args = ap.parse_args(argv)
    recs = load_records(args.art_dir, args.tag)
    rows = [a for a in (analyze(r) for r in recs) if a is not None]
    text = matrix_table(recs) if args.wide else markdown_table(rows)
    if rows:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return text


if __name__ == "__main__":
    main()
