"""The port's roofline model (``repro_torch.launch.roofline``) and its
collective counter (``repro_torch.launch.roofline_parse``), on the CPU.

* Against ``repro``'s ``benchmarks/roofline.py``: ``kernel_bytes_moved``
  on hypothesis shapes, ``model_flops``, ``analyze`` (``repro``'s
  module constants patched to the H100's and the record's peak) and
  ``markdown_table`` give the same numbers and text.
* ``collective_bytes`` of the events that ``tests/test_dryrun.py``'s
  HLO describes equals ``repro``'s parse of that HLO.
* ``kernel_cost`` and ``bound_ms`` give, exactly, the bounds that
  ``chip_smoke.py`` computed with its own formulas before they moved
  here (the formulas are copied below as they were), and those bounds
  round to the "bound" column of PERF.md's table of kernels.
"""

import math
import os
import sys
from decimal import Decimal

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.launch import roofline as rl
from repro_torch.launch import roofline_parse as rp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(scope="module")
def jrl():
    """``repro``'s roofline module (``benchmarks/roofline.py``)."""
    from benchmarks import roofline
    return roofline


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(kernel=st.sampled_from(["topk_compress", "topk_compact", "qsgd"]),
       rows=st.integers(1, 1 << 18), row_len=st.integers(1, 1 << 19),
       k=st.integers(1, 4096), kcap=st.integers(1, 2048),
       dtype_bytes=st.sampled_from([2, 4]))
def test_kernel_bytes_moved_equals_repro(jrl, kernel, rows, row_len, k, kcap,
                                         dtype_bytes):
    assert rl.kernel_bytes_moved(kernel, rows, row_len, k, kcap,
                                 dtype_bytes) == jrl.kernel_bytes_moved(
        kernel, rows, row_len, k, kcap, dtype_bytes)
    assert rl.hbm_bound_us(1e9) == pytest.approx(1e9 / 3.35e12 * 1e6)


def test_kernel_bytes_moved_refusals(jrl):
    for mod in (rl, jrl):
        with pytest.raises(ValueError):
            mod.kernel_bytes_moved("topk_compact", 4, 128, 2)
        with pytest.raises(ValueError):
            mod.kernel_bytes_moved("nope", 4, 128, 2)


def _record(kind, n_devices, flops=3.2e13, nbytes=4.1e11, coll=2.5e9,
            temp=7 * 2 ** 30, arg=3 * 2 ** 30, dtype=None):
    step = {"flops": flops, "bytes_accessed": nbytes,
            "collectives": {"all-reduce": coll, "total": coll},
            "memory": {"temp_bytes": temp, "argument_bytes": arg}}
    rec = {"status": "ok", "arch": "yi-6b", "shape": "train_4k",
           "mesh": f"dp{n_devices}", "n_devices": n_devices, "kind": kind,
           "params": 6_061_035_520, "active_params": 6_061_035_520,
           "seq_len": 4096, "global_batch": 256,
           "steps": ({"sync_step": step, "local_step": dict(step, flops=1.0)}
                     if kind == "train" else {kind: step})}
    if dtype is not None:
        rec["dtype"] = dtype
    return rec


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equals_repro(jrl, kind):
    rec = _record(kind, 256)
    assert rl.model_flops(rec) == jrl.model_flops(rec)
    del rec["active_params"]
    assert rl.model_flops(rec) == jrl.model_flops(rec)


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("n_devices", [1, 8, 256, 512])
@pytest.mark.parametrize("dtype", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_analyze_equals_repro(jrl, monkeypatch, kind, dtype, n_devices):
    """repro's analyze with its constants set to the H100's: the peak of
    the record's dtype (bf16 by default) and NVLink up to 8 devices, the
    network past them."""
    rec = _record(kind, n_devices, dtype=dtype)
    monkeypatch.setattr(jrl, "PEAK_FLOPS", rl.PEAK_FLOPS[
        getattr(torch, dtype or "bfloat16")])
    monkeypatch.setattr(jrl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW", rl.LINK_BW if n_devices <= 8
                        else rl.NET_BW)
    _same(rl.analyze(rec), jrl.analyze(rec))
    _same(rl.analyze(rec, "local_step" if kind == "train" else None),
          jrl.analyze(rec, "local_step" if kind == "train" else None))
    for bad in ({**rec, "status": "error"}, {**rec, "status": "skipped"}):
        assert rl.analyze(bad) is None and jrl.analyze(bad) is None
    zero = _record(kind, n_devices, flops=0.0, dtype=dtype)
    _same(rl.analyze(zero), jrl.analyze(zero))


def test_markdown_table_equals_repro(jrl, monkeypatch):
    monkeypatch.setattr(jrl, "PEAK_FLOPS", rl.PEAK_FLOPS[torch.bfloat16])
    monkeypatch.setattr(jrl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW", rl.NET_BW)
    recs = [_record(k, 256) for k in ("train", "prefill", "decode")]
    rows = [rl.analyze(r) for r in recs]
    assert rl.markdown_table(rows) == jrl.markdown_table(
        [jrl.analyze(r) for r in recs])
    assert rl.markdown_table([]) == jrl.markdown_table([])


def test_load_records_and_main(jrl, tmp_path):
    """The same files load the same records (tagged ones apart), and the
    CLI writes the table of what it loads."""
    import json
    art = tmp_path / "dry"
    art.mkdir()
    for name, rec in (("yi-6b__train_4k__dp256", _record("train", 256)),
                      ("yi-6b__decode_32k__dp256", _record("decode", 256)),
                      ("yi-6b__train_4k__dp256__exp", _record("train", 8))):
        (art / f"{name}.json").write_text(json.dumps(rec))
    for tag in ("", "exp"):
        assert rl.load_records(str(art), tag) == jrl.load_records(str(art),
                                                                  tag)
    out = tmp_path / "roofline.md"
    text = rl.main(["--art-dir", str(art), "--out", str(out)])
    assert out.read_text() == text + "\n"
    assert text.count("\n") == 3 and "**" in text


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

HLO = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %x), dimensions={0}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %y), to_apply=%sum
  %rs = f32[2,4]{1,0} reduce-scatter(f32[16,4]{1,0} %z), dimensions={0}
  %a2a = bf16[4,16]{1,0} all-to-all(bf16[4,16]{1,0} %w), dimensions={0}
  %cp = f32[10]{0} collective-permute(f32[10]{0} %v), source_target_pairs={{0,1}}
"""

#: the events the HLO above describes, in the three ways a dtype is named
EVENTS = [("all-gather", torch.bfloat16, (8, 128)),
          ("all-reduce", "float", (256,)),
          ("reduce-scatter", "f32", (2, 4)),
          ("all-to-all", "c10::BFloat16", (4, 16)),
          ("collective-permute", torch.float32, (10,))]


def test_collective_bytes_equals_repro():
    from repro.launch import roofline_parse as jrp
    assert rp.collective_bytes(EVENTS) == jrp.collective_bytes(HLO)
    assert rp.collective_bytes([]) == jrp.collective_bytes("") == {
        "total": 0}
    assert rp.collective_bytes([("all-reduce", torch.float32, ())]) == {
        "all-reduce": 4, "total": 4}


# ---------------------------------------------------------------------------
# the kernels' bounds (chip_smoke.py's formulas, as they were)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def old_bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def old_topk(rows, n, iters=24):
    elems = rows * n
    return old_bound_ms(12.0 * elems + 4.0 * rows, 3.0 * (iters + 4) * elems)


def old_compact(rows, n, kcap, iters=24):
    elems = rows * n
    return old_bound_ms(8.0 * elems + 8.0 * rows * kcap + 4.0 * rows,
                        3.0 * (iters + 4) * elems)


def old_qsgd(rows, n):
    return old_bound_ms(12.0 * rows * n, 12.0 * rows * n)


def old_sparse_gemm(M, n, R, nnz):
    return old_bound_ms(8.0 * nnz + 2.0 * M * n + 4.0 * M * R, 2.0 * M * nnz)


def old_qdq_gemm(M, n, R):
    return old_bound_ms(1.0 * R * n + 4.0 * R + 2.0 * M * n + 4.0 * M * R,
                        2.0 * M * R * n)


def old_paged(B, H, KV, hd, P, tokens, quant):
    elem = 1 if quant else 2
    nbytes = (2.0 * tokens * KV * hd * elem + (8.0 * tokens if quant else 0)
              + 2 * 2.0 * B * H * hd + 4.0 * B * P + 4.0 * B)
    return old_bound_ms(nbytes, 4.0 * H * hd * tokens)


def old_flash_decode(B, H, KV, hd, C, tokens):
    nbytes = 2.0 * tokens * KV * hd * 2 + B * C + 2 * 2.0 * B * H * hd
    return old_bound_ms(nbytes, 4.0 * H * hd * tokens)


def old_flash_attention(B, S, H, KV, D, window):
    pairs = B * rl.live_pairs(S, window)
    ops = 4.0 * D * H * pairs
    nbytes = 2.0 * B * S * D * (2 * H + 2 * KV)
    return old_bound_ms(nbytes, ops, BF16_OPS_PER_S)


#: (kernel, kernel_cost's shape, the old formula's value, PERF.md's bound)
ROWS = [
    ("topk_compress", dict(rows=49312, n=4096), old_topk(49312, 4096),
     "0.724"),
    ("topk_compress", dict(rows=179712, n=1152), old_topk(179712, 1152),
     "0.742"),
    ("topk_compress", dict(rows=26624, n=1152), old_topk(26624, 1152),
     "0.110"),
    ("topk_compress", dict(rows=6656, n=1152), old_topk(6656, 1152),
     "0.0275"),
    ("topk_compress", dict(rows=16, n=524288), old_topk(16, 524288),
     "0.0300"),
    ("topk_compress", dict(rows=8, n=524288), old_topk(8, 524288), "0.0150"),
    ("topk_compress", dict(rows=56, n=65536), old_topk(56, 65536), "0.0131"),
    ("topk_compress", dict(rows=8, n=65536), old_topk(8, 65536), "0.00188"),
    ("topk_compress", dict(rows=15, n=7936), old_topk(15, 7936), "0.00043"),
    ("topk_compress", dict(rows=15, n=128), old_topk(15, 128), "0.0000069"),
    ("topk_compact", dict(rows=179712, n=1152, kcap=128),
     old_compact(179712, 1152, 128), "0.550"),
    ("topk_compact", dict(rows=26624, n=1152, kcap=128),
     old_compact(26624, 1152, 128), "0.0814"),
    ("topk_compact", dict(rows=6656, n=1152, kcap=128),
     old_compact(6656, 1152, 128), "0.0204"),
    ("topk_compact", dict(rows=4096, n=1152, kcap=128),
     old_compact(4096, 1152, 128), "0.0125"),
    ("qsgd", dict(rows=16, n=524288), old_qsgd(16, 524288), "0.0300"),
    ("qsgd", dict(rows=56, n=65536), old_qsgd(56, 65536), "0.0131"),
    ("qsgd", dict(rows=1, n=524288), old_qsgd(1, 524288), "0.00188"),
    ("qsgd", dict(rows=7, n=65536), old_qsgd(7, 65536), "0.00164"),
    ("sparse_gemm", dict(M=2048, n=1152, R=6912, nnz=6912 * 12),
     old_sparse_gemm(2048, 1152, 6912, 6912 * 12), "0.0185"),
    ("sparse_gemm", dict(M=2048, n=6912, R=1152, nnz=1152 * 69),
     old_sparse_gemm(2048, 6912, 1152, 1152 * 69), "0.0115"),
    ("sparse_gemm", dict(M=128, n=4096, R=11008, nnz=11008 * 41),
     old_sparse_gemm(128, 4096, 11008, 11008 * 41), "0.0031"),
    ("qdq_gemm", dict(M=8, n=4096, R=64000), old_qdq_gemm(8, 4096, 64000),
     "0.079"),
    ("qdq_gemm", dict(M=4, n=1152, R=262144), old_qdq_gemm(4, 1152, 262144),
     "0.092"),
    ("qdq_gemm", dict(M=1, n=1152, R=262144), old_qdq_gemm(1, 1152, 262144),
     "0.091"),
    ("paged_decode", dict(B=8, H=32, KV=4, hd=128, P=32, tokens=806),
     old_paged(8, 32, 4, 128, 32, 806, False), "0.00053"),
    ("paged_decode", dict(B=8, H=32, KV=4, hd=128, P=32, tokens=806,
                          quant=True),
     old_paged(8, 32, 4, 128, 32, 806, True), "0.00029"),
    ("flash_decode", dict(B=8, H=32, KV=4, hd=128, C=512, tokens=1656),
     old_flash_decode(8, 32, 4, 128, 512, 1656), "0.0011"),
    ("flash_attention", dict(B=1, S=2048, H=4, KV=1, D=256, window=1024),
     old_flash_attention(1, 2048, 4, 1, 256, 1024), "0.0065"),
    ("flash_attention", dict(B=1, S=2048, H=4, KV=1, D=256, window=-1),
     old_flash_attention(1, 2048, 4, 1, 256, -1), "0.0087"),
    ("flash_attention", dict(B=4, S=2048, H=32, KV=32, D=112, window=-1),
     old_flash_attention(4, 2048, 32, 32, 112, -1), "0.1217"),
]


@pytest.mark.parametrize("kernel,shape,old,perf", ROWS,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(ROWS)])
def test_kernel_cost_pins_the_bounds(kernel, shape, old, perf):
    """chip_smoke.py's bound of each row, bit for bit, and PERF.md's
    figure as its rounding."""
    nbytes, ops, dtype = rl.kernel_cost(kernel, **shape)
    got = rl.bound_ms(nbytes, ops, dtype)
    assert got == old
    d = Decimal(perf)
    assert abs(Decimal(repr(got[0])) - d) <= Decimal(5).scaleb(
        d.as_tuple().exponent - 1), (got, perf)


def test_kernel_cost_defaults_count_every_slot():
    """Left out, the data-dependent counts are the most the shapes allow
    (a dry run on meta has no data to count)."""
    assert rl.kernel_cost("sparse_gemm", M=4, n=64, R=32, kcap=8) == \
        rl.kernel_cost("sparse_gemm", M=4, n=64, R=32, nnz=256)
    assert rl.kernel_cost("flash_decode", B=2, H=4, KV=2, hd=16, C=40) == \
        rl.kernel_cost("flash_decode", B=2, H=4, KV=2, hd=16, C=40,
                       tokens=80)
    assert rl.kernel_cost("paged_decode", B=2, H=4, KV=2, hd=16, P=3,
                          page_size=8) == rl.kernel_cost(
        "paged_decode", B=2, H=4, KV=2, hd=16, P=3, page_size=8, tokens=48)
    assert rl.kernel_cost("flash_attention", B=1, S=8, H=2, KV=1, D=16,
                          elem=4)[2] == torch.float32
    with pytest.raises(ValueError):
        rl.kernel_cost("matmul", M=1)
    assert rl.bound_ms(3.35e9, 0.0) == (1.0, "bytes")
    assert rl.bound_ms(0.0, 989e9, torch.bfloat16) == (1.0, "operations")


def _rec(name, ts, dims, types):
    return {"ph": "X", "name": name, "ts": ts,
            "args": {"Input Dims": dims, "Input type": types}}


@pytest.mark.parametrize("listed", [True, False])
def test_events_from_trace_reads_the_backend_records(listed):
    """A c10d all-reduce names its tensor list's dtype nowhere, and some
    torch versions leave out its shapes: both come from the backend's
    record of the same collective; an all-gather's own output shape
    counts."""
    records = [
        _rec("c10d::allreduce_", 1, [[[3, 4]], [], []] if listed
             else [[], [], []], ["TensorList", "", ""]),
        _rec("c10d::_allgather_base_", 3, [[10], [5], []],
             ["int", "int", ""]),
        _rec("gloo:all_gather", 3.5, [[5]], ["int"]),
        _rec("gloo:all_reduce", 2, [[3, 4]], ["float"]),
        _rec("aten::add", 4, [[3], [3]], ["float", "float"]),
        _rec("c10d::allreduce_", 5, [[[]], []] if listed else [[], []],
             ["TensorList", ""]),
        _rec("nccl:all_reduce", 6, [[]], ["c10::BFloat16"]),
        {"ph": "i", "name": "c10d::allreduce_", "ts": 7},
    ]
    got = rp.events_from_trace(records)
    assert got == [("all-reduce", "float", (3, 4)),
                   ("all-gather", "int", (10,)),
                   ("all-reduce", "c10::BFloat16", ())]
    assert rp.collective_bytes(got) == {"all-reduce": 50, "all-gather": 40,
                                        "total": 90}


@pytest.mark.parametrize("records,match", [
    ([_rec("c10d::_allgather_base_", 1, [[10], [5]], ["c10::Foo", "int"])],
     "unknown dtype"),
    ([_rec("c10d::allreduce_", 1, [[[3, 4]], []], ["TensorList", ""])],
     "no dtype"),
    ([_rec("c10d::allreduce_", 1, [[], []], ["TensorList", ""])],
     "no shape"),
], ids=["unknown-name", "no-backend-dtype", "no-backend-shape"])
def test_events_from_trace_refuses_to_guess(records, match):
    """An unknown dtype name, or a collective whose dtype or shapes no
    record gives, raises rather than counting a guessed width."""
    with pytest.raises(ValueError, match=match):
        rp.events_from_trace(records)
    with pytest.raises(ValueError, match="unknown dtype"):
        rp.collective_bytes([("all-reduce", "c10::Foo", (2,))])
