"""Operator → CUDA-kernel dispatch for the Qsparse engine.

A port of ``repro.kernels.dispatch`` (see its docstring and DESIGN.md
§3.2-§3.4).  The engine compresses the error-compensated accumulator
``m + x - x̂`` once per sync round; this module routes each (operator,
leaf) pair to the hand-written kernels when the rules below allow, and
to the dense reference operators in ``core/operators.py`` otherwise —
same dense output, same wire-bit accounting either way.

  ========================  =======================================
  operator                  kernel
  ========================  =======================================
  ``TopK``                  ``topk_compress`` on a single padded row
  ``RowTopK``               ``topk_compress``, one row per block-row
  ``SignSparsifier`` (top,  ``topk_compress(sign=True)`` single row
  m=2)
  ``RowSignTopK`` (m=2)     ``topk_compress(sign=True)`` per row
  ``QSGDQuantizer``         ``qsgd`` single bucket, given uniforms
  ========================  =======================================

The serving entries (``sparse_gemm``, ``qdq_gemm``, ``paged_decode``,
``flash_decode``) route the same way on their activations' device: the
hand-written kernel, or the kernel's plain version (``ref.py``) under
``mode="reference"``.

Eligibility is ``repro``'s, unchanged, because it decides which leaves
take which path: at least ``min_size`` elements (``mode="auto"`` only),
rows of a multiple of 128 elements, rows no longer than ``max_row``.
``mode="auto"`` dispatches when the tensors are on a CUDA device (where
``repro`` asks for a TPU); ``mode="kernel"`` always dispatches, and on
the CPU runs each kernel's plain version through the same packing path
and launch counters; ``mode="reference"`` never dispatches.

Workers: the engine hands its accumulators over with the worker axis
leading (``[B, ...]`` leaves, ``batched=True``).  Packing stacks every
worker's rows of a bucket into the same megabuffer, leaf-major and
worker-minor, so one sync costs one launch per bucket whatever the
number of workers; each worker's bits come from its own slice of the
survivor counts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bits as bitlib
from repro_torch.core.operators import (
    CompressionOp,
    QSGDQuantizer,
    RowSignTopK,
    RowTopK,
    SignSparsifier,
    TopK,
    ops_for_leaves,
    resolve_k,
    uniform,
)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_gemm as _sgemm
from repro_torch.kernels import topk_compress as _topk
from repro_torch.tree import tree_flatten, tree_unflatten

LANES = 128  # kernel rows are padded to a multiple of this (repro's rule)


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Where and when compression runs through the kernels.

    mode: "auto"      — kernels for tensors on a CUDA device (default)
          "kernel"    — always the kernel path (the plain versions on
                        the CPU); bypasses min_size but not the
                        structural limits
          "reference" — never dispatch (pure core/operators.py)
    min_size: smallest leaf (elements) worth a kernel launch in "auto"
    max_row:  longest kernel row (elements)
    block_rows: kernel geometry where a kernel has one (``paged_decode``'s
          pages per tile); None takes the kernel's default.  ``repro``
          resolves it through its autotune table first, which is not
          ported yet (ROADMAP queue 1 item 11).
    pack: megabuffer-pack same-bucket leaves (one kernel launch per
          bucket per sync round)
    """

    mode: str = "auto"
    min_size: int = 1 << 16
    max_row: int = 1 << 19
    block_rows: Optional[int] = None
    pack: bool = True

    def __post_init__(self):
        if self.mode not in ("auto", "kernel", "reference"):
            raise ValueError(f"unknown dispatch mode {self.mode!r}")

    def kernels_enabled(self, device=None) -> bool:
        if self.mode == "reference":
            return False
        if self.mode == "kernel":
            return True
        return _device(device).type == "cuda"


DEFAULT = DispatchConfig()


def _resolve(cfg: Optional[DispatchConfig]) -> DispatchConfig:
    return cfg if cfg is not None else DEFAULT


def _device(device) -> torch.device:
    """``None`` means where the port's work goes by default."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


# ---------------------------------------------------------------------------
# shape plumbing (batched: every tensor here carries a leading [B] axis)
# ---------------------------------------------------------------------------


def _size(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _padded_len(d: int, multiple: int) -> int:
    return d + ((-d) % multiple)


def _pad_cols(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-flat.shape[1]) % multiple
    return F.pad(flat, (0, pad)) if pad else flat


def _as_single_rows(xb: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B, n] float32, each worker's leaf flattened and
    zero-padded to a lane multiple.  Zero padding is select-safe: |0|
    never beats a real survivor, and never survives."""
    return _pad_cols(xb.reshape(xb.shape[0], -1).to(torch.float32), LANES)


def _as_rows(xb: torch.Tensor, row_len: int) -> torch.Tensor:
    """[B, ...] -> [B * nrows, row_len], worker-major."""
    flat = _pad_cols(xb.reshape(xb.shape[0], -1).to(torch.float32), row_len)
    return flat.reshape(-1, row_len)


def _restore(out2d: torch.Tensor, B: int, shape: tuple, dtype):
    d = _size(shape)
    return out2d.reshape(B, -1)[:, :d].reshape((B,) + tuple(shape)).to(dtype)


def capacity(k: int, n: int) -> int:
    """Lane-aligned compact survivor-buffer capacity for (k, row n)."""
    return min(_padded_len(max(k, 1), LANES), _padded_len(n, LANES))


# ---------------------------------------------------------------------------
# kernel rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """One operator-family → kernel mapping."""

    name: str
    matches: Callable[[CompressionOp], bool]
    eligible: Callable[[CompressionOp, tuple, "DispatchConfig"], bool]
    run: Callable  # (op, rng, xb, cfg) -> (dense_out [B, ...], bits [B])


def _global_row_ok(shape, cfg) -> bool:
    return _padded_len(_size(shape), LANES) <= cfg.max_row


def _row_len_of(op, shape) -> int:
    return min(op.row_len, _size(shape))


def _rows_ok(op, shape, cfg) -> bool:
    row = _row_len_of(op, shape)
    return row % LANES == 0 and row <= cfg.max_row


def _plan_topk(rule_name: str, op, xb: torch.Tensor):
    """Per-leaf Top_k-family launch plan: the pre-shaped [B * rows, n]
    float32 buffer, k, the sign flag, and the ledger closure mapping a
    [B] survivor count to [B] bits (float32, repro's expression order:
    ``32 * nrows + counted - 32`` for the row operators)."""
    shape = tuple(xb.shape[1:])
    d = _size(shape)
    if rule_name in ("topk_global", "signtopk_global"):
        sign = rule_name == "signtopk_global"
        k = resolve_k(op.k, d)
        rows = _as_single_rows(xb)
        if sign:
            bits_of = lambda c: bitlib.bits_signtopk_counted(d, c)
        else:
            bits_of = lambda c: bitlib.bits_topk_counted(d, c, op.value_bits)
    else:
        sign = rule_name == "row_signtopk"
        row = _row_len_of(op, shape)
        k = resolve_k(op.k, row)
        rows = _as_rows(xb, row)
        nrows = rows.shape[0] // xb.shape[0]
        # one 32-bit length/scale field per compression row; the counted
        # helpers already include one, hence the -32
        dev = xb.device
        if sign:
            bits_of = lambda c: (bitlib.f32(32 * nrows, dev)
                                 + bitlib.bits_signtopk_counted(row, c)
                                 - bitlib.f32(32, dev))
        else:
            bits_of = lambda c: (bitlib.f32(32 * nrows, dev)
                                 + bitlib.bits_topk_counted(
                                     row, c, op.value_bits)
                                 - bitlib.f32(32, dev))
    return rows, k, sign, bits_of


def _worker_counts(cnt: torch.Tensor, B: int) -> torch.Tensor:
    """[B * rows] per-row counts -> [B] per-worker survivor counts."""
    return cnt.reshape(B, -1).sum(dim=1)


def _run_topk_family(rule_name: str, op, rng, xb, cfg):
    B = xb.shape[0]
    rows, k, sign, bits_of = _plan_topk(rule_name, op, xb)
    sel, _mem, cnt = _topk.topk_compress(rows, k, sign=sign)
    return (_restore(sel, B, tuple(xb.shape[1:]), xb.dtype),
            bits_of(_worker_counts(cnt, B)))


def _plan_qsgd(rng, xb: torch.Tensor):
    """[B, n] padded rows and their uniforms: one leaf per worker is one
    bucket, its uniforms drawn exactly as the reference operator draws
    them (the leaf's element count, in flat order)."""
    B = xb.shape[0]
    flat = xb.reshape(B, -1).to(torch.float32)
    u = uniform(rng, flat.shape, xb.device)
    return _pad_cols(flat, LANES), _pad_cols(u, LANES)


def _qsgd_bits(op, out: torch.Tensor) -> torch.Tensor:
    """[B, ...] dequantized leaf -> [B] counted bits."""
    d = _size(tuple(out.shape[1:]))
    nz = (out.reshape(out.shape[0], -1) != 0.0).sum(dim=1)
    return bitlib.bits_qsgd(d, op.s, nz)


def _run_qsgd(op: QSGDQuantizer, rng, xb, cfg):
    rows, urows = _plan_qsgd(rng, xb)
    out = _restore(_qsgd.qsgd_quantize(rows, urows, op.s), xb.shape[0],
                   tuple(xb.shape[1:]), xb.dtype)
    return out, _qsgd_bits(op, out)


RULES: tuple[KernelRule, ...] = (
    KernelRule(
        "topk_global",
        lambda op: type(op) is TopK,
        lambda op, shape, cfg: _global_row_ok(shape, cfg),
        functools.partial(_run_topk_family, "topk_global"),
    ),
    KernelRule(
        "row_topk",
        lambda op: type(op) is RowTopK,
        lambda op, shape, cfg: _rows_ok(op, shape, cfg),
        functools.partial(_run_topk_family, "row_topk"),
    ),
    KernelRule(
        "signtopk_global",
        lambda op: (type(op) is SignSparsifier and op.sparsifier == "top"
                    and op.m == 2),
        lambda op, shape, cfg: _global_row_ok(shape, cfg),
        functools.partial(_run_topk_family, "signtopk_global"),
    ),
    KernelRule(
        "row_signtopk",
        lambda op: type(op) is RowSignTopK and op.m == 2,
        lambda op, shape, cfg: _rows_ok(op, shape, cfg),
        functools.partial(_run_topk_family, "row_signtopk"),
    ),
    KernelRule(
        "qsgd_global",
        lambda op: type(op) is QSGDQuantizer,
        lambda op, shape, cfg: _global_row_ok(shape, cfg),
        _run_qsgd,
    ),
)


def select_rule(op: CompressionOp, shape: tuple, dtype=torch.float32,
                cfg: Optional[DispatchConfig] = None,
                device=None) -> Optional[KernelRule]:
    """The kernel rule that would serve this (op, leaf) on ``device``
    (default: where the port runs by default), or None."""
    cfg = _resolve(cfg)
    if not cfg.kernels_enabled(device):
        return None
    if not dtype.is_floating_point:
        return None
    if cfg.mode == "auto" and _size(shape) < cfg.min_size:
        return None
    for rule in RULES:
        if rule.matches(op) and rule.eligible(op, tuple(shape), cfg):
            return rule
    return None


def would_dispatch(op: CompressionOp, shape: tuple, dtype=torch.float32,
                   cfg: Optional[DispatchConfig] = None,
                   device=None) -> bool:
    """Introspection probe: True iff compress_leaf would use a kernel."""
    return select_rule(op, shape, dtype, cfg, device) is not None


# ---------------------------------------------------------------------------
# raw row-kernel entries
# ---------------------------------------------------------------------------


def rows_eligible(row_len: int, cfg: Optional[DispatchConfig] = None,
                  leaf_size: Optional[int] = None, device=None) -> bool:
    """Can [rows, row_len] blocks go through the Top_k kernel?  Mirrors
    select_rule's auto-mode policy (pass ``leaf_size`` so leaves below
    min_size stay on the reference path)."""
    cfg = _resolve(cfg)
    if not (cfg.kernels_enabled(device) and row_len % LANES == 0
            and row_len <= cfg.max_row):
        return False
    if (cfg.mode == "auto" and leaf_size is not None
            and leaf_size < cfg.min_size):
        return False
    return True


def topk_rows(rows: torch.Tensor, k: int, *, sign: bool = False,
              cfg: Optional[DispatchConfig] = None):
    """Kernel Top_k/SignTop_k over pre-shaped [rows, n] blocks: (selected,
    new_memory, count_per_row).  Callers check :func:`rows_eligible`."""
    return _topk.topk_compress(rows.contiguous(), k, sign=sign)


# ---------------------------------------------------------------------------
# compact buffers and the serving kernels
# ---------------------------------------------------------------------------


def decode_rows(idx: torch.Tensor, val: torch.Tensor,
                row_len: int) -> torch.Tensor:
    """THE compact-buffer decoder: per-row scatter-add of [rows, kcap]
    (idx, val) into dense [rows, row_len] float32.  Out-of-row sentinel
    indices (``idx = row_len``, empty slots) land in a spare column that
    is cut off, as ``repro``'s scatter drops them."""
    out = torch.zeros((idx.shape[0], row_len + 1), dtype=torch.float32,
                      device=idx.device)
    out.scatter_add_(1, idx.to(torch.int64).clamp(0, row_len),
                     val.to(torch.float32))
    return out[:, :row_len]


def paged_geometry(cfg: Optional[DispatchConfig], pages: int) -> int:
    """Pages per tile for a ``paged_decode`` launch: an explicit
    ``cfg.block_rows``, else the kernel's default; clamped to the table
    width."""
    cfg = _resolve(cfg)
    pb = (cfg.block_rows if cfg.block_rows is not None
          else _pa.DEFAULT_PAGES_PER_BLOCK)
    return max(1, min(int(pb), pages))


def sparse_gemm(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                row_len: int, cfg: Optional[DispatchConfig] = None
                ) -> torch.Tensor:
    """Serving entry for the sparse-weight x dense-activation GEMM.

    x: [M, row_len] activations; idx/val: [R, kcap] compact survivor
    buffers (rows enumerate output features).  The kernel when
    ``cfg.kernels_enabled``, the densify-then-matmul version otherwise;
    [M, R] float32 either way."""
    if _resolve(cfg).kernels_enabled(x.device):
        return _sgemm.sparse_gemm(x.contiguous(), idx, val, row_len)
    return ref.sparse_gemm_ref(x, idx, val, row_len)


def qdq_gemm(x: torch.Tensor, levels: torch.Tensor, scale: torch.Tensor,
             cfg: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Serving entry for the QSGD-dequantize-fused GEMM: x [M, n], int8
    levels [R, n], float32 scale [R, 1] -> [M, R] float32."""
    if _resolve(cfg).kernels_enabled(x.device):
        return _sgemm.qdq_gemm(x.contiguous(), levels, scale)
    return ref.qdq_gemm_ref(x, levels, scale)


def paged_decode(x: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                 kscale: torch.Tensor, vscale: torch.Tensor,
                 tables: torch.Tensor, lengths: torch.Tensor,
                 cfg: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Serving entry for paged decode attention: x [B, 1, H, hd] rope'd
    queries against the page pool through block tables [B, P] and
    lengths [B]; [B, 1, H, hd] either way."""
    cfg = _resolve(cfg)
    if cfg.kernels_enabled(x.device):
        pb = paged_geometry(cfg, tables.shape[-1])
        return _pa.paged_decode(x.contiguous(), kp, vp, kscale, vscale,
                                tables, lengths, pages_per_block=pb)
    return ref.paged_decode_ref(x, kp, vp, kscale, vscale, tables, lengths)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor,
                 cfg: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Serving entry for ring-cache decode attention: q [B, 1, H, hd]
    against k, v [B, C, KV, hd] under the [B, C] (or [C]) slot mask."""
    if _resolve(cfg).kernels_enabled(q.device):
        return _fa.flash_decode(q.contiguous(), k, v, valid)
    return ref.flash_decode_ref(q, k, v, valid)


# ---------------------------------------------------------------------------
# public compression entry points (engine-facing)
# ---------------------------------------------------------------------------


def _reference(op: CompressionOp, rng, xb: torch.Tensor):
    """The reference operator, worker by worker: ([B, ...], [B] bits)."""
    outs, bits = [], []
    for b in range(xb.shape[0]):
        o, bb = op(rng, xb[b])
        outs.append(o)
        bits.append(bb.to(torch.float32))
    return torch.stack(outs), torch.stack(bits)


def _compress_leaf_b(op, rng, xb, cfg):
    rule = select_rule(op, tuple(xb.shape[1:]), xb.dtype, cfg, xb.device)
    if rule is None:
        out, bits = _reference(op, rng, xb)
        return out, bits, False
    out, bits = rule.run(op, rng, xb, cfg)
    return out, bits, True


def compress_leaf(op: CompressionOp, rng, x: torch.Tensor,
                  cfg: Optional[DispatchConfig] = None):
    """Compress one leaf: (dense_out, wire_bits, used_kernel)."""
    out, bits, used = _compress_leaf_b(op, rng, x[None], _resolve(cfg))
    return out[0], bits[0], used


def _compress_leaves_packed(ops, rng, leaves, cfg, want_mem: bool = False):
    """Megabuffer-packed compression of [B, ...] leaves (DESIGN.md §3.4).

    Kernel-eligible leaves are bucketed by launch signature — (row
    length, k, sign) for the Top_k family, (row length, s) for QSGD —
    and each bucket's rows (every worker's) are concatenated into one
    megabuffer for a single launch.  The kernels are row-independent,
    so outputs, memories and bits equal the leaf-by-leaf path's.  With
    ``want_mem`` the third return holds the Top_k kernel's fused memory
    per leaf (None where the caller derives ``acc - out``).  Randomness
    is drawn in leaf order, as ``repro`` draws it, before any launch.
    """
    n = len(leaves)
    outs: list = [None] * n
    bit_terms: list = [None] * n
    mems: list = [None] * n
    topk_buckets: dict = {}
    qsgd_buckets: dict = {}
    for i, (op, xb) in enumerate(zip(ops, leaves)):
        rule = select_rule(op, tuple(xb.shape[1:]), xb.dtype, cfg, xb.device)
        if rule is None:
            outs[i], bit_terms[i] = _reference(op, rng, xb)
        elif rule.name == "qsgd_global":
            rows, urows = _plan_qsgd(rng, xb)
            qsgd_buckets.setdefault((rows.shape[1], op.s), []).append(
                (i, rows, urows, op, xb))
        else:
            rows, k, sign, bits_of = _plan_topk(rule.name, op, xb)
            topk_buckets.setdefault((rows.shape[1], k, sign), []).append(
                (i, rows, bits_of, xb))
    for (_, k, sign), entries in topk_buckets.items():
        mega = (entries[0][1] if len(entries) == 1
                else torch.cat([e[1] for e in entries], dim=0))
        sel, mem, cnt = _topk.topk_compress(mega, k, sign=sign)
        off = 0
        for i, rows, bits_of, xb in entries:
            r = rows.shape[0]
            B, shape = xb.shape[0], tuple(xb.shape[1:])
            outs[i] = _restore(sel[off:off + r], B, shape, xb.dtype)
            if want_mem:
                mems[i] = _restore(mem[off:off + r], B, shape, xb.dtype)
            bit_terms[i] = bits_of(_worker_counts(cnt[off:off + r], B))
            off += r
    for (_, s), entries in qsgd_buckets.items():
        mega = (entries[0][1] if len(entries) == 1
                else torch.cat([e[1] for e in entries], dim=0))
        megau = (entries[0][2] if len(entries) == 1
                 else torch.cat([e[2] for e in entries], dim=0))
        out = _qsgd.qsgd_quantize(mega, megau, s)
        off = 0
        for i, rows, _urows, op, xb in entries:
            B = xb.shape[0]
            o = _restore(out[off:off + B], B, tuple(xb.shape[1:]), xb.dtype)
            outs[i] = o
            bit_terms[i] = _qsgd_bits(op, o)
            off += B
    return outs, bit_terms, mems


def _compress_batched(op_tree, rng, leaves, cfg, want_mem: bool):
    ops = ops_for_leaves(op_tree, len(leaves))
    device = leaves[0].device if leaves else None
    if cfg.pack and cfg.kernels_enabled(device):
        return _compress_leaves_packed(ops, rng, leaves, cfg, want_mem)
    outs, bit_terms = [], []
    for op, xb in zip(ops, leaves):
        o, b, _ = _compress_leaf_b(op, rng, xb, cfg)
        outs.append(o)
        bit_terms.append(b)
    return outs, bit_terms, [None] * len(leaves)


def _total(bit_terms: list, B: int, device) -> torch.Tensor:
    """[B] float32 ledger totals over the leaves, per worker."""
    if not bit_terms:
        return torch.zeros((B,), dtype=torch.float32, device=device)
    return bitlib.ledger_sum(bit_terms)


def compress_tree(op_tree, rng, grads, cfg: Optional[DispatchConfig] = None):
    """Kernel-aware counterpart of ``operators.compress_tree``: same
    operator broadcast and bits summing, with each leaf routed through
    the kernels (megabuffer-packed when ``cfg.pack``) or the reference
    operator.  Returns (compressed_tree, total_bits)."""
    cfg = _resolve(cfg)
    leaves, spec = tree_flatten(grads)
    outs, bit_terms, _ = _compress_batched(
        op_tree, rng, [x[None] for x in leaves], cfg, want_mem=False)
    device = leaves[0].device if leaves else None
    return (tree_unflatten(spec, [o[0] for o in outs]),
            _total(bit_terms, 1, device)[0])


def channel_compress_tree(op_tree, rng, acc,
                          cfg: Optional[DispatchConfig] = None, *,
                          want_leaf_bits: bool = False,
                          batched: bool = False):
    """Channel-aware tree compression (DESIGN.md §5): compress the
    error-compensated accumulator ``acc`` and hand back the updated
    error memory alongside.

    Returns ``(q_tree, mem_tree, total_bits)`` with ``mem == acc − q``
    per leaf: the Top_k kernel's fused memory where it ran, the same
    float32 subtraction taken here elsewhere.
    ``want_leaf_bits`` appends the per-leaf bits (flatten order).

    ``batched``: every leaf of ``acc`` carries a leading worker axis
    [B, ...]; each worker is compressed on its own (its own rows, its
    own bits) but all workers share each bucket's launch, and the
    totals (and per-leaf bits) are [B] vectors.
    """
    cfg = _resolve(cfg)
    leaves, spec = tree_flatten(acc)
    xs = leaves if batched else [x[None] for x in leaves]
    B = xs[0].shape[0] if xs else 1
    outs, bit_terms, mems = _compress_batched(op_tree, rng, xs, cfg,
                                              want_mem=True)
    mems = [m if m is not None else a - o
            for m, a, o in zip(mems, xs, outs)]
    device = leaves[0].device if leaves else None
    total = _total(bit_terms, B, device)
    if not batched:
        outs = [o[0] for o in outs]
        mems = [m[0] for m in mems]
        bit_terms = [b[0] for b in bit_terms]
        total = total[0]
    out = (tree_unflatten(spec, outs), tree_unflatten(spec, mems), total)
    if want_leaf_bits:
        return out + (list(bit_terms),)
    return out
