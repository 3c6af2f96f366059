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

The Top_k family also has a compact wire form (``compact_rows``,
``compact_compress``): ``topk_compact`` writes ``(idx, val)`` survivor
slots and the fused memory, for the distributed ``sparse_allgather``
sync (DESIGN.md §3.3).

The serving entries (``sparse_gemm``, ``qdq_gemm``, ``paged_decode``,
``flash_decode``, ``flash_attention``) route the same way on their
activations' device: the hand-written kernel, or the kernel's plain
version (``ref.py``) under ``mode="reference"``.

Launch geometry: every launch of a kernel that has one resolves it in
one place, :func:`_geometry` (an explicit ``DispatchConfig.block_rows``,
then the tuning table of ``kernels/autotune.py``, then the kernel's own
pick).  :func:`launch_plans` lists the signatures a run's compression
launches: the tuner's work list.

Eligibility is ``repro``'s, unchanged, because it decides which leaves
take which path: at least ``min_size`` elements (``mode="auto"`` only),
rows of a multiple of 128 elements, rows no longer than ``max_row``.
``mode="auto"`` dispatches when the tensors are on a CUDA device (where
``repro`` asks for a TPU) or on the ``meta`` device (a dry run's
stand-in for the card); ``mode="kernel"`` always dispatches, and on
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

import numpy as np
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
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_gemm as _sgemm
from repro_torch.kernels import topk_compress as _topk
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

LANES = 128  # kernel rows are padded to a multiple of this (repro's rule)


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Where and when compression runs through the kernels.

    mode: "auto"      — kernels for tensors on a CUDA device (default),
                        and on the ``meta`` device: a dry run's tensors
                        stand for the card's (``launch/dryrun.py``), so
                        they take the card's route, to the wrappers'
                        meta branches (empty outputs of the kernels'
                        shapes, counted as launches and costed by the
                        dry run); a meta tensor never reaches a plain
                        version, and a leaf the rules send to the
                        reference operators runs them on meta as it
                        would on the card
          "kernel"    — always the kernel path (the plain versions on
                        the CPU, the meta branches on meta); bypasses
                        min_size but not the structural limits
          "reference" — never dispatch (pure core/operators.py, which
                        runs on meta as it runs on the card)
    min_size: smallest leaf (elements) worth a kernel launch in "auto"
    max_row:  longest kernel row (elements)
    max_cap:  largest compact survivor capacity (slots per row) routed to
          ``topk_compact`` (``repro``'s bound, kept so the same leaves
          take the same path)
    block_rows: the launch geometry, for the launches that have one (the
          meanings in ``kernels/autotune.py``): the long-row
          ``topk_compress``'s and ``qsgd``'s cluster size,
          ``topk_compact``'s rows a block on its warp route,
          ``paged_decode``'s pages a block (clamped to the table width).
          A value the launch's kernel cannot take raises, and so does any
          value at a launch with no geometry to set (short Top_k rows, the
          compact block and scan routes, the GEMMs and the attention
          kernels): it is never ignored.  None (the default) resolves
          each launch through the tuning table, then the kernel's own
          pick.
    pack: megabuffer-pack same-bucket leaves (one kernel launch per
          bucket per sync round)
    """

    mode: str = "auto"
    min_size: int = 1 << 16
    max_row: int = 1 << 19
    max_cap: int = 1 << 11
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
        return _device(device).type in ("cuda", "meta")


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
# launch geometry
# ---------------------------------------------------------------------------


def _geometry(cfg: DispatchConfig, kernel: str, rows: int, n: int, k: int,
              sign: bool, device=None) -> Optional[int]:
    """The geometry of one launch of ``kernel`` on [rows, n] (k, sign: the
    rest of its signature, ``autotune.ShapeKey``'s) on ``device``: an
    explicit ``cfg.block_rows`` (the kernel's wrapper raises where it
    cannot take it), else the entry of the device kind's tuning table
    (``TUNE_CACHE`` counts one lookup per call: an eager run looks up at
    every call, a graphed round at its capture), else None, the kernel's
    own pick.  A table entry the launch cannot take (another build's) is
    passed over.  A ``meta`` launch (a dry run) reads no table: the
    explicit value or the kernel's own pick."""
    if cfg.block_rows is not None:
        return cfg.block_rows
    if device is not None and torch.device(device).type == "meta":
        return None
    ent = autotune.lookup(kernel, rows, n, k, sign, device=device)
    if ent is not None and autotune.takes(kernel, rows, n, k, sign,
                                          ent.block_rows):
        return ent.block_rows
    return None


def _no_geometry(cfg: DispatchConfig, kernel: str) -> None:
    """Launches with no geometry to set refuse an explicit one."""
    if cfg.block_rows is not None:
        raise ValueError(f"{kernel} has no launch geometry to set; "
                         f"DispatchConfig.block_rows={cfg.block_rows} "
                         f"cannot apply to it (leave it None)")


def _topk_launch(cfg: DispatchConfig, rows: torch.Tensor, k: int,
                 sign: bool):
    """``topk_compress`` on [rows, n] at the resolved geometry."""
    cluster = _geometry(cfg, "topk_compress", rows.shape[0], rows.shape[1],
                        k, sign, rows.device)
    return _topk.topk_compress(rows, k, sign=sign, cluster=cluster)


def _qsgd_launch(cfg: DispatchConfig, rows: torch.Tensor, urows, s: int):
    """``qsgd_quantize`` on [rows, n] at the resolved geometry."""
    cluster = _geometry(cfg, "qsgd", rows.shape[0], rows.shape[1], s, False,
                        rows.device)
    return _qsgd.qsgd_quantize(rows, urows, s, cluster=cluster)


def _compact_launch(cfg: DispatchConfig, rows: torch.Tensor, k: int,
                    kcap: int, sign: bool):
    """``topk_compact`` on [rows, n] at the resolved geometry (the
    signature's k is the survivor count, as in ``repro``)."""
    group = _geometry(cfg, "topk_compact", rows.shape[0], rows.shape[1], k,
                      sign, rows.device)
    return _topk.topk_compact(rows, k, kcap, sign=sign, group=group)


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
    sel, _mem, cnt = _topk_launch(cfg, rows, k, sign)
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
    out = _restore(_qsgd_launch(cfg, rows, urows, op.s), xb.shape[0],
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
    return _topk_launch(_resolve(cfg), rows.contiguous(), k, sign)


def compact_rows_eligible(row_len: int, kcap: int,
                          cfg: Optional[DispatchConfig] = None,
                          leaf_size: Optional[int] = None,
                          device=None) -> bool:
    """Can [rows, row_len] blocks go through the *compact* kernel?  The
    dense row policy plus the survivor-capacity bound."""
    cfg = _resolve(cfg)
    return (rows_eligible(row_len, cfg, leaf_size, device)
            and kcap <= cfg.max_cap)


def compact_rows(rows: torch.Tensor, k: int, kcap: int, *,
                 sign: bool = False, cfg: Optional[DispatchConfig] = None,
                 leaf_size: Optional[int] = None):
    """Compact Top_k / SignTop_k over pre-shaped [rows, n] blocks: the
    kernel when :func:`compact_rows_eligible` on the rows' device, else
    its plain version; the same outputs either way.

    Returns (idx [rows, kcap] int32, val [rows, kcap] float32,
    new_mem [rows, n] float32, cnt [rows] int32); empty slots carry the
    out-of-row sentinel (idx = n, val = 0), DESIGN.md §3.3.  The launch
    geometry resolves through :func:`_geometry`.
    """
    n = rows.shape[1]
    if compact_rows_eligible(n, kcap, cfg, leaf_size, rows.device):
        return _compact_launch(_resolve(cfg),
                               rows.to(torch.float32).contiguous(), k, kcap,
                               sign)
    return ref.topk_compact_ref(rows, k, kcap, sign=sign)


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


TOPK_FAMILY = ("topk_global", "row_topk", "signtopk_global", "row_signtopk")


@dataclasses.dataclass(frozen=True)
class CompactLeaf:
    """One leaf in compact wire form (DESIGN.md §3.3).

    idx / val are [rows, kcap] survivor buffers (rows = 1 for the global
    operators); slot j of row r holds the j-th surviving coordinate of
    that row in ascending index order, indices row-local.  Slots past
    the row's count hold (idx = row_len, val = 0), the sentinel a
    scatter-add decoder drops.  ``mem`` is the fused error memory (leaf
    shape, float32) and ``bits`` the counted wire cost.
    """

    idx: torch.Tensor
    val: torch.Tensor
    mem: torch.Tensor
    bits: torch.Tensor
    row_len: int
    kcap: int


def densify_compact(leaf: CompactLeaf, shape, dtype=torch.float32):
    """Dense decode of a CompactLeaf: scatter-add the rows, cut the
    padding, reshape to the leaf's shape."""
    out = decode_rows(leaf.idx, leaf.val, leaf.row_len)
    return out.reshape(-1)[:_size(tuple(shape))].reshape(
        tuple(shape)).to(dtype)


def _topk_rule(op: CompressionOp) -> Optional[KernelRule]:
    return next((r for r in RULES
                 if r.name in TOPK_FAMILY and r.matches(op)), None)


def would_compact(op: CompressionOp, shape: tuple, dtype=torch.float32,
                  cfg: Optional[DispatchConfig] = None,
                  device=None) -> bool:
    """True iff :func:`compact_compress` would launch the compact kernel
    (its plain version gives the same wire form either way)."""
    rule = _topk_rule(op)
    if rule is None or not dtype.is_floating_point:
        return False
    d = _size(shape)
    if rule.name in ("topk_global", "signtopk_global"):
        n = _padded_len(d, LANES)
        k = resolve_k(op.k, d)
    else:
        n = _row_len_of(op, shape)
        k = resolve_k(op.k, n)
    return compact_rows_eligible(n, capacity(k, n), cfg, leaf_size=d,
                                 device=device)


def compact_compress(op: CompressionOp, rng, x: torch.Tensor,
                     cfg: Optional[DispatchConfig] = None
                     ) -> tuple[CompactLeaf, bool]:
    """Compact counterpart of :func:`compress_leaf` for the Top_k family
    (TopK / SignTopK(m=2) / RowTopK / RowSignTopK): (CompactLeaf,
    used_kernel).  Where the kernel is not eligible its plain version
    writes the same wire form.  Other operators have no compact form and
    raise TypeError."""
    rule = _topk_rule(op)
    if rule is None:
        raise TypeError(
            f"{type(op).__name__} has no compact wire form; "
            "compact_compress serves the Top_k family only")
    rows, k, sign, bits_of = _plan_topk(rule.name, op, x[None])
    n = rows.shape[1]
    kcap = capacity(k, n)
    used = would_compact(op, tuple(x.shape), x.dtype, cfg, x.device)
    if used:
        idx, val, mem, cnt = _compact_launch(_resolve(cfg), rows, k, kcap,
                                             sign)
    else:
        idx, val, mem, cnt = ref.topk_compact_ref(rows, k, kcap, sign=sign)
    mem_leaf = mem.reshape(-1)[:x.numel()].reshape(x.shape)
    bits = bits_of(_worker_counts(cnt, 1))[0]
    return CompactLeaf(idx, val, mem_leaf, bits, n, kcap), used


def paged_geometry(cfg: Optional[DispatchConfig], pages: int,
                   page_size: int = 0, head_dim: int = 0,
                   quant: bool = False, device=None) -> int:
    """Pages a block for a ``paged_decode`` launch over a [B, ``pages``]
    block table, through :func:`_geometry` (signature: table width, page
    size, head width, int8 pages): an explicit ``cfg.block_rows``, else
    ``device``'s tuning table, else the kernel's default; clamped to the
    table width."""
    cfg = _resolve(cfg)
    pb = _geometry(cfg, "paged_decode", pages, page_size, head_dim, quant,
                   device)
    if pb is None:
        pb = _pa.DEFAULT_PAGES_PER_BLOCK
    if int(pb) < 1:
        raise ValueError(f"paged_decode takes at least one page a block, "
                         f"got block_rows={pb}")
    return max(1, min(int(pb), pages))


def sparse_gemm(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                row_len: int, cfg: Optional[DispatchConfig] = None
                ) -> torch.Tensor:
    """Serving entry for the sparse-weight x dense-activation GEMM.

    x: [M, row_len] activations; idx/val: [R, kcap] compact survivor
    buffers (rows enumerate output features).  The kernel when
    ``cfg.kernels_enabled``, the densify-then-matmul version otherwise;
    [M, R] float32 either way."""
    cfg = _resolve(cfg)
    if cfg.kernels_enabled(x.device):
        _no_geometry(cfg, "sparse_gemm")
        return _sgemm.sparse_gemm(x.contiguous(), idx, val, row_len)
    return ref.sparse_gemm_ref(x, idx, val, row_len)


def qdq_gemm(x: torch.Tensor, levels: torch.Tensor, scale: torch.Tensor,
             cfg: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Serving entry for the QSGD-dequantize-fused GEMM: x [M, n], int8
    levels [R, n], float32 scale [R, 1] -> [M, R] float32."""
    cfg = _resolve(cfg)
    if cfg.kernels_enabled(x.device):
        _no_geometry(cfg, "qdq_gemm")
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
        pb = paged_geometry(cfg, tables.shape[-1], kp.shape[1], kp.shape[-1],
                            kp.dtype == torch.int8, x.device)
        return _pa.paged_decode(x.contiguous(), kp, vp, kscale, vscale,
                                tables, lengths, pages_per_block=pb)
    return ref.paged_decode_ref(x, kp, vp, kscale, vscale, tables, lengths)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor,
                 cfg: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Serving entry for ring-cache decode attention: q [B, 1, H, hd]
    against k, v [B, C, KV, hd] under the [B, C] (or [C]) slot mask."""
    cfg = _resolve(cfg)
    if cfg.kernels_enabled(q.device):
        _no_geometry(cfg, "flash_decode")
        return _fa.flash_decode(q.contiguous(), k, v, valid)
    return ref.flash_decode_ref(q, k, v, valid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = -1,
                    cfg: Optional[DispatchConfig] = None) -> torch.Tensor:
    """Prefill entry for causal (sliding-window when ``window`` > 0) GQA
    attention: q [B, S, H, hd] against k, v [B, S, KV, hd]."""
    cfg = _resolve(cfg)
    if cfg.kernels_enabled(q.device):
        _no_geometry(cfg, "flash_attention")
        return _fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                       v.contiguous(), window=window)
    return ref.flash_attention_ref(q, k, v, window=window)


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
        sel, mem, cnt = _topk_launch(cfg, mega, k, sign)
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
        out = _qsgd_launch(cfg, mega, megau, s)
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

# ---------------------------------------------------------------------------
# launch plans (the tuner's work list)
# ---------------------------------------------------------------------------


def _plan_topk_shape(rule_name: str, op, shape) -> tuple:
    """Shape-only twin of :func:`_plan_topk` for one worker: (rows,
    row_len, k, sign) of the kernel buffer, without building it."""
    d = _size(shape)
    if rule_name in ("topk_global", "signtopk_global"):
        return (1, _padded_len(d, LANES), resolve_k(op.k, d),
                rule_name == "signtopk_global")
    row = _row_len_of(op, shape)
    return (_padded_len(d, row) // row, row, resolve_k(op.k, row),
            rule_name == "row_signtopk")


def _dtype_of(x) -> torch.dtype:
    """A leaf's dtype as torch's (leaves may be tensors or numpy arrays)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, dtype=x.dtype)).dtype


def launch_plans(op_tree, tree, cfg: Optional[DispatchConfig] = None, *,
                 compact: bool = False, workers: int = 1,
                 device=None) -> list:
    """The kernel launches :func:`compress_tree` /
    :func:`channel_compress_tree` make for this (op_tree, params-like
    tree of one worker's leaves, tensors or numpy arrays), as
    ``autotune.ShapeKey`` rows: under ``cfg.pack`` one a bucket, every
    worker's rows in it (``workers``, the leading axis the engine
    batches), else one a leaf.  ``compact=True`` names the Top_k family's
    launches ``topk_compact`` (the sparse wire's kernel), as ``repro``'s
    ``launch_plans`` does, to which this is equal at ``workers=1``.
    ``device``: where the run's tensors are (default: where the port
    runs by default)."""
    cfg = _resolve(cfg)
    plans: list = []
    if not cfg.kernels_enabled(device):
        return plans
    leaves = tree_leaves(tree)
    ops = ops_for_leaves(op_tree, len(leaves))
    topk_name = "topk_compact" if compact else "topk_compress"
    topk_buckets: dict = {}
    qsgd_buckets: dict = {}
    for op, x in zip(ops, leaves):
        shape = tuple(x.shape)
        rule = select_rule(op, shape, _dtype_of(x), cfg, device)
        if rule is None:
            continue
        if rule.name == "qsgd_global":
            n = _padded_len(_size(shape), LANES)
            qsgd_buckets[(n, op.s)] = qsgd_buckets.get((n, op.s), 0) + workers
            continue
        rows, n, k, sign = _plan_topk_shape(rule.name, op, shape)
        rows *= workers
        topk_buckets[(n, k, sign)] = topk_buckets.get((n, k, sign), 0) + rows
        if not cfg.pack:
            key = autotune.ShapeKey(topk_name, rows, n, k, sign)
            if key not in plans:
                plans.append(key)
    if cfg.pack:
        for (n, k, sign), rows in topk_buckets.items():
            plans.append(autotune.ShapeKey(topk_name, rows, n, k, sign))
        for (n, s), rows in qsgd_buckets.items():
            plans.append(autotune.ShapeKey("qsgd", rows, n, s, False))
    else:
        for n, s in qsgd_buckets:
            key = autotune.ShapeKey("qsgd", workers, n, s, False)
            if key not in plans:
                plans.append(key)
    return plans
