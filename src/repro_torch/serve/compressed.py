"""Compressed serving weights (a port of ``repro.serve.compressed``;
DESIGN.md §11.1-§11.2).

A compression policy (``core.policy``) decides each weight's serving
form: every matrix whose rule lands in the Top_k family becomes compact
``(idx, val)`` sparse rows, every QSGD-ruled matrix becomes per-row int8
levels plus an f32 scale column, and everything else (norm gains, 1-D
leaves) stays dense.  The compressed form is the *resident* form: the
forward contracts activations against it through the ``sparse_gemm`` /
``qdq_gemm`` kernels (``kernels/dispatch.py``), and the dense weight is
never formed.  :data:`STATS` counts ``densify`` calls so tests and the
launcher can assert exactly that.

Storage orientation: compact rows enumerate the GEMM *output* dimension.
A regular ``[n_in, n_out]`` weight is stored as rows of ``W.T``
(``out_axis=1``, ``row_len = n_in``) so ``matmul(x) = x @ W``; the
``[V, d]`` embedding is stored row-major (``out_axis=0``) so the same
buffers serve the token gather (``take_rows``) and a tied head.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import policy as pol
from repro_torch.core.operators import (
    CompressionOp,
    QSGDQuantizer,
    RowSignTopK,
    RowTopK,
    SignSparsifier,
    TopK,
    ops_for_leaves,
    resolve_k,
    top_k_indices,
)
from repro_torch.kernels import dispatch as dsp
from repro_torch.tree import tree_leaves, tree_unflatten

#: serving-path counters.  ``densify`` is the one the zero-densify
#: guarantee is asserted on: the forward never calls it.
STATS = {"densify": 0, "sparse_matmul": 0, "quant_matmul": 0,
         "take_rows": 0}

#: QSGD serving levels are stored as int8 sign * xi
_MAX_LEVELS = 127
#: elements of one block of rows sorted at once by the Top_k selection
_SORT_ELEMS = 1 << 24


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class CompressedTensor:
    """One compressed weight leaf in serving orientation.

    kind='sparse': ``a`` = int32 indices ``[R, kcap]`` (row-local,
    ascending, out-of-row sentinel ``idx = row_len``), ``b`` = float32
    values ``[R, kcap]``.  kind='quant': ``a`` = int8 levels
    ``[R, row_len]``, ``b`` = float32 scale ``[R, 1]``.  A leading stack
    axis (``a.ndim == 3``) carries the [L] layers; :meth:`layer` slices
    one out, so ``matmul`` only ever sees 2-D buffers.  ``dtype`` is the
    dense leaf's dtype name, the dtype every product is cast to.
    """

    def __init__(self, kind: str, a: torch.Tensor, b: torch.Tensor,
                 row_len: int, shape: tuple, out_axis: int, dtype: str,
                 op: str):
        self.kind = kind
        self.a = a
        self.b = b
        self.row_len = int(row_len)
        self.shape = tuple(shape)
        self.out_axis = int(out_axis)
        self.dtype = str(dtype)
        self.op = op

    def __repr__(self):
        return (f"CompressedTensor({self.kind}, shape={self.shape}, "
                f"row_len={self.row_len}, out_axis={self.out_axis}, "
                f"op={self.op!r})")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def compressed_bytes(self) -> int:
        return int(self.a.numel() * self.a.element_size()
                   + self.b.numel() * self.b.element_size())

    @property
    def dense_bytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return int(n * torch.empty((), dtype=self.torch_dtype).element_size())

    def layer(self, i: int) -> "CompressedTensor":
        """Layer ``i`` of a stacked leaf (views of the children)."""
        if self.a.dim() != 3:
            raise ValueError(f"{self!r} is not stacked")
        return CompressedTensor(self.kind, self.a[i], self.b[i],
                                self.row_len, self.shape[1:], self.out_axis,
                                self.dtype, self.op)

    # -- serving consumers -------------------------------------------------
    def matmul(self, x: torch.Tensor, dispatch=None) -> torch.Tensor:
        """``x @ W`` (regular weights) / ``x @ W.T`` (tied embedding head)
        without densifying: ``x[..., row_len] -> [..., R]``, computed in
        float32 and cast to the weight's dtype."""
        if self.a.dim() != 2:
            raise ValueError(
                "stacked CompressedTensor must be sliced (.layer(i)) before "
                f"matmul; got children of ndim {self.a.dim()}")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self.kind == "sparse":
            STATS["sparse_matmul"] += 1
            y = dsp.sparse_gemm(x2, self.a, self.b, self.row_len, dispatch)
        else:
            STATS["quant_matmul"] += 1
            y = dsp.qdq_gemm(x2, self.a, self.b, dispatch)
        return y.reshape(*lead, y.shape[-1]).to(self.torch_dtype)

    def take_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding gather: decode only the gathered rows (``tokens[...]
        -> [..., row_len]``); the full table is never built."""
        if self.out_axis != 0:
            raise ValueError("take_rows needs out_axis=0 storage "
                             f"(got out_axis={self.out_axis})")
        STATS["take_rows"] += 1
        flat = tokens.reshape(-1).to(torch.int64)
        a, b = self.a[flat], self.b[flat]
        if self.kind == "sparse":
            w = dsp.decode_rows(a, b, self.row_len)
        else:
            w = a.to(torch.float32) * b
        return w.reshape(*tokens.shape, self.row_len).to(self.torch_dtype)

    def densify(self) -> torch.Tensor:
        """Reconstruct the dense weight in its original shape / dtype.
        Counts ``STATS['densify']``: the serving forward never lands
        here."""
        STATS["densify"] += 1

        def dec(a, b):
            if self.kind == "sparse":
                w = dsp.decode_rows(a, b, self.row_len)
            else:
                w = a.to(torch.float32) * b
            return w.T if self.out_axis == 1 else w

        if self.a.dim() == 3:
            w = torch.stack([dec(a, b) for a, b in zip(self.a, self.b)])
        else:
            w = dec(self.a, self.b)
        return w.reshape(self.shape).to(self.torch_dtype)


# ---------------------------------------------------------------------------
# policy-guided tree compression
# ---------------------------------------------------------------------------


def _is_matrix(leaf: torch.Tensor, path: str) -> bool:
    """Is this leaf a GEMM weight in serving terms?  3-D leaves are
    stacked ``[L, a, b]`` matrices; 2-D leaves are matrices unless they
    sit in the stacked layer dict (path under ``layers/`` with no numeric
    component), where ``[L, d]`` is a stacked norm gain."""
    if leaf.dim() == 3:
        return True
    if leaf.dim() != 2:
        return False
    parts = path.split("/")
    if parts[0] == "layers" and not any(p.isdigit() for p in parts):
        return False
    return True


def _plan(op: CompressionOp, leaf: torch.Tensor) -> Optional[tuple]:
    """(kind, frac_or_s, sign_m) serving scheme for one (op, leaf) pair,
    or None for dense passthrough.  ``frac`` is the survivor fraction in
    the op's own domain (one layer's matrix for TopK / SignTopK,
    op.row_len for the row variants), carried to the serving row."""
    per_layer = leaf.numel() if leaf.dim() == 2 else leaf[0].numel()
    if isinstance(op, TopK):
        return ("sparse", resolve_k(op.k, per_layer) / per_layer, 0)
    if isinstance(op, RowTopK):
        row = min(op.row_len, leaf.numel())
        return ("sparse", resolve_k(op.k, row) / row, 0)
    if isinstance(op, SignSparsifier):
        if op.sparsifier != "top":
            return None
        return ("sparse", resolve_k(op.k, per_layer) / per_layer, op.m)
    if isinstance(op, RowSignTopK):
        row = min(op.row_len, leaf.numel())
        return ("sparse", resolve_k(op.k, row) / row, op.m)
    if isinstance(op, QSGDQuantizer):
        return ("quant", min(int(op.s), _MAX_LEVELS), 0)
    return None


def _sparse_rows(m: torch.Tensor, k_row: int, kcap: int, sign_m: int):
    """Per-row magnitude top-k of ``m [R, n]`` (float32) into compact
    ``(idx, val)`` buffers of capacity ``kcap``: ascending indices, the
    sentinel ``(n, 0)`` after them.  ``sign_m`` > 0 codes the values as
    SignComp_k does: sign times ||sel||_m / k."""
    R, n = m.shape
    # top_k_indices sorts whole rows: a block of rows at a time bounds
    # the sort's index buffer at _SORT_ELEMS int64s
    step = max(1, _SORT_ELEMS // max(n, 1))
    idx = torch.cat([top_k_indices(m[i:i + step].abs(), k_row)
                     for i in range(0, R, step)]) if R else \
        torch.zeros((0, k_row), dtype=torch.int64, device=m.device)
    idx, _ = torch.sort(idx, dim=1)
    vals = torch.gather(m, 1, idx)
    if sign_m in (1, 2):
        norm = (vals.abs().sum(dim=1, keepdim=True) if sign_m == 1
                else torch.sqrt((vals * vals).sum(dim=1, keepdim=True)))
        one = torch.ones_like(vals)
        vals = torch.where(vals >= 0, one, -one) * (norm / k_row)
    idx_out = torch.full((R, kcap), n, dtype=torch.int32, device=m.device)
    val_out = torch.zeros((R, kcap), dtype=torch.float32, device=m.device)
    idx_out[:, :k_row] = idx.to(torch.int32)
    val_out[:, :k_row] = vals
    return idx_out, val_out


def _quant_rows(m: torch.Tensor, s: int):
    """Deterministic per-row QSGD snapshot of ``m [R, n]``: int8 levels
    ``sign * round(s |x| / ||row||)`` (half to even) plus the ``[R, 1]``
    float32 scale ``||row|| / s``."""
    mf = m.to(torch.float32)
    norm = torch.sqrt((mf * mf).sum(dim=1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    level = torch.clamp(torch.round(mf.abs() / safe * s), 0, s)
    lv = (torch.sign(mf) * level).to(torch.int8)
    return lv, (norm / s).to(torch.float32)


def _compress_leaf(leaf: torch.Tensor, op: CompressionOp, path: str):
    if not _is_matrix(leaf, path):
        return leaf
    plan = _plan(op, leaf)
    if plan is None:
        return leaf
    kind, param, sign_m = plan
    out_axis = 0 if path.split("/")[-1] == "embed" else 1
    n = leaf.shape[-1] if out_axis == 0 else leaf.shape[-2]
    try:
        op_str = pol.OpSpec.of(op).to_string()
    except (KeyError, TypeError):
        op_str = type(op).__name__
    if kind == "sparse":
        k_row = max(1, min(n, round(param * n)))
        kcap = dsp.capacity(k_row, n)

        def fn(m):
            return _sparse_rows(m, k_row, kcap, sign_m)
    else:
        def fn(m):
            return _quant_rows(m, param)

    def rows(w):                      # one layer, as float32 output rows
        return (w if out_axis == 0 else w.T).to(torch.float32).contiguous()

    if leaf.dim() == 3:               # layer by layer: one f32 copy at a time
        parts = [fn(rows(w)) for w in leaf]
        a = torch.stack([p[0] for p in parts])
        b = torch.stack([p[1] for p in parts])
    else:
        a, b = fn(rows(leaf))
    return CompressedTensor(kind, a, b, n, tuple(leaf.shape), out_axis,
                            str(leaf.dtype).removeprefix("torch."), op_str)


def compress_tree(params, policy) -> Any:
    """Policy-guided one-shot compression of a dense param tree into
    serving form.  ``policy`` is anything ``core.policy`` accepts (DSL
    string, PolicySpec, ChannelSpec — its uplink side — or an operator /
    operator tree).  Returns the tree with eligible leaves replaced by
    :class:`CompressedTensor`; the caller drops the dense tree."""
    try:
        op_tree = pol.as_channel_spec(policy).uplink.resolve(params)
    except TypeError:
        op_tree = pol.resolve(policy, params)
    paths, leaves, treedef = pol.tree_paths(params)
    ops = ops_for_leaves(op_tree, len(leaves))
    out = [_compress_leaf(leaf, op, path)
           for leaf, op, path in zip(leaves, ops, paths)]
    return tree_unflatten(treedef, out)


def tree_bytes(params) -> dict:
    """{'compressed': int, 'dense': int, 'leaves': int} resident-bytes
    summary of a (possibly compressed) param tree."""
    comp = dense = n = 0
    for leaf in tree_leaves(params):
        n += 1
        if isinstance(leaf, CompressedTensor):
            comp += leaf.compressed_bytes
            dense += leaf.dense_bytes
        else:
            size = int(leaf.numel() * leaf.element_size())
            comp += size
            dense += size
    return {"compressed": comp, "dense": dense, "leaves": n}
