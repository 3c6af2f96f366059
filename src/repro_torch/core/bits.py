"""Exact wire-bit accounting for every operator (the paper's x-axis).

A port of ``repro.core.bits``; see its docstring for the conventions.
The data-dependent helpers (counted survivors, non-zeros) build their
result in float32 with ``repro``'s expression order, so both packages'
ledgers come out bit-equal: ``f32(32) + f32(nnz) * per``.  They return a
float32 tensor on ``nnz``'s device (a Python count gives a CPU scalar).
"""

from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_leaves


def _idx_bits(d: int) -> int:
    return max(1, math.ceil(math.log2(max(d, 2))))


def _level_bits(s: int) -> int:
    return max(1, math.ceil(math.log2(s + 1)))


def f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of ``x`` (a tensor keeps its device).  A Python
    value is written by a fill kernel, not copied from the host, so a
    CUDA graph can hold it."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _dev(nnz):
    return nnz.device if isinstance(nnz, torch.Tensor) else None


def ledger_sum(terms) -> torch.Tensor:
    """The float32 sum of ledger terms (tensors of one shape), folded
    left to right.  Above 2^24 bits float32 rounds, so the order is part
    of the ledger: a sequential fold is what ``repro``'s
    ``jnp.sum(jnp.stack(terms))`` computes on the CPU for up to 17 terms,
    and it rounds the same on every device."""
    terms = list(terms)
    total = terms[0].to(torch.float32)
    for t in terms[1:]:
        total = total + t.to(torch.float32)
    return total


def bits_dense(d: int, value_bits: int = 32) -> float:
    return float(d * value_bits)


def bits_dense_tree(tree, value_bits: int = 32) -> float:
    """Dense wire cost of transmitting a whole tree exactly — the
    per-receiver charge of an uncompressed (Identity) broadcast."""
    return float(sum(bits_dense(leaf.numel(), value_bits)
                     for leaf in tree_leaves(tree)))


def bits_topk(d: int, k: int, value_bits: int = 32) -> float:
    return float(32 + k * (_idx_bits(d) + value_bits))


def bits_randk(d: int, k: int, value_bits: int = 32) -> float:
    # indices recoverable from a shared 32-bit seed
    return float(32 + 32 + k * value_bits)


def bits_sign(d: int) -> float:
    # 32-bit scale + one bit per coordinate
    return float(32 + d)


def bits_signtopk(d: int, k: int) -> float:
    return float(32 + k * (_idx_bits(d) + 1))


def bits_klevel(d: int, s: int) -> float:
    # lo & hi 32-bit floats + level bits per coordinate
    return float(64 + d * _level_bits(s))


def bits_qsgd(d: int, s: int, nnz) -> torch.Tensor:
    """norm + per-nonzero (index + sign + level)."""
    per = _idx_bits(d) + 1 + _level_bits(s)
    dev = _dev(nnz)
    return f32(32 + 32, dev) + f32(nnz, dev) * f32(per, dev)


def bits_topk_counted(d: int, nnz, value_bits: int = 32) -> torch.Tensor:
    """Top_k wire cost from the *actual* survivor count: equal to
    :func:`bits_topk` when nnz == k; the threshold-select kernels report
    their true count, which can exceed k under ties."""
    per = _idx_bits(d) + value_bits
    dev = _dev(nnz)
    return f32(32, dev) + f32(nnz, dev) * f32(per, dev)


def bits_signtopk_counted(d: int, nnz) -> torch.Tensor:
    """SignTop_k wire cost from the actual survivor count."""
    per = _idx_bits(d) + 1
    dev = _dev(nnz)
    return f32(32, dev) + f32(nnz, dev) * f32(per, dev)


def bits_qtopk(d: int, k: int, s: int, nnz) -> torch.Tensor:
    """TopK then QSGD on the k survivors: indices for k, levels only for
    the quantizer's non-zeros (QSGD may zero some survivors)."""
    per_idx = _idx_bits(d)
    per_val = 1 + _level_bits(s)
    dev = _dev(nnz)
    return f32(32 + 32 + k * per_idx, dev) + f32(nnz, dev) * f32(per_val, dev)


def bits_qrandk(d: int, k: int, s: int, nnz) -> torch.Tensor:
    per_val = 1 + _level_bits(s)
    dev = _dev(nnz)
    return f32(32 + 32 + 32, dev) + f32(nnz, dev) * f32(per_val, dev)
