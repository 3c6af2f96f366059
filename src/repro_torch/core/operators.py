"""Communication-efficient compression operators (paper Section 2).

A port of ``repro.core.operators``: every operator maps a tensor to a
*dense* tensor of the same shape holding the decompressed update, plus
the exact wire bits of that update (a float32 tensor on the input's
device).  Operators satisfy (or are tested against) Definition 3,
``E ||x - C(x)||^2 <= (1 - gamma) ||x||^2``.

Randomness: where ``repro`` takes a ``jax.random`` key, an operator here
takes ``rng``, either a ``torch.Generator`` or a :class:`Uniforms` feed
of given uniforms.  PyTorch cannot reproduce JAX's random stream, so
tests that hold the two packages together draw the uniforms with
``jax.random.uniform`` exactly where ``repro`` draws them and feed them
in, in draw order.  Deterministic operators ignore ``rng``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bits as bitlib
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


class Uniforms:
    """Given float32 uniforms in [0, 1), handed out in draw order.

    Each draw takes the next array, which must hold as many elements as
    the draw asks for (its shape is then the draw's)."""

    def __init__(self, arrays: Sequence):
        self._queue = [a.to(torch.float32) if isinstance(a, torch.Tensor)
                       else torch.tensor(np.asarray(a), dtype=torch.float32)
                       for a in arrays]

    def draw(self, shape, device) -> torch.Tensor:
        if not self._queue:
            raise ValueError("Uniforms feed exhausted")
        u = self._queue.pop(0)
        n = math.prod(shape)
        if u.numel() != n:
            raise ValueError(f"next uniforms hold {u.numel()} values, the "
                             f"draw needs {n} ({tuple(shape)})")
        return u.reshape(shape).to(device)

    def remaining(self) -> int:
        return len(self._queue)


Rng = Union[torch.Generator, Uniforms, None]


def uniform(rng: Rng, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` on ``device`` from ``rng``.
    On the ``meta`` device (a dry run, ``launch/dryrun.py``) there is
    nothing to draw: the tensor has the shape and no values, and ``rng``
    does not advance."""
    shape = tuple(int(s) for s in shape)
    if (isinstance(rng, (Uniforms, torch.Generator))
            and torch.device(device).type == "meta"):
        return torch.empty(shape, dtype=torch.float32, device=device)
    if isinstance(rng, Uniforms):
        return rng.draw(shape, device)
    if isinstance(rng, torch.Generator):
        u = torch.rand(shape, generator=rng, device=rng.device,
                       dtype=torch.float32)
        return u.to(device)
    raise ValueError("a stochastic operator needs rng: a torch.Generator "
                     "or a Uniforms feed")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def resolve_k(k: int | float, d: int) -> int:
    """k may be an absolute count or a fraction of d."""
    if isinstance(k, float) and 0.0 < k < 1.0:
        kk = max(1, int(round(k * d)))
    else:
        kk = int(k)
    return max(1, min(kk, d))


def _f32(v: float, ref: torch.Tensor) -> torch.Tensor:
    # a fill kernel, not a host copy: a CUDA graph can hold it
    return torch.full((), v, dtype=torch.float32, device=ref.device)


def top_k_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis in
    ``jax.lax.top_k``'s order: value descending, ties to the lower index
    first.  ``torch.topk`` breaks ties in no stated order, and Top_k of a
    gradient meets exact ties (equal features across classes), so the
    choice among tied coordinates is part of the result."""
    return torch.sort(a, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def _rand_subset(rng: Rng, d: int, k: int, device) -> torch.Tensor:
    """Uniform k-subset of [0, d): the indices of the k smallest of d
    uniforms (``repro``'s threshold selection)."""
    if k >= d:
        return torch.arange(d, device=device)
    u = uniform(rng, (d,), device)
    return top_k_indices(-u, k)


def _scatter(d: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(d, dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out


def _row_scatter(shape, idx, vals) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32, device=vals.device)
    return out.scatter(1, idx, vals)


# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------


class CompressionOp:
    """Base class.  Subclasses implement ``_compress_flat``."""

    #: True if the operator consumes randomness.
    stochastic: bool = False

    def __call__(self, rng: Rng, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(x_hat, bits)``: dense decompressed update + wire bits."""
        out, bits = self._compress_flat(rng, x.reshape(-1))
        return out.reshape(x.shape).to(x.dtype), bits

    def _compress_flat(self, rng, x):  # pragma: no cover - interface
        raise NotImplementedError

    def gamma(self, d: int) -> float:
        """Compression coefficient from the paper (for theory checks)."""
        raise NotImplementedError


def _register(cls):
    return dataclasses.dataclass(frozen=True)(cls)


# ---------------------------------------------------------------------------
# identity / sparsifiers
# ---------------------------------------------------------------------------


@_register
class Identity(CompressionOp):
    """No compression; full-precision dense update (vanilla / local SGD)."""

    value_bits: int = 32

    def _compress_flat(self, rng, x):
        return x, _f32(bitlib.bits_dense(x.numel(), self.value_bits), x)

    def gamma(self, d):
        return 1.0


@_register
class TopK(CompressionOp):
    """Keep the k largest-magnitude coordinates at full precision."""

    k: float = 0.01  # int count or fraction
    value_bits: int = 32

    def _compress_flat(self, rng, x):
        d = x.numel()
        k = resolve_k(self.k, d)
        xf = x.to(torch.float32)
        idx = top_k_indices(xf.abs(), k)
        out = _scatter(d, idx, xf[idx])
        return out, _f32(bitlib.bits_topk(d, k, self.value_bits), x)

    def gamma(self, d):
        return resolve_k(self.k, d) / d


@_register
class RandK(CompressionOp):
    """Keep k uniformly random coordinates at full precision."""

    k: float = 0.01
    value_bits: int = 32
    stochastic = True

    def _compress_flat(self, rng, x):
        d = x.numel()
        k = resolve_k(self.k, d)
        xf = x.to(torch.float32)
        idx = _rand_subset(rng, d, k, x.device)
        out = _scatter(d, idx, xf[idx])
        # Rand_k indices can be seeded: only the seed + values cross the wire
        return out, _f32(bitlib.bits_randk(d, k, self.value_bits), x)

    def gamma(self, d):
        return resolve_k(self.k, d) / d


def _as_rows(x: torch.Tensor, row: int) -> torch.Tensor:
    pad = (-x.numel()) % row
    xf = x.to(torch.float32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    return xf.reshape(-1, row)


@_register
class RowTopK(CompressionOp):
    """Top-k per row of the flattened tensor cut into ``row_len`` rows
    (zero-padded); ``k`` is per row.  By Corollary 1 (piecewise
    compression) gamma = k_row / row_len."""

    k: float = 0.01
    row_len: int = 4096
    value_bits: int = 32

    def _compress_flat(self, rng, x):
        d = x.numel()
        row = min(self.row_len, d)
        k = resolve_k(self.k, row)
        xf = _as_rows(x, row)
        idx = top_k_indices(xf.abs(), k)
        out = _row_scatter(xf.shape, idx, torch.gather(xf, 1, idx))
        nrows = xf.shape[0]
        bits = nrows * bitlib.bits_topk(row, k, self.value_bits)
        return out.reshape(-1)[:d], _f32(bits, x)

    def gamma(self, d):
        row = min(self.row_len, d)
        return resolve_k(self.k, row) / row


# ---------------------------------------------------------------------------
# quantizers (Definition 1 / Definition 2)
# ---------------------------------------------------------------------------


def qsgd_quantize(rng: Rng, x: torch.Tensor, s: int) -> torch.Tensor:
    """Core QSGD map (shared with the kernel's plain version): draws
    ``x.shape`` uniforms from ``rng``."""
    norm = torch.sqrt((x * x).sum())
    safe = torch.where(norm > 0, norm, _f32(1.0, x))
    level = x.abs() / safe * _f32(s, x)          # in [0, s]
    low = torch.floor(level)
    prob = level - low
    u = uniform(rng, x.shape, x.device)
    xi = low + (u < prob).to(torch.float32)
    q = norm * torch.sign(x) * xi / _f32(s, x)
    return torch.where(norm > 0, q, torch.zeros_like(x))


@_register
class QSGDQuantizer(CompressionOp):
    """QSGD [AGL+17]: q_i = ||x||_2 * sign(x_i) * xi_i / s, xi_i the
    stochastic rounding of s*|x_i|/||x|| to an adjacent integer level.
    Unbiased; E||Q(x)||^2 <= (1 + beta) ||x||^2 with
    beta = min(d/s^2, sqrt(d)/s)."""

    s: int = 15  # number of levels (4-bit quantizer => s = 2^4 - 1)
    stochastic = True

    def _compress_flat(self, rng, x):
        out = qsgd_quantize(rng, x.to(torch.float32), self.s)
        nz = (out != 0.0).sum()
        return out, bitlib.bits_qsgd(x.numel(), self.s, nz)

    def beta(self, d: int) -> float:
        return min(d / self.s**2, math.sqrt(d) / self.s)

    def gamma(self, d):
        b = self.beta(d)
        if b >= 1.0:
            return 0.0  # outside Lemma-1 operating regime
        return 1.0 - b


def _klevel(rng: Rng, v: torch.Tensor, s: int) -> torch.Tensor:
    lo, hi = v.min(), v.max()
    span = torch.where(hi > lo, hi - lo, _f32(1.0, v))
    level = (v - lo) / span * _f32(s, v)
    low = torch.floor(level)
    u = uniform(rng, v.shape, v.device)
    xi = low + (u < (level - low)).to(torch.float32)
    return torch.where(hi > lo, lo + xi / _f32(s, v) * span, v)


@_register
class StochasticKLevel(CompressionOp):
    """Stochastic s-level quantization between min_i x_i and max_i x_i
    [SYKM17, ZDJW13]; beta = d / (2 s^2)."""

    s: int = 15
    stochastic = True

    def _compress_flat(self, rng, x):
        out = _klevel(rng, x.to(torch.float32), self.s)
        return out, _f32(bitlib.bits_klevel(x.numel(), self.s), x)

    def beta(self, d: int) -> float:
        return d / (2.0 * self.s**2)

    def gamma(self, d):
        return max(0.0, 1.0 - self.beta(d))


def _pm_one(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, _f32(1.0, v), _f32(-1.0, v))


@_register
class Sign(CompressionOp):
    """Deterministic 1-bit sign quantizer, scaled by ||x||_1 / d so that
    it is a compression operator (Lemma 3 with k = d, m = 1)."""

    def _compress_flat(self, rng, x):
        xf = x.to(torch.float32)
        d = x.numel()
        scale = xf.abs().sum() / _f32(d, x)
        return scale * _pm_one(xf), _f32(bitlib.bits_sign(d), x)

    def gamma(self, d):
        return 1.0 / d  # worst case (Lemma 3, m = 1 lower term)


# ---------------------------------------------------------------------------
# compositions (Lemmas 1-3)
# ---------------------------------------------------------------------------


@_register
class QuantizedSparsifier(CompressionOp):
    """``Q_s ∘ Comp_k``: QSGD (or k-level) applied to the k surviving
    coordinates of Top_k/Rand_k.

    scaled=False -> Lemma 1 (requires beta_{k,s} < 1; gamma=(1-beta)k/d)
    scaled=True  -> Lemma 2 (always compression; gamma = k/(d(1+beta)))

    Draws: Rand_k's d subset uniforms (sparsifier "rand" only), then the
    quantizer's k uniforms.
    """

    k: float = 0.01
    s: int = 15
    scaled: bool = False
    sparsifier: str = "top"  # "top" | "rand"
    quantizer: str = "qsgd"  # "qsgd" | "klevel"
    stochastic = True

    def _compress_flat(self, rng, x):
        d = x.numel()
        k = resolve_k(self.k, d)
        xf = x.to(torch.float32)
        if self.sparsifier == "top":
            idx = top_k_indices(xf.abs(), k)
        else:
            idx = _rand_subset(rng, d, k, x.device)
        sel = xf[idx]  # compact k-vector: quantize it as a k-dim vector
        if self.quantizer == "qsgd":
            qsel = qsgd_quantize(rng, sel, self.s)
            beta = min(k / self.s**2, math.sqrt(k) / self.s)
        else:
            qsel = _klevel(rng, sel, self.s)
            beta = k / (2.0 * self.s**2)
        if self.scaled:
            qsel = qsel / _f32(1.0 + beta, x)
        out = _scatter(d, idx, qsel)
        nz = (qsel != 0.0).sum()
        if self.sparsifier == "top":
            bits = bitlib.bits_qtopk(d, k, self.s, nz)
        else:
            bits = bitlib.bits_qrandk(d, k, self.s, nz)
        return out, bits

    def beta(self, d: int) -> float:
        k = resolve_k(self.k, d)
        if self.quantizer == "qsgd":
            return min(k / self.s**2, math.sqrt(k) / self.s)
        return k / (2.0 * self.s**2)

    def gamma(self, d):
        k = resolve_k(self.k, d)
        b = self.beta(d)
        if self.scaled:
            return k / (d * (1.0 + b))
        return max(0.0, (1.0 - b) * k / d)


def _norm_m(sel: torch.Tensor, m: int, dim=None) -> torch.Tensor:
    keep = dim is not None
    if m == 1:
        return sel.abs().sum(dim=dim, keepdim=keep) if keep \
            else sel.abs().sum()
    sq = (sel * sel).sum(dim=dim, keepdim=keep) if keep \
        else (sel * sel).sum()
    return torch.sqrt(sq)


@_register
class SignSparsifier(CompressionOp):
    """``SignComp_k`` (Lemma 3): 1-bit sign of the k selected
    coordinates, scaled by ||Comp_k(x)||_m / k.  m=1 or 2 supported."""

    k: float = 0.01
    m: int = 1
    sparsifier: str = "top"
    stochastic = True  # only when sparsifier == "rand"

    def _compress_flat(self, rng, x):
        d = x.numel()
        k = resolve_k(self.k, d)
        xf = x.to(torch.float32)
        if self.sparsifier == "top":
            idx = top_k_indices(xf.abs(), k)
        else:
            idx = _rand_subset(rng, d, k, x.device)
        sel = xf[idx]
        norm = _norm_m(sel, self.m)
        out = _scatter(d, idx, norm / _f32(k, x) * _pm_one(sel))
        return out, _f32(bitlib.bits_signtopk(d, k), x)

    def gamma(self, d):
        k = resolve_k(self.k, d)
        if self.m == 1:
            return 1.0 / d  # conservative lower bound from Lemma 3
        return k ** (2.0 / self.m - 1.0) / d


@_register
class RowSignTopK(CompressionOp):
    """SignTopK applied per row (TP-shard/block-local SignComp_k)."""

    k: float = 0.01
    row_len: int = 4096
    m: int = 2

    def _compress_flat(self, rng, x):
        d = x.numel()
        row = min(self.row_len, d)
        k = resolve_k(self.k, row)
        xf = _as_rows(x, row)
        idx = top_k_indices(xf.abs(), k)
        sel = torch.gather(xf, 1, idx)
        norm = _norm_m(sel, self.m, dim=1)
        out = _row_scatter(xf.shape, idx, norm / _f32(k, x) * _pm_one(sel))
        nrows = xf.shape[0]
        bits = _f32(nrows * bitlib.bits_signtopk(row, k), x)
        return out.reshape(-1)[:d], bits

    def gamma(self, d):
        row = min(self.row_len, d)
        k = resolve_k(self.k, row)
        return k ** (2.0 / self.m - 1.0) / row


# ---------------------------------------------------------------------------
# piecewise application over trees (Corollary 1)
# ---------------------------------------------------------------------------


def _is_op(z) -> bool:
    return isinstance(z, CompressionOp)


def ops_for_leaves(op_tree, n_leaves: int) -> list:
    """Resolve a single op (broadcast) or a tree-prefix of ops to one
    operator per gradient leaf."""
    if isinstance(op_tree, CompressionOp):
        return [op_tree] * n_leaves
    ops = tree_leaves(op_tree, is_leaf=_is_op)
    if len(ops) != n_leaves:
        raise ValueError(
            f"operator tree has {len(ops)} leaves, grads have {n_leaves}")
    return ops


def compress_tree(op_tree, rng: Rng, grads):
    """Apply a (tree of) compression operator(s) leafwise.

    Returns (compressed_tree, total_bits).  By Corollary 1 the leafwise
    application is itself a compression operator with
    gamma = min_i gamma_i.  ``rng`` serves every leaf in flatten order.
    """
    leaves, spec = tree_flatten(grads)
    ops = ops_for_leaves(op_tree, len(leaves))
    outs, bit_terms = [], []
    for op, g in zip(ops, leaves):
        o, b = op(rng, g)
        outs.append(o)
        bit_terms.append(b)
    total = (bitlib.ledger_sum(bit_terms) if bit_terms
             else torch.zeros((), dtype=torch.float32))
    return tree_unflatten(spec, outs), total


def tree_gamma(op_tree, grads) -> float:
    """min_i gamma_i over leaves (Corollary 1)."""
    leaves = tree_leaves(grads)
    ops = ops_for_leaves(op_tree, len(leaves))
    return min(op.gamma(int(l.numel())) for op, l in zip(ops, leaves))


# operator registry (config/spec-driven construction) ---------------------


@dataclasses.dataclass(frozen=True)
class RegisteredOp:
    """One registry entry: a name bound to a class + pinned kwargs."""

    name: str
    cls: type
    fixed: Tuple[Tuple[str, object], ...]  # kwargs the alias pins
    summary: str = ""

    def fields(self) -> dict:
        """Configurable constructor fields (name -> default), with the
        alias-pinned ones removed."""
        pinned = {k for k, _ in self.fixed}
        return {f.name: f.default for f in dataclasses.fields(self.cls)
                if f.name not in pinned}


OP_REGISTRY: dict[str, RegisteredOp] = {}


def register_op(name: str, summary: str = "", **fixed):
    """Class decorator registering a ``CompressionOp`` under ``name``.
    ``fixed`` kwargs are pinned by the alias."""

    def deco(cls):
        if name in OP_REGISTRY:
            raise ValueError(f"operator name {name!r} already registered")
        for k in fixed:
            if k not in {f.name for f in dataclasses.fields(cls)}:
                raise TypeError(
                    f"register_op({name!r}): {cls.__name__} has no "
                    f"field {k!r}")
        OP_REGISTRY[name] = RegisteredOp(
            name, cls, tuple(sorted(fixed.items())), summary)
        return cls

    return deco


register_op("identity", "no compression (vanilla / local SGD)")(Identity)
register_op("topk", "Top_k sparsifier [SCJ18]")(TopK)
register_op("randk", "Rand_k sparsifier [SCJ18]")(RandK)
register_op("row_topk", "per-row Top_k (TP-shard-local, Cor. 1)")(RowTopK)
register_op("qsgd", "QSGD quantizer [AGL+17], Definition 1")(QSGDQuantizer)
register_op("klevel", "stochastic s-level quantizer [SYKM17]")(
    StochasticKLevel)
register_op("sign", "scaled 1-bit sign, Definition 2")(Sign)
register_op("qtopk", "QSGD o Top_k (Lemmas 1-2)",
            sparsifier="top")(QuantizedSparsifier)
register_op("qrandk", "QSGD o Rand_k (Lemmas 1-2)",
            sparsifier="rand")(QuantizedSparsifier)
register_op("signtopk", "Sign o Top_k (Lemma 3)",
            sparsifier="top")(SignSparsifier)
register_op("signrandk", "Sign o Rand_k (Lemma 3)",
            sparsifier="rand")(SignSparsifier)
register_op("row_signtopk", "per-row SignTop_k (TP-shard-local)")(
    RowSignTopK)


def make_operator(name: str, **kw) -> CompressionOp:
    """Construct a registered operator; loud errors for unknown names
    and unknown/pinned kwargs."""
    if name not in OP_REGISTRY:
        raise KeyError(
            f"unknown operator {name!r}; registered: {sorted(OP_REGISTRY)}")
    entry = OP_REGISTRY[name]
    pinned = dict(entry.fixed)
    clash = sorted(set(kw) & set(pinned))
    if clash:
        raise TypeError(
            f"operator {name!r} pins {clash}; use a different registry "
            f"name instead of overriding")
    valid = entry.fields()
    unknown = sorted(set(kw) - set(valid))
    if unknown:
        raise TypeError(
            f"operator {name!r} has no parameter(s) {unknown}; "
            f"valid: {sorted(valid)}")
    return entry.cls(**pinned, **kw)


def spec_name_of(op: CompressionOp) -> str:
    """The registry name serializing this operator instance (most-pinned
    matching entry wins)."""
    best = None
    for entry in OP_REGISTRY.values():
        if entry.cls is not type(op):
            continue
        if all(getattr(op, k) == v for k, v in entry.fixed):
            if best is None or len(entry.fixed) > len(best.fixed):
                best = entry
    if best is None:
        raise KeyError(
            f"{type(op).__name__}({op!r}) matches no registered operator "
            f"name; register it with register_op")
    return best.name
