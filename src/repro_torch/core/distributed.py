"""The distributed Qsparse-local-SGD engine on ``torch.distributed`` (a
port of ``repro.core.distributed``, worker axes first).

``repro`` maps worker r to one (pod, data) row of a TPU mesh and runs
the step inside ``shard_map``.  Here one process (rank) is one worker,
as one device per data-axis slot is there (``launch/mesh.py``):

  * ``master`` is replicated on every rank; ``local``, ``memory`` and
    ``inner`` belong to the rank's own worker (no worker axis);
  * ``psum`` of the wire bits is ``all_reduce(SUM)``; ``pmean`` of the
    loss and of the dense payload is ``all_reduce`` then a divide by R;
  * the sparse wire's gathered buffers are an ``all_gather`` of each
    leaf's fixed-shape ``(idx, val)`` slots, decoded for all W workers in
    one scatter-add.

Two steps, as in ``repro``: ``local_step`` (Algorithm 1 lines 5-7) and
``sync_step`` (lines 8-11 and the master update) on the wire chosen at
build time, ``dense_psum`` (compressed dense payloads, all-reduced) or
``sparse_allgather`` (compact survivor slots written by the
``topk_compact`` kernel, all-gathered): the same math and the same
ledger either way.  The exact dense broadcast of the new master is
charged to ``bits_down``.

Compression is per leaf along one axis: ``_pick_axis`` keeps Top_k off
the ``model``-sharded axis of the leaf's spec (Corollary 1, piecewise
compression), so the specs decide the rows and the wire bits even while
the model axis is 1.

The round runtime (``make_dist_round``, ``make_dist_multiround``) runs a
sync round, or a window of them, as one program: a CUDA graph on the
card in a world of one whose collectives are device work
(:func:`round_fused`), else the per-step composition.

``partial=True`` takes a per-step participation mask (fleet scenarios,
``core/scenarios.py``): a worker whose bit is False transmits nothing,
keeps its error memory and its half-step iterate, and its master
*view* (carried in the state) stays on the copy it last received.  Not
ported yet, and refused with ``NotImplementedError`` naming their
ROADMAP item: ZeRO-1, a compressed downlink, the fault runtime and a
model axis above 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bits as bitlib
from repro_torch.core import channel as chn
from repro_torch.core.scenarios import AGGREGATES
from repro_torch.core.engine import _inner_update
from repro_torch.device import as_tensor
from repro_torch.core.operators import (
    CompressionOp,
    Identity,
    RowSignTopK,
    RowTopK,
    SignSparsifier,
    TopK,
    ops_for_leaves,
    resolve_k,
)
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels import ref
from repro_torch.optim.transforms import GradientTransform, apply_updates
from repro_torch.sharding.specs import is_spec
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

WIRES = ("dense_psum", "sparse_allgather")


class DistQsparseState(NamedTuple):
    """One rank's view of the distributed state: the replicated master
    and its own worker's iterate, error memory and optimizer state.
    ``step`` and ``rounds`` are host counters; ``bits`` / ``bits_down``
    are float32 ledgers summed over all workers (every rank holds the
    same totals)."""

    master: Any
    local: Any
    memory: Any
    inner: Any
    step: int
    bits: torch.Tensor        # uplink wire bits (worker -> server)
    rounds: int
    bits_down: torch.Tensor   # server -> worker
    # partial participation: the master copy this worker last received
    # (None unless built with partial=True)
    view: Any = None


# ---------------------------------------------------------------------------
# per-leaf compression along one axis
# ---------------------------------------------------------------------------


def _pick_axis(shape: tuple, spec) -> int:
    """The last axis not sharded by ``model`` (and longer than 1)."""
    if spec is None:
        return len(shape) - 1
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def uses_model(e):
        if e is None:
            return False
        if isinstance(e, (tuple, list)):
            return "model" in e
        return e == "model"

    for ax in range(len(shape) - 1, -1, -1):
        if not uses_model(entries[ax]) and shape[ax] > 1:
            return ax
    return len(shape) - 1


def _axis_rows(x: torch.Tensor, axis: int):
    """x moved so ``axis`` is last, as float32 [rows, n] (a copy)."""
    xm = torch.movedim(x.to(torch.float32), axis, -1)
    return xm, xm.reshape(-1, xm.shape[-1])


def _axis_bits(n: int, nrows: int, cnt: torch.Tensor, sign: bool):
    """``repro``'s ledger for axis Top_k: one 32-bit field per row plus
    the counted survivors (the counted helper already holds one field)."""
    counted = (bitlib.bits_signtopk_counted if sign
               else bitlib.bits_topk_counted)
    dev = cnt.device
    return (bitlib.f32(32 * nrows, dev) + counted(n, cnt.sum())
            - bitlib.f32(32, dev))


def axis_topk_compact(x: torch.Tensor, k_frac: float, axis: int,
                      sign_bits: bool = False, dispatch_cfg=None):
    """Top_k along ``axis`` in compact form (DESIGN.md §3.3).

    Returns (idx [..., kcap] int32, val [..., kcap] float32, mem — the
    fused error memory in ``x``'s layout, float32 —, wire_bits,
    moved_shape): idx / val on the moved-to-last layout, indices
    row-local, empty slots (n, 0).  ``dispatch.compact_rows`` runs the
    ``topk_compact`` kernel where it is eligible, else its plain version.
    """
    n = x.shape[axis]
    k = resolve_k(k_frac, n)
    kcap = dsp.capacity(k, n)
    xm, rows = _axis_rows(x, axis)
    idx, val, mem, cnt = dsp.compact_rows(
        rows, k, kcap, sign=sign_bits, cfg=dispatch_cfg,
        leaf_size=x.numel())
    bits = _axis_bits(n, rows.shape[0], cnt, sign_bits)
    moved = tuple(xm.shape)
    idx = idx.reshape(moved[:-1] + (kcap,))
    val = val.reshape(moved[:-1] + (kcap,))
    mem = torch.movedim(mem.reshape(moved), -1, axis)
    return idx, val, mem, bits, moved


def _densify(idx, sel, moved_shape, axis):
    """Dense decode of compact (idx, sel) buffers on the moved layout,
    through ``dispatch.decode_rows`` (sentinel slots drop)."""
    kcap = idx.shape[-1]
    out = dsp.decode_rows(idx.reshape(-1, kcap), sel.reshape(-1, kcap),
                          moved_shape[-1])
    return torch.movedim(out.reshape(moved_shape), -1, axis)


def _threshold_axis_topk(x: torch.Tensor, k_frac: float, axis: int,
                         sign_bits: bool, select):
    """Dense Top_k along ``axis``: move it last, shape [rows, n], run
    ``select(rows, k, sign) -> (sel, mem, cnt)`` (the kernel or its plain
    version), move back, charge the counted bits."""
    n = x.shape[axis]
    k = resolve_k(k_frac, n)
    xm, rows = _axis_rows(x, axis)
    sel, _mem, cnt = select(rows, k, sign_bits)
    out = torch.movedim(sel.reshape(xm.shape), -1, axis)
    return out, _axis_bits(n, rows.shape[0], cnt, sign_bits)


def axis_topk(x: torch.Tensor, k_frac: float, axis: int,
              sign_bits: bool = False):
    """Dense Top_k along ``axis`` by the bisection threshold
    (``ref.topk_compress_ref``; exact-k generically, DESIGN.md §3.1)."""
    return _threshold_axis_topk(
        x, k_frac, axis, sign_bits,
        lambda rows, k, sign: ref.topk_compress_ref(rows, k, sign=sign))


@dataclasses.dataclass(frozen=True)
class ShardCompressor:
    """Leafwise compressor of the distributed engine.

    mode: 'topk' | 'signtopk' | 'none' (Identity) | 'policy'
          (heterogeneous per-leaf operators, DESIGN.md §6: ``ops`` holds
          the resolved operator tree; build it through :meth:`from_spec`)
    k_frac: survivor fraction along the chosen axis (homogeneous modes)
    dispatch: kernel routing ('auto' = the CUDA kernels for tensors on a
          card, 'kernel' = always the kernel path, 'reference' = never);
          both the dense form (``__call__``, ``topk_compress``) and the
          compact wire form (``compact``, ``topk_compact``) dispatch.
    ops:  policy mode only.  Per leaf: Top_k-family ops run the axis Top_k
          paths (op.k the survivor fraction along the chosen axis),
          Identity transmits dense, every other operator (QSGD, ...) runs
          its reference form on the leaf and travels as a dense payload.
    """

    mode: str = "topk"
    k_frac: float = 0.01
    dispatch: str = "auto"
    ops: Any = None

    @classmethod
    def from_spec(cls, spec, params,
                  dispatch: str = "auto") -> "Optional[ShardCompressor]":
        """Build from any ``core.policy`` spec, resolved per leaf against
        ``params``; None for an all-Identity policy.  A global Top_k op
        with an absolute k (a whole-leaf count) becomes the leaf fraction
        k / d, since the axis paths select per row (DESIGN.md §6.4)."""
        from repro_torch.core import policy as pol
        op_tree = pol.resolve(spec, params)
        leaves, tspec = tree_flatten(params)
        ops_list = ops_for_leaves(op_tree, len(leaves))
        norm = [cls._normalize_leaf_op(op, int(leaf.numel()))
                for op, leaf in zip(ops_list, leaves)]
        comp = cls(mode="policy", dispatch=dispatch,
                   ops=tree_unflatten(tspec, norm))
        return None if comp.is_identity() else comp

    @staticmethod
    def _normalize_leaf_op(op: CompressionOp, d: int) -> CompressionOp:
        """Absolute whole-leaf k -> leaf fraction for global Top_k ops;
        ``1 - 1e-9`` keeps an everything-survives k a fraction."""
        if not (isinstance(op, TopK) or (isinstance(op, SignSparsifier)
                                         and op.sparsifier == "top")):
            return op
        if isinstance(op.k, float) and 0.0 < op.k < 1.0:
            return op
        frac = min(1.0 - 1e-9, float(op.k) / max(d, 1))
        return dataclasses.replace(op, k=frac)

    def _op_leaves(self) -> list:
        return tree_leaves(self.ops,
                           is_leaf=lambda o: isinstance(o, CompressionOp))

    def is_identity(self) -> bool:
        if self.mode == "none":
            return True
        if self.mode != "policy":
            return False
        return all(isinstance(o, Identity) for o in self._op_leaves())

    def _dispatch_cfg(self) -> dsp.DispatchConfig:
        return dsp.DispatchConfig(mode=self.dispatch)

    def _plans(self, n_leaves: int) -> list:
        """Per-leaf plan: ("skip",), ("axis", k, sign) or ("ref", op),
        shared by the dense path, the compact path and leaf_meta."""
        if self.mode == "policy":
            plans = []
            for op in ops_for_leaves(self.ops, n_leaves):
                if isinstance(op, Identity):
                    plans.append(("skip",))
                elif isinstance(op, (TopK, RowTopK)):
                    plans.append(("axis", op.k, False))
                elif isinstance(op, RowSignTopK) or (
                        isinstance(op, SignSparsifier)
                        and op.sparsifier == "top"):
                    plans.append(("axis", op.k, True))
                else:
                    plans.append(("ref", op))
            return plans
        if self.mode == "none":
            return [("skip",)] * n_leaves
        if self.mode not in ("topk", "signtopk"):
            raise ValueError(
                f"unknown ShardCompressor mode {self.mode!r}; expected "
                f"'topk' | 'signtopk' | 'none' | 'policy'")
        return [("axis", self.k_frac, self.mode == "signtopk")] * n_leaves

    @staticmethod
    def _skip(g: torch.Tensor) -> bool:
        """Tiny and scalar leaves transmit dense whatever the plan."""
        return g.dim() == 0 or g.numel() <= 8

    @staticmethod
    def _ref_leaf(op: CompressionOp, g: torch.Tensor, rng, i: int):
        """Reference-operator leaf (dense payload): ``op(rng, g)``.  A
        stochastic op draws from ``rng``, which every rank seeds alike,
        as ``repro``'s key is replicated over the worker axes (``i``, the
        leaf index, is where ``repro`` folds its key)."""
        if op.stochastic and rng is None:
            raise ValueError(
                f"stochastic operator {type(op).__name__} in a "
                f"ShardCompressor policy needs rng= (a torch.Generator)")
        out, b = op(rng if op.stochastic else None, g)
        return out.to(torch.float32), bitlib.f32(b, g.device)

    def _kernel_leaf(self, g, k_frac, ax, sign):
        """``axis_topk`` through the ``topk_compress`` kernel."""
        cfg = self._dispatch_cfg()
        return _threshold_axis_topk(
            g, k_frac, ax, sign,
            lambda rows, k, sign_: dsp.topk_rows(rows, k, sign=sign_,
                                                 cfg=cfg))

    @staticmethod
    def _leaf_specs(param_specs, n: int) -> list:
        if param_specs is None:
            return [None] * n
        return tree_leaves(param_specs, is_leaf=is_spec)

    def __call__(self, grads, param_specs, rng=None):
        """Dense form: (compressed tree in float32, total wire bits)."""
        dcfg = self._dispatch_cfg()
        leaves, tspec = tree_flatten(grads)
        specs = self._leaf_specs(param_specs, len(leaves))
        plans = self._plans(len(leaves))
        outs, bit_terms = [], []
        for i, (g, spec, plan) in enumerate(zip(leaves, specs, plans)):
            if plan[0] == "skip" or self._skip(g):
                outs.append(g.to(torch.float32))
                bit_terms.append(bitlib.f32(bitlib.bits_dense(g.numel()),
                                            g.device))
                continue
            if plan[0] == "ref":
                o, b = self._ref_leaf(plan[1], g, rng, i)
                outs.append(o)
                bit_terms.append(b)
                continue
            _, k_frac, sign = plan
            ax = _pick_axis(tuple(g.shape), spec)
            if dsp.rows_eligible(g.shape[ax], dcfg, leaf_size=g.numel(),
                                 device=g.device):
                o, b = self._kernel_leaf(g, k_frac, ax, sign)
            else:
                o, b = axis_topk(g, k_frac, ax, sign_bits=sign)
            outs.append(o)
            bit_terms.append(b)
        return tree_unflatten(tspec, outs), bitlib.ledger_sum(bit_terms)

    def compact(self, grads, param_specs, rng=None):
        """Compact wire form: per leaf ("dense", g) for skipped and
        reference-operator leaves (the latter carry the compressed
        payload) or ("sparse", idx, val, axis, moved_shape), indices
        row-local to the moved-to-last axis, empty slots (n, 0).  The
        fused error memories come along, so the sync never densifies a
        worker's own payload.

        Returns (payloads, tree spec, wire_bits, memory tree).
        """
        dcfg = self._dispatch_cfg()
        leaves, tspec = tree_flatten(grads)
        specs = self._leaf_specs(param_specs, len(leaves))
        plans = self._plans(len(leaves))
        payloads, bit_terms, mems = [], [], []
        for i, (g, spec, plan) in enumerate(zip(leaves, specs, plans)):
            if plan[0] == "skip" or self._skip(g):
                g32 = g.to(torch.float32)
                payloads.append(("dense", g32))
                mems.append(torch.zeros_like(g32))
                bit_terms.append(bitlib.f32(bitlib.bits_dense(g.numel()),
                                            g.device))
                continue
            if plan[0] == "ref":
                q, b = self._ref_leaf(plan[1], g, rng, i)
                payloads.append(("dense", q))
                mems.append(g.to(torch.float32) - q)
                bit_terms.append(b)
                continue
            _, k_frac, sign = plan
            ax = _pick_axis(tuple(g.shape), spec)
            idx, val, mem, b, moved = axis_topk_compact(
                g, k_frac, ax, sign_bits=sign, dispatch_cfg=dcfg)
            payloads.append(("sparse", idx, val, ax, moved))
            mems.append(mem)
            bit_terms.append(b)
        return (payloads, tspec, bitlib.ledger_sum(bit_terms),
                tree_unflatten(tspec, mems))

    def leaf_meta(self, master_tree, param_specs) -> list:
        """Payload kind per leaf, as :meth:`compact` decides it:
        ("sparse", axis, moved_shape) or ("dense", None, None)."""
        leaves = tree_leaves(master_tree)
        specs = self._leaf_specs(param_specs, len(leaves))
        meta = []
        for g, spec, plan in zip(leaves, specs, self._plans(len(leaves))):
            if plan[0] != "axis" or self._skip(g):
                meta.append(("dense", None, None))
                continue
            ax = _pick_axis(tuple(g.shape), spec)
            shape = list(g.shape)
            moved = tuple(shape[:ax] + shape[ax + 1:] + [shape[ax]])
            meta.append(("sparse", ax, moved))
        return meta

    def gamma(self) -> float:
        if self.mode == "policy":
            gs = []
            for op in self._op_leaves():
                if isinstance(op, Identity):
                    gs.append(1.0)
                elif hasattr(op, "k") and isinstance(op.k, float) \
                        and 0.0 < op.k < 1.0:
                    gs.append(op.k)
                else:
                    gs.append(0.0)  # unknown / absolute k: conservative
            return min(gs) if gs else 1.0
        return 1.0 if self.mode == "none" else self.k_frac


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def worker_count(mesh, data_axes: Sequence[str]) -> int:
    out = 1
    for a in data_axes:
        out *= mesh.shape[a]
    return out


def _make_dist_parts(
    grad_fn: Callable,                 # (params, batch) -> (loss, grads)
    inner_opt: GradientTransform,
    compressor: Optional[ShardCompressor],
    lr_schedule: Callable,
    mesh,                              # launch.mesh.Mesh
    data_axes: Sequence[str] = ("data",),
    param_specs=None,                  # spec tree (sharding/specs.py)
    zero1: bool = False,
    aggregate: str = "mean_R",         # master division rule (DESIGN.md §8)
    downlink: Optional[ShardCompressor] = None,
    wire: str = "dense_psum",          # "dense_psum" | "sparse_allgather"
    partial: bool = False,
):
    """(init_fn, local_at, sync_at): the two steps at a learning rate the
    caller gives, ``step(state, batch, rng, lr, scalars=None) -> (state,
    loss)``, shared by :func:`make_dist_steps` and the round runtime.

    ``batch`` is the rank's own batch (``repro``'s [R, ...] batch row of
    this worker).  ``rng`` (a ``torch.Generator`` seeded alike on every
    rank) feeds stochastic reference leaves.  ``aggregate``: "mean_R"
    (the paper's Σ/R), "mean_S" (Σ/|S|, which without partial
    participation is Σ/R) or "support_weighted" (per-coordinate survivor
    counts, zero-support guard).  ``wire``: "dense_psum" or
    "sparse_allgather", the same math and ledger.  Both steps return
    (state, loss averaged over the workers).

    ``partial``: the sync step takes ``mask=`` (bool[R] on the host,
    which workers sync now; ``repro``'s ``sync_mask``).  A worker with a
    False bit still compresses (every rank stays in step on the wire and
    the shared generator) but transmits zeros, keeps its memory and
    half-step iterate, and its ``view`` stays; "mean_S" divides by the
    syncing count, "support_weighted" counts the survivors' support, and
    ``rounds`` advances when anyone syncs.
    """
    if aggregate in WIRES:
        from repro_torch.core import policy as pol
        pol.warn_once(
            "dist-aggregate-wire",
            "aggregate= now names the aggregation rule ('mean_R' | "
            "'mean_S' | 'support_weighted'); wire formats moved to "
            f"wire=. Mapping aggregate={aggregate!r} to wire= with "
            "aggregate='mean_R' (the historical behaviour).")
        wire, aggregate = aggregate, "mean_R"
    if aggregate not in AGGREGATES:
        raise ValueError(f"unknown aggregate {aggregate!r}; expected one "
                         f"of {AGGREGATES}")
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}; expected 'dense_psum' "
                         f"| 'sparse_allgather'")
    if zero1:
        raise NotImplementedError(
            "zero1 (the ZeRO-1 sharded master) is not ported yet: ROADMAP "
            "queue 1 item 12")
    daxes = tuple(data_axes)
    for a, size in mesh.shape.items():
        if a not in daxes and size > 1:
            raise NotImplementedError(
                f"mesh axis {a!r} of size {size}: tensor parallelism is not "
                "ported yet (ROADMAP queue 1 item 12)")
    R = worker_count(mesh, daxes)
    if R != mesh.world_size:
        raise ValueError(f"{R} workers on the mesh but a world of "
                         f"{mesh.world_size} ranks")
    if compressor is None:
        compressor = ShardCompressor("none")
    up = chn.ShardChannel(compressor, "uplink")
    down = chn.ShardChannel(downlink, "downlink")
    if not down.is_identity():
        raise NotImplementedError(
            "a compressed downlink on the distributed engine is not ported "
            "yet: ROADMAP queue 1 item 12")

    def _local(state: DistQsparseState, batch, lr, scalars):
        loss, grads = grad_fn(state.local, batch)
        updates, inner_new = _inner_update(inner_opt, grads, state.inner,
                                           state.local, lr, scalars)
        return apply_updates(state.local, updates), inner_new, loss

    def local_at(state: DistQsparseState, batch, rng, lr, scalars=None):
        half, inner_new, loss = _local(state, batch, lr, scalars)
        return state._replace(local=half, inner=inner_new,
                              step=state.step + 1), mesh.mean(loss)

    def _delta(state, half):
        # f32 error-compensated accumulator m + x - x̂, repro's cast order;
        # under partial participation against the worker's lagging view
        ref = state.view if partial else state.master
        return tree_map(lambda m, x, h: m + x.to(torch.float32)
                        - h.to(torch.float32), state.memory, ref, half)

    def _mask(mask):
        """(this worker syncs, the syncing count) of a step's mask."""
        if not partial:
            return True, R
        if mask is None:
            raise ValueError(
                "this step was built with partial=True: pass the bool[R] "
                "mask= of the step (which workers sync now)")
        m = np.broadcast_to(np.asarray(mask, bool).reshape(-1), (R,))
        return bool(m[mesh.rank]), int(m.sum())

    def _divisor(n_sync: int):
        """The master's divisor: mean_S divides by the syncing count."""
        if aggregate == "mean_S" and partial:
            return float(max(n_sync, 1))
        return R

    def _dense_mean(g: torch.Tensor, n_sync: int) -> torch.Tensor:
        """The master's divisor rule over an all-reduced dense payload."""
        if aggregate == "support_weighted":
            cnt = mesh.all_reduce_sum((g != 0).to(torch.float32))
            return mesh.all_reduce_sum(g) / torch.clamp(cnt, min=1.0)
        return mesh.all_reduce_sum(g) / _divisor(n_sync)

    def _finish(state, half, new_master, inner_new, memory, wire_bits, loss,
                syncs: bool, n_sync: int):
        dev = state.bits.device
        if not partial:
            return DistQsparseState(
                master=new_master,
                local=new_master,            # the exact broadcast
                memory=memory, inner=inner_new, step=state.step + 1,
                bits=state.bits + mesh.all_reduce_sum(wire_bits),
                rounds=state.rounds + 1,
                bits_down=state.bits_down + bitlib.f32(
                    R * down.dense_bits(state.master), dev)), mesh.mean(loss)
        # only the syncing workers receive x̄_{t+1}; the others keep their
        # half-step iterate and their view
        return DistQsparseState(
            master=new_master,
            local=new_master if syncs else half,
            memory=memory if syncs else state.memory,
            inner=inner_new, step=state.step + 1,
            bits=state.bits + mesh.all_reduce_sum(
                wire_bits if syncs else torch.zeros_like(wire_bits)),
            rounds=state.rounds + int(n_sync > 0),
            bits_down=state.bits_down + bitlib.f32(
                np.float32(n_sync) * np.float32(
                    down.dense_bits(state.master)), dev),
            view=new_master if syncs else state.view), mesh.mean(loss)

    def _apply_mean(master, means):
        return tree_map(lambda x, gg: (x.to(torch.float32) - gg).to(x.dtype),
                        master, means)

    def sync_dense_at(state: DistQsparseState, batch, rng, lr,
                      scalars=None, mask=None):
        syncs, n_sync = _mask(mask)
        half, inner_new, loss = _local(state, batch, lr, scalars)
        delta = _delta(state, half)
        if not partial:
            half = None          # freed before the compression
        g, new_mem, wire_bits = up.apply(delta, param_specs, rng=rng)
        del delta
        if not syncs:
            g = tree_map(torch.zeros_like, g)     # transmits nothing
        new_master = _apply_mean(state.master, tree_map(
            lambda gg: _dense_mean(gg, n_sync), g))
        return _finish(state, half, new_master, inner_new, new_mem,
                       wire_bits, loss, syncs, n_sync)

    def _sparse_mean(pl, n_sync: int):
        """One leaf's mean over the W workers' gathered payloads."""
        if pl[0] == "dense":
            arr = mesh.all_gather(pl[1])                  # [W, ...]
            if aggregate == "support_weighted":
                cnt = (arr != 0).to(torch.float32).sum(dim=0)
                return arr.sum(dim=0) / torch.clamp(cnt, min=1.0)
            return arr.sum(dim=0) / (_divisor(n_sync) if partial
                                     else arr.shape[0])
        _, idx, sel, ax, moved = pl
        idx_all = mesh.all_gather(idx)                    # [W, ..., kcap]
        sel_all = mesh.all_gather(sel)
        W, kcap = idx_all.shape[0], idx_all.shape[-1]
        # all W workers' slots of a row decode in one scatter-add (the
        # indices are row-local; sentinel slots drop)
        ii = torch.movedim(idx_all, 0, -2).reshape(-1, W * kcap)
        ss = torch.movedim(sel_all, 0, -2).reshape(-1, W * kcap)
        dense = _densify(ii, ss, moved, ax)
        if aggregate == "support_weighted":
            cnt = _densify(ii, (ss != 0).to(torch.float32), moved, ax)
            return dense / torch.clamp(cnt, min=1.0)
        return dense / (_divisor(n_sync) if partial else W)

    def _silent(pl):
        """A payload that transmits nothing: its values zeroed (the
        sentinel-style decode and the support counts see zeros)."""
        if pl[0] == "dense":
            return ("dense", torch.zeros_like(pl[1]))
        return pl[:2] + (torch.zeros_like(pl[2]),) + pl[3:]

    def sync_sparse_at(state: DistQsparseState, batch, rng, lr,
                       scalars=None, mask=None):
        syncs, n_sync = _mask(mask)
        half, inner_new, loss = _local(state, batch, lr, scalars)
        delta = _delta(state, half)
        if not partial:
            half = None          # freed before the compression
        payloads, _, wire_bits, new_mem = compressor.compact(
            delta, param_specs, rng=rng)
        del delta
        if not syncs:
            payloads = [_silent(pl) for pl in payloads]
        means = [_sparse_mean(pl, n_sync) for pl in payloads]
        del payloads
        _, mspec = tree_flatten(state.master)
        new_master = _apply_mean(state.master, tree_unflatten(mspec, means))
        return _finish(state, half, new_master, inner_new, new_mem,
                       wire_bits, loss, syncs, n_sync)

    sync_at = (sync_sparse_at if wire == "sparse_allgather"
               else sync_dense_at)

    def init_fn(params) -> DistQsparseState:
        """``params`` are the same on every rank (the replicated master)."""
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return DistQsparseState(
            master=params, local=params,
            memory=tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params),
            inner=inner_opt.init(params), step=0,
            bits=torch.zeros((), dtype=torch.float32, device=dev),
            rounds=0,
            bits_down=torch.zeros((), dtype=torch.float32, device=dev),
            # every worker's first view is the initial master
            view=params if partial else None)

    return init_fn, local_at, sync_at


def make_dist_steps(grad_fn: Callable, inner_opt: GradientTransform,
                    compressor: Optional[ShardCompressor],
                    lr_schedule: Callable, mesh, data_axes=("data",),
                    param_specs=None, **kw):
    """Returns (init_fn, local_step, sync_step) for this rank's worker,
    ``step(state, batch, rng=None) -> (state, loss averaged over the
    workers)``; the keywords (``zero1``, ``aggregate``, ``downlink``,
    ``wire``, ``partial``) as in :func:`_make_dist_parts`."""
    init_fn, local_at, sync_at = _make_dist_parts(
        grad_fn, inner_opt, compressor, lr_schedule, mesh, data_axes,
        param_specs, **kw)

    def local_step(state: DistQsparseState, batch, rng=None):
        return local_at(state, batch, rng, lr_schedule(state.step))

    def sync_step(state: DistQsparseState, batch, rng=None, mask=None):
        """``mask``: the step's bool[R] participation (``partial=True``)."""
        return sync_at(state, batch, rng, lr_schedule(state.step),
                       mask=mask)

    return init_fn, local_step, sync_step


# ---------------------------------------------------------------------------
# the round runtime
# ---------------------------------------------------------------------------


def round_fused(mesh) -> bool:
    """Can a round run as one program (a CUDA graph on the card)?  On the
    CPU, yes (no graph: the program runs eagerly, gloo collectives
    included).  On the card, only in a world of one whose collectives
    stay on the device (NCCL, or no process group): the graph then holds
    the wire's NCCL calls.  Under gloo a CUDA tensor's collective is
    staged through host memory, which no graph can hold; NCCL rounds
    across several ranks are not enabled, as their one run on four
    cards hung (PERF.md §6).  Both take the per-step composition.
    Decided from the mesh, before anything runs."""
    if mesh.device.type == "cpu":
        return True
    return mesh.world_size == 1 and mesh.backend != "gloo"


class DistRounds:
    """The distributed engine's round program: ``self(state, blocks,
    rng=None, tails=None) -> (state, losses [W, L], leds)`` runs W rounds
    of L steps (``blocks`` leaves [W, L, ...]), L - 1 local steps and the
    sync step at each round's tail; ``leds`` holds bits, bits_down and
    rounds after each round.  Under ``partial`` ``tails`` gives the W
    tail masks (bool[W, R]); an all-False tail is a local step.
    :meth:`round` runs one round of an [L, ...] block.  ``fused``: one
    ``engine.RoundRunner`` program per (W, L, tails), a CUDA graph on the
    card.  Otherwise the per-step composition, each step at the
    schedule's learning rate, as :func:`make_dist_steps` runs it."""

    def __init__(self, local_at, sync_at, lr_schedule, inner_opt, mesh,
                 partial: bool = False):
        from repro_torch.core.engine import RoundRunner
        self.local_at, self.sync_at = local_at, sync_at
        self.lr_schedule = lr_schedule
        self.partial = partial
        self.fused = round_fused(mesh)
        self.runner = (RoundRunner(self._step, lr_schedule, inner_opt)
                       if self.fused else None)

    def _step(self, state, batch, mask, rng, lr, scalars=None):
        if mask is None or not np.any(mask):
            return self.local_at(state, batch, rng, lr, scalars)
        return self.sync_at(state, batch, rng, lr, scalars, mask=mask)

    @property
    def captures(self) -> int:
        return 0 if self.runner is None else self.runner.captures

    def round(self, state: DistQsparseState, batch_block, rng=None,
              tail=None):
        state, losses, _ = self(
            state, tree_map(lambda x: x[None], batch_block), rng,
            None if tail is None else [tail])
        return state, losses[0]

    def _tails(self, W: int, tails) -> list:
        if not self.partial:
            return [np.ones((), bool)] * W
        if tails is None or len(tails) != W:
            raise ValueError(
                "built with partial=True: pass the W rounds' tail masks "
                "(tails=, bool[W, R])")
        return [np.asarray(t, bool) for t in tails]

    def __call__(self, state: DistQsparseState, blocks, rng=None,
                 tails=None):
        lead = tree_leaves(blocks)[0]
        W, L = int(lead.shape[0]), int(lead.shape[1])
        tails = self._tails(W, tails)
        if self.fused:
            return self.runner.run(state, blocks, tails, rng)
        dev = state.bits.device
        losses, leds = [], {"bits": [], "bits_down": [], "rounds": []}
        for w in range(W):
            for i in range(L):
                batch = tree_map(lambda b: as_tensor(b[w, i], dev), blocks)
                state, loss = self._step(
                    state, batch, tails[w] if i == L - 1 else None, rng,
                    self.lr_schedule(state.step))
                losses.append(loss)
            leds["bits"].append(state.bits.clone())
            leds["bits_down"].append(state.bits_down.clone())
            leds["rounds"].append(state.rounds)
        leds = {"bits": torch.stack(leds["bits"]),
                "bits_down": torch.stack(leds["bits_down"]),
                "rounds": torch.tensor(leds["rounds"])}
        return state, torch.stack(losses).reshape(W, L), leds


def make_dist_round(grad_fn: Callable, inner_opt: GradientTransform,
                    compressor: Optional[ShardCompressor],
                    lr_schedule: Callable, mesh, data_axes=("data",),
                    param_specs=None, **kw):
    """The round runtime of the distributed engine: ``(init_fn,
    round_fn, fused)``.  ``round_fn(state, batch_block, rng=None) ->
    (state, losses [L])`` runs one sync round: L - 1 local steps, then
    the sync step at the tail (L the block's leading dim, [L, ...] leaves
    of this rank's batches).  ``fused`` (:func:`round_fused`): the round
    is one program, a CUDA graph per round length on the card (the
    donation contract of ``engine.make_superstep``); else the per-step
    composition, ``repro``'s ``fused=False`` shape.  Either way the
    trajectory is :func:`make_dist_steps`'.  Keywords as there; with
    ``partial=True`` ``round_fn`` takes ``tail=`` (the tail step's
    bool[R] mask: rounds close at any-worker-sync steps)."""
    init_fn, local_at, sync_at = _make_dist_parts(
        grad_fn, inner_opt, compressor, lr_schedule, mesh, data_axes,
        param_specs, **kw)
    program = DistRounds(local_at, sync_at, lr_schedule, inner_opt, mesh,
                         partial=kw.get("partial", False))
    return init_fn, program.round, program.fused


def make_dist_multiround(grad_fn: Callable, inner_opt: GradientTransform,
                         compressor: Optional[ShardCompressor],
                         lr_schedule: Callable, mesh, data_axes=("data",),
                         param_specs=None, **kw):
    """Windows of equal-length rounds as one program each: ``(init_fn,
    multiround_fn, fused)`` with ``multiround_fn`` a :class:`DistRounds`
    (``(state, blocks, rng=None) -> (state, losses [W, L], leds)``,
    ``blocks`` stacking W round blocks, ``leds`` the ledger after each
    round; ``repro``'s multiround returns none, and its launcher logs a
    window's interior steps with the totals before the window).  Bit for
    bit W :func:`make_dist_round` calls."""
    init_fn, local_at, sync_at = _make_dist_parts(
        grad_fn, inner_opt, compressor, lr_schedule, mesh, data_axes,
        param_specs, **kw)
    program = DistRounds(local_at, sync_at, lr_schedule, inner_opt, mesh,
                         partial=kw.get("partial", False))
    return init_fn, program, program.fused
