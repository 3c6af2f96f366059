"""The distributed Qsparse-local-SGD engine on ``torch.distributed`` (a
port of ``repro.core.distributed``, worker axes first).

``repro`` maps worker r to one (pod, data) row of a TPU mesh, runs the
step inside ``shard_map`` over the data axes and leaves the ``model``
axis to XLA.  Here one process (rank) is one device of the mesh
(``launch/mesh.py``): a worker is the M ranks of its model group, each
holding its model shard of every leaf (``sharding.specs.shard_layout``;
``repro``'s ``state_shardings``), and the workers' collectives run over
the **data group**, the ranks that hold the same shard:

  * ``master`` is replicated over the workers (or sliced over them,
    ZeRO-1); ``local``, ``memory``, ``inner``, ``view`` and
    ``down_memory`` belong to the rank's own worker (no worker axis);
    each is the rank's model shard;
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
charged to ``bits_down``, or the compressed downlink's counted bits.

Compression is per leaf along one axis: ``_pick_axis`` keeps Top_k off
the ``model``-sharded axis of the leaf's spec (Corollary 1, piecewise
compression), so the specs decide the rows and the wire bits whatever
the model axis's size, and each rank compresses its own rows
(:class:`ModelShards`).  The ledger is the whole worker's: the rows'
survivor counts are summed over the model group as integers and the
counted formula applied once, as ``repro`` counts once on the global
leaf.  A leaf whose picked axis is itself split, or a reference operator
(QSGD, ...) on a split leaf, is gathered whole over the model group,
compressed whole (never half a row), and each rank keeps its slice.
``repro``'s ``_legacy_tp_kernel_guard`` (a work-around for jax 0.4.x's
partial-manual regions) has no counterpart.

The round runtime (``make_dist_round``, ``make_dist_multiround``) runs a
sync round, or a window of them, as one program: a CUDA graph on the
card in a world of one whose collectives are device work
(:func:`round_fused`), else the per-step composition (always above one
model rank).

``partial=True`` takes a per-step participation mask (fleet scenarios,
``core/scenarios.py``): a worker whose bit is False transmits nothing,
keeps its error memory and its half-step iterate, and its master
*view* (carried in the state) stays on the copy it last received.
``downlink=`` compresses the server→worker channel against a server
memory for each worker (the rank's ``down_memory``); ``zero1=True``
keeps a slice of each master leaf on each rank (ZeRO-1), gathered at
the sync.

The fault runtime (``make_dist_fault_steps``, ``make_dist_fault_round``;
DESIGN.md §9) executes staleness, crashes and drops: every rank replays
the whole fleet's queue tags on the host from the deterministic fault
rows (``engine.plan_fault_step``), a crashed worker's rank keeps joining
every collective with a zero contribution, and each rank queues only its
own payloads, in place.  It refuses a model axis above 1
(``sharding.specs.PendingPort`` naming its ROADMAP item, 12e).
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
from repro_torch.sharding.specs import (PendingPort, ShardLayout,
                                       gather_leaf, is_spec)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

WIRES = ("dense_psum", "sparse_allgather")


class DistQsparseState(NamedTuple):
    """One rank's view of the distributed state: the master (whole, or
    this rank's ZeRO-1 slices) and its own worker's iterate, error memory
    and optimizer state.  ``step`` and ``rounds`` are host counters;
    ``bits`` / ``bits_down`` are float32 ledgers summed over all workers
    (every rank holds the same totals)."""

    master: Any
    local: Any
    memory: Any
    inner: Any
    step: int
    bits: torch.Tensor        # uplink wire bits (worker -> server)
    rounds: int
    bits_down: torch.Tensor   # server -> worker
    # the master copy this worker last received (partial participation,
    # a compressed downlink and the fault runtime; None otherwise)
    view: Any = None
    # the server's downlink error memory for this worker (a compressed
    # downlink only)
    down_memory: Any = None
    # the fault runtime's queue of this worker's in-flight payloads
    # (DESIGN.md §9), written in place: on dense_psum a master-shaped
    # tree of float32 [depth, ...] buffers; on sparse_allgather a tuple
    # with, per leaf, the compact (idx [depth, ..., kcap] at the
    # out-of-row sentinel, val float32) pair, or a float32 [depth, ...]
    # buffer where the leaf's payload is dense.  ``arrive_at`` / its
    # staleness ``inflight_tau`` are the whole fleet's host tags (int32
    # [R, depth], -1 = empty), the same on every rank.
    inflight: Any = None
    arrive_at: Optional[np.ndarray] = None
    inflight_tau: Optional[np.ndarray] = None


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


def _axis_bits(n: int, nrows: int, cnt: torch.Tensor, sign: bool,
               total=None):
    """``repro``'s ledger for axis Top_k: one 32-bit field per row plus
    the counted survivors (the counted helper already holds one field).
    ``total``: ``(nrows, survivors) -> (nrows, survivors)`` over the
    whole leaf, where this rank holds some of its rows
    (:meth:`ModelShards.total`)."""
    counted = (bitlib.bits_signtopk_counted if sign
               else bitlib.bits_topk_counted)
    dev = cnt.device
    nnz = cnt.sum()
    if total is not None:
        nrows, nnz = total(nrows, nnz)
    return (bitlib.f32(32 * nrows, dev) + counted(n, nnz)
            - bitlib.f32(32, dev))


def axis_topk_compact(x: torch.Tensor, k_frac: float, axis: int,
                      sign_bits: bool = False, dispatch_cfg=None,
                      total=None):
    """Top_k along ``axis`` in compact form (DESIGN.md §3.3).

    Returns (idx [..., kcap] int32, val [..., kcap] float32, mem — the
    fused error memory in ``x``'s layout, float32 —, wire_bits,
    moved_shape): idx / val on the moved-to-last layout, indices
    row-local, empty slots (n, 0).  ``dispatch.compact_rows`` runs the
    ``topk_compact`` kernel where it is eligible, else its plain version.
    ``total`` as :func:`_axis_bits`'s.
    """
    n = x.shape[axis]
    k = resolve_k(k_frac, n)
    kcap = dsp.capacity(k, n)
    xm, rows = _axis_rows(x, axis)
    idx, val, mem, cnt = dsp.compact_rows(
        rows, k, kcap, sign=sign_bits, cfg=dispatch_cfg,
        leaf_size=x.numel())
    bits = _axis_bits(n, rows.shape[0], cnt, sign_bits, total)
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
                         sign_bits: bool, select, total=None):
    """Dense Top_k along ``axis``: move it last, shape [rows, n], run
    ``select(rows, k, sign) -> (sel, mem, cnt)`` (the kernel or its plain
    version), move back, charge the counted bits."""
    n = x.shape[axis]
    k = resolve_k(k_frac, n)
    xm, rows = _axis_rows(x, axis)
    sel, _mem, cnt = select(rows, k, sign_bits)
    out = torch.movedim(sel.reshape(xm.shape), -1, axis)
    return out, _axis_bits(n, rows.shape[0], cnt, sign_bits, total)


def axis_topk(x: torch.Tensor, k_frac: float, axis: int,
              sign_bits: bool = False, total=None):
    """Dense Top_k along ``axis`` by the bisection threshold
    (``ref.topk_compress_ref``; exact-k generically, DESIGN.md §3.1)."""
    return _threshold_axis_topk(
        x, k_frac, axis, sign_bits,
        lambda rows, k, sign: ref.topk_compress_ref(rows, k, sign=sign),
        total)


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """A rank's model shards as the compressor sees them: where the model
    group splits each leaf (``layout``, from the whole tree) and the mesh
    whose ``model`` group joins the slices.  Leaf i is, for a plan:

    * ``"local"``: whole on every rank of the group (the group computes
      it alike and counts it once);
    * ``"rows"``: split on an axis the compression does not run along:
      each rank compresses its own rows, and :meth:`total` sums the
      rows' counts over the group;
    * ``"whole"``: split on the axis the compression runs along, or
      compressed by a reference operator (whose norms and draws span the
      leaf): gathered whole over the group (:meth:`gather`), compressed
      whole, each rank keeping its slice (:meth:`own`)."""

    layout: ShardLayout
    mesh: Any

    def shape(self, i: int) -> tuple:
        return self.layout.shapes[i]

    def mode(self, i: int, plan) -> str:
        ax = self.layout.axes[i]
        if ax is None or plan[0] == "skip":
            return "local"
        if plan[0] == "ref" or plan[3] == ax:
            return "whole"
        return "rows"

    def gather(self, i: int, g: torch.Tensor) -> torch.Tensor:
        return gather_leaf(g, self.layout.axes[i], self.mesh)

    def own(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.layout.own(x, i)

    def total(self, nrows: int, nnz: torch.Tensor) -> tuple:
        """(the leaf's rows, its survivors): the rows split evenly over
        the group; the survivor counts summed as integers."""
        return (nrows * self.layout.size,
                self.mesh.all_reduce_sum(nnz.to(torch.int64).clone(),
                                         over="model"))

    def dense_bits(self) -> float:
        """One exact broadcast of the whole tree (every leaf whole)."""
        return float(sum(bitlib.bits_dense(n)
                         for n in self.layout.numels()))


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
    def _skip(shape: tuple) -> bool:
        """Tiny and scalar leaves transmit dense whatever the plan."""
        return len(shape) == 0 or int(np.prod(shape)) <= 8

    def _leaf_plans(self, leaves, param_specs, shards=None) -> list:
        """What every form (``__call__``, ``compact``, ``leaf_meta``,
        ``launch_plans``) does with each leaf: ("skip",) dense, ("ref",
        op) the reference operator, or ("axis", k_frac, sign, axis, n, k)
        the axis Top_k along ``axis`` (n floats a row, k survivors).
        Decided on the whole leaf's shape (``shards``: a rank's model
        shards hold slices), as ``repro`` decides on the global leaf."""
        specs = self._leaf_specs(param_specs, len(leaves))
        out = []
        for i, (g, spec, plan) in enumerate(zip(
                leaves, specs, self._plans(len(leaves)))):
            shape = tuple(g.shape) if shards is None else shards.shape(i)
            if plan[0] == "skip" or self._skip(shape):
                out.append(("skip",))
            elif plan[0] == "ref":
                out.append(plan)
            else:
                ax = _pick_axis(shape, spec)
                n = shape[ax]
                out.append(plan + (ax, n, resolve_k(plan[1], n)))
        return out

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

    def _kernel_leaf(self, g, k_frac, ax, sign, total=None):
        """``axis_topk`` through the ``topk_compress`` kernel."""
        cfg = self._dispatch_cfg()
        return _threshold_axis_topk(
            g, k_frac, ax, sign,
            lambda rows, k, sign_: dsp.topk_rows(rows, k, sign=sign_,
                                                 cfg=cfg), total)

    @staticmethod
    def _leaf_specs(param_specs, n: int) -> list:
        if param_specs is None:
            return [None] * n
        return tree_leaves(param_specs, is_leaf=is_spec)

    @staticmethod
    def _leaf_form(i: int, g, plan, shards):
        """(the tensor leaf i compresses, the survivor-count total, the
        slice back): the rank's own ``g``, or the leaf gathered whole
        (:class:`ModelShards`)."""
        if shards is None:
            return g, None, None
        mode = shards.mode(i, plan)
        if mode == "whole":
            return shards.gather(i, g), None, lambda x: shards.own(i, x)
        return g, (shards.total if mode == "rows" else None), None

    @staticmethod
    def _dense_leaf_bits(g, i: int, shards) -> torch.Tensor:
        n = g.numel() if shards is None else int(np.prod(shards.shape(i)))
        return bitlib.f32(bitlib.bits_dense(n), g.device)

    def __call__(self, grads, param_specs, rng=None, shards=None):
        """Dense form: (compressed tree in float32, total wire bits).
        ``shards``: the rank's :class:`ModelShards` (None: whole
        leaves)."""
        dcfg = self._dispatch_cfg()
        leaves, tspec = tree_flatten(grads)
        outs, bit_terms = [], []
        for i, (g, plan) in enumerate(zip(
                leaves, self._leaf_plans(leaves, param_specs, shards))):
            if plan[0] == "skip":
                outs.append(g.to(torch.float32))
                bit_terms.append(self._dense_leaf_bits(g, i, shards))
                continue
            x, total, own = self._leaf_form(i, g, plan, shards)
            if plan[0] == "ref":
                o, b = self._ref_leaf(plan[1], x, rng, i)
            else:
                _, k_frac, sign, ax, n, _k = plan
                if dsp.rows_eligible(n, dcfg, leaf_size=x.numel(),
                                     device=x.device):
                    o, b = self._kernel_leaf(x, k_frac, ax, sign, total)
                else:
                    o, b = axis_topk(x, k_frac, ax, sign_bits=sign,
                                     total=total)
            outs.append(o if own is None else own(o))
            bit_terms.append(b)
        return tree_unflatten(tspec, outs), bitlib.ledger_sum(bit_terms)

    def compact(self, grads, param_specs, rng=None, shards=None):
        """Compact wire form: per leaf ("dense", g) for skipped and
        reference-operator leaves (the latter carry the compressed
        payload) or ("sparse", idx, val, axis, moved_shape), indices
        row-local to the moved-to-last axis, empty slots (n, 0).  The
        fused error memories come along, so the sync never densifies a
        worker's own payload.  ``shards`` as :meth:`__call__`'s; a leaf
        compressed whole carries a sixth element, the function that
        takes the rank's slice of its decoded whole (:func:`_decoded`).

        Returns (payloads, tree spec, wire_bits, memory tree).
        """
        dcfg = self._dispatch_cfg()
        leaves, tspec = tree_flatten(grads)
        payloads, bit_terms, mems = [], [], []
        for i, (g, plan) in enumerate(zip(
                leaves, self._leaf_plans(leaves, param_specs, shards))):
            if plan[0] == "skip":
                g32 = g.to(torch.float32)
                payloads.append(("dense", g32))
                mems.append(torch.zeros_like(g32))
                bit_terms.append(self._dense_leaf_bits(g, i, shards))
                continue
            x, total, own = self._leaf_form(i, g, plan, shards)
            if plan[0] == "ref":
                q, b = self._ref_leaf(plan[1], x, rng, i)
                if own is not None:
                    q = own(q)
                payloads.append(("dense", q))
                mems.append(g.to(torch.float32) - q)
                bit_terms.append(b)
                continue
            _, k_frac, sign, ax, _n, _k = plan
            idx, val, mem, b, moved = axis_topk_compact(
                x, k_frac, ax, sign_bits=sign, dispatch_cfg=dcfg,
                total=total)
            if own is None:
                payloads.append(("sparse", idx, val, ax, moved))
                mems.append(mem)
            else:
                payloads.append(("sparse", idx, val, ax, moved, own))
                mems.append(own(mem).clone())
            bit_terms.append(b)
        return (payloads, tspec, bitlib.ledger_sum(bit_terms),
                tree_unflatten(tspec, mems))

    def launch_plans(self, params, param_specs, *,
                     compact: bool, shards=None) -> list:
        """The kernel launches this compressor makes on one rank's
        gradients shaped like ``params``, as ``autotune.ShapeKey`` rows
        (the launcher's tuning work list): one a Top_k-family leaf that
        the dispatch rule sends to the kernel, its rows along the chosen
        axis; ``topk_compact`` on the sparse wire (``compact``), else
        ``topk_compress``.  ``shards``: ``params`` are a rank's model
        shards, whose own rows it compresses (a leaf compressed whole:
        all of them)."""
        from repro_torch.kernels.autotune import ShapeKey
        dcfg = self._dispatch_cfg()
        leaves = tree_leaves(params)
        keys = []
        for i, (g, plan) in enumerate(zip(
                leaves, self._leaf_plans(leaves, param_specs, shards))):
            if plan[0] != "axis":
                continue
            _, _k_frac, sign, _ax, n, k = plan
            size = (g.numel() if shards is None
                    or shards.mode(i, plan) != "whole"
                    else int(np.prod(shards.shape(i))))
            if compact:
                ok = dsp.compact_rows_eligible(n, dsp.capacity(k, n), dcfg,
                                               size, g.device)
            else:
                ok = dsp.rows_eligible(n, dcfg, size, g.device)
            key = ShapeKey("topk_compact" if compact else "topk_compress",
                           size // n, n, k, sign)
            if ok and key not in keys:
                keys.append(key)
        return keys

    def leaf_meta(self, master_tree, param_specs) -> list:
        """Payload kind per leaf, as :meth:`compact` decides it:
        ("sparse", axis, moved_shape) or ("dense", None, None)."""
        leaves = tree_leaves(master_tree)
        meta = []
        for g, plan in zip(leaves, self._leaf_plans(leaves, param_specs)):
            if plan[0] != "axis":
                meta.append(("dense", None, None))
                continue
            ax = plan[3]
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


def _check_mesh(mesh, data_axes) -> tuple:
    """(data axes, R): the mesh the engine runs on, R workers over the
    data axes, each the ``model`` axis's M ranks: R * M ranks in all."""
    daxes = tuple(data_axes)
    for a, size in mesh.shape.items():
        if a not in daxes and a != "model" and size > 1:
            raise ValueError(f"mesh axis {a!r} of size {size} is neither a "
                             f"data axis {daxes} nor 'model'")
    R = worker_count(mesh, daxes)
    M = mesh.shape.get("model", 1)
    if R * M != mesh.world_size:
        raise ValueError(f"{R} workers of {M} ranks on the mesh but a "
                         f"world of {mesh.world_size} ranks")
    return daxes, R


def model_shards(mesh, layout: Optional[ShardLayout]):
    """The engine's :class:`ModelShards` on ``mesh``: None for a model
    axis of 1; above it the ``layout`` of the whole parameters
    (``sharding.specs.shard_layout``) is required."""
    if mesh.shape.get("model", 1) == 1:
        return None
    if layout is None:
        raise ValueError(
            f"a model axis of {mesh.shape['model']} needs layout= (the "
            "whole parameters' sharding.specs.shard_layout): each rank "
            "holds its model shard")
    return ModelShards(layout, mesh)


def _zero1_axis(shape, spec, W: int):
    """ZeRO-1 shard axis of a leaf (``repro``'s rule): the first axis
    that divides by the worker count and is unsharded in the spec; None
    when no axis qualifies (the leaf stays whole on every rank)."""
    entries = (list(spec) + [None] * len(shape)) if spec is not None \
        else [None] * len(shape)
    for ax, n in enumerate(shape):
        if entries[ax] is None and n % W == 0 and n >= W:
            return ax
    return None


def _zero1_axes(full_tree, param_specs, W: int) -> list:
    """Per leaf of a whole (full-shape) tree: its ZeRO-1 axis or None."""
    leaves = tree_leaves(full_tree)
    specs = ShardCompressor._leaf_specs(param_specs, len(leaves))
    return [_zero1_axis(tuple(x.shape), sp, W)
            for x, sp in zip(leaves, specs)]


def _own_slices(full_tree, axes, mesh):
    """This worker's slice of each leaf along its ZeRO-1 axis (a copy,
    so the whole leaf can go); leaves without an axis stay whole."""
    W, r = mesh.workers, mesh.worker

    def one(x, ax):
        if ax is None or W == 1:
            return x
        n = x.shape[ax] // W
        return x.narrow(ax, r * n, n).clone()

    leaves, spec = tree_flatten(full_tree)
    return tree_unflatten(spec, [one(x, ax) for x, ax in zip(leaves, axes)])


def _gather_slices(tree, axes, mesh):
    """The whole leaves back from every worker's ZeRO-1 slices: one
    ``all_gather`` over the data group a sharded leaf, concatenated
    along its axis."""
    def one(x, ax):
        if ax is None or mesh.workers == 1:
            return x
        return torch.cat(mesh.all_gather(x).unbind(0), dim=ax)

    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [one(x, ax) for x, ax in zip(leaves, axes)])


def gather_master(state: DistQsparseState, mesh, param_specs=None,
                  layout: Optional[ShardLayout] = None):
    """The whole master of a state on every rank: a ZeRO-1 master (its
    leaves shorter than the worker's iterate along their axis) gathered
    from the workers' slices over the data group, then (``layout``,
    above one model rank) the model shards over the model group, else
    the master as it is.  Every rank must call it (the gathers are
    collectives)."""
    masters, full = tree_leaves(state.master), tree_leaves(state.local)
    axes = [None if tuple(m.shape) == tuple(f.shape) else ax
            for m, f, ax in zip(masters, full, _zero1_axes(
                state.local, param_specs, mesh.workers))]
    master = _gather_slices(state.master, axes, mesh)
    if layout is None or mesh.shape.get("model", 1) == 1:
        return master
    from repro_torch.sharding.specs import gather_tree
    return gather_tree(master, layout, mesh)


def _decode_gathered(idx_all, val_all, moved, ax):
    """Every gathered worker's (idx, val) slots of a leaf ([N, ...,
    kcap]: N the workers, or workers times queue slots) decoded and
    summed in one scatter-add: the indices are row-local and the same
    rows of every worker decode together (sentinel slots drop)."""
    N, kcap = idx_all.shape[0], idx_all.shape[-1]
    ii = torch.movedim(idx_all, 0, -2).reshape(-1, N * kcap)
    ss = torch.movedim(val_all, 0, -2).reshape(-1, N * kcap)
    dense = _densify(ii, ss, moved, ax)
    return dense, ii, ss


def _decoded(pl, dense: torch.Tensor) -> torch.Tensor:
    """A sparse payload's decoded mean as this rank holds it: the rank's
    slice where the leaf was compressed whole (the payload's sixth
    element, ``ShardCompressor.compact``), else as it is."""
    return pl[5](dense) if len(pl) > 5 else dense


def _apply_mean(master, means):
    return tree_map(lambda x, gg: (x.to(torch.float32) - gg).to(x.dtype),
                    master, means)


def _make_local(grad_fn: Callable, inner_opt: GradientTransform):
    """The worker's local step (Algorithm 1 lines 5-7) from an iterate
    and an inner state: (half-step iterate, inner state, loss)."""

    def local(params, inner, batch, lr, scalars):
        loss, grads = grad_fn(params, batch)
        updates, inner_new = _inner_update(inner_opt, grads, inner, params,
                                           lr, scalars)
        return apply_updates(params, updates), inner_new, loss

    return local


def _validate(aggregate: str, wire: str) -> tuple:
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
    return aggregate, wire


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
    layout: Optional[ShardLayout] = None,
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

    ``downlink``: the server→worker channel (DESIGN.md §5).  Compressed,
    the server keeps an error memory for each worker (the rank's
    ``down_memory``) and sends it the compressed ``down_memory +
    x̄_{t+1} − view``; the worker's ``view`` (and iterate) advances by the
    decompressed q, the uplink compresses against that view, and
    ``bits_down`` charges the downlink's counted bits.  On the sparse
    wire each rank decodes only its own q.  None / identity: the exact
    broadcast, its dense cost charged.

    ``zero1``: each rank keeps only its slice of each master leaf along
    the leaf's ZeRO-1 axis (:func:`_zero1_axis`; a leaf with none stays
    whole); the sync gathers the whole master, computes as without, and
    keeps its own slice of the new one.  The local step never reads the
    master.

    ``layout``: above one model rank, where the model group splits each
    leaf of the whole parameters (``sharding.specs.shard_layout``).  The
    state and the batches' gradients are then the rank's model shards
    (``grad_fn`` runs the model's own collectives over the model group),
    each leaf is compressed per shard (:class:`ModelShards`), and the
    wires, the means and ZeRO-1's slices run over the data group.  The
    ledgers are the whole workers'.
    """
    aggregate, wire = _validate(aggregate, wire)
    daxes, R = _check_mesh(mesh, data_axes)
    shards = model_shards(mesh, layout)
    if compressor is None:
        compressor = ShardCompressor("none")
    up = chn.ShardChannel(compressor, "uplink")
    down = chn.ShardChannel(downlink, "downlink")
    down_active = not down.is_identity()
    # partial participation needs each worker's lagging master view even
    # without a compressed downlink (non-syncers fall behind the master)
    carry_view = down_active or partial
    _local_fn = _make_local(grad_fn, inner_opt)

    def _local(state: DistQsparseState, batch, lr, scalars):
        return _local_fn(state.local, state.inner, batch, lr, scalars)

    def local_at(state: DistQsparseState, batch, rng, lr, scalars=None):
        half, inner_new, loss = _local(state, batch, lr, scalars)
        return state._replace(local=half, inner=inner_new,
                              step=state.step + 1), mesh.mean(loss)

    def _z1(state):
        """Per master leaf: its ZeRO-1 axis (None: whole), from the
        worker's full-shape iterate."""
        if not zero1:
            return [None] * len(tree_leaves(state.master))
        return _zero1_axes(state.local, param_specs, R)

    def _delta(state, full_master, half):
        # f32 error-compensated accumulator m + x - x̂, repro's cast order;
        # against the worker's lagging view where it carries one
        ref = state.view if carry_view else full_master
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
        return bool(m[mesh.worker]), int(m.sum())

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

    def _down_q(dacc, rng):
        """The downlink's (q, new server memory, bits) of this worker: the
        dense form on ``dense_psum``; on ``sparse_allgather`` the compact
        form, decoded here (only this worker's q: no gather)."""
        if wire == "dense_psum":
            return down.apply(dacc, param_specs, rng=rng, shards=shards)
        payloads, spec, dbits, new_dm = down.compact(dacc, param_specs,
                                                     rng=rng, shards=shards)
        q = [pl[1] if pl[0] == "dense" else _decoded(
            pl, _densify(pl[1], pl[2], pl[4], pl[3])) for pl in payloads]
        return tree_unflatten(spec, q), new_dm, dbits

    def _dense_bits(tree) -> float:
        """One exact broadcast of the whole master."""
        return (down.dense_bits(tree) if shards is None
                else shards.dense_bits())

    def _finish(state, half, new_full, axes, inner_new, memory, wire_bits,
                loss, syncs: bool, n_sync: int, rng):
        """The sync's new state from the new whole master: the exact
        broadcast or the compressed downlink to the syncing workers, the
        ledgers, this rank's master slice (ZeRO-1)."""
        dev = state.bits.device
        master = _own_slices(new_full, axes, mesh)
        bits = state.bits + mesh.all_reduce_sum(
            wire_bits if syncs else torch.zeros_like(wire_bits))
        rounds = state.rounds + (int(n_sync > 0) if partial else 1)
        memory = memory if syncs else state.memory
        if down_active:
            # error-compensated compression of the master delta against
            # the server's memory for this worker (every rank compresses:
            # the ranks stay in step on the shared generator)
            dacc = tree_map(lambda d, nm, v: d + nm.to(torch.float32)
                            - v.to(torch.float32),
                            state.down_memory, new_full, state.view)
            q, new_dm, dbits = _down_q(dacc, rng)
            del dacc
            if syncs:
                view = tree_map(
                    lambda v, qq: (v.to(torch.float32) + qq).to(v.dtype),
                    state.view, q)
            else:
                view, new_dm = state.view, state.down_memory
                dbits = torch.zeros_like(dbits)
            del q
            return DistQsparseState(
                master=master, local=view if syncs else half,
                memory=memory, inner=inner_new, step=state.step + 1,
                bits=bits, rounds=rounds,
                bits_down=state.bits_down + mesh.all_reduce_sum(dbits),
                view=view, down_memory=new_dm), mesh.mean(loss)
        if not partial:
            return DistQsparseState(
                master=master,
                local=new_full,             # the exact broadcast
                memory=memory, inner=inner_new, step=state.step + 1,
                bits=bits, rounds=rounds,
                bits_down=state.bits_down + bitlib.f32(
                    R * _dense_bits(new_full), dev)), mesh.mean(loss)
        # only the syncing workers receive x̄_{t+1}; the others keep their
        # half-step iterate and their view
        return DistQsparseState(
            master=master,
            local=new_full if syncs else half,
            memory=memory, inner=inner_new, step=state.step + 1,
            bits=bits, rounds=rounds,
            bits_down=state.bits_down + bitlib.f32(
                np.float32(n_sync) * np.float32(
                    _dense_bits(new_full)), dev),
            view=new_full if syncs else state.view), mesh.mean(loss)

    def sync_dense_at(state: DistQsparseState, batch, rng, lr,
                      scalars=None, mask=None):
        syncs, n_sync = _mask(mask)
        half, inner_new, loss = _local(state, batch, lr, scalars)
        axes = _z1(state)
        full = _gather_slices(state.master, axes, mesh)
        delta = _delta(state, full, half)
        if not partial:
            half = None          # freed before the compression
        g, new_mem, wire_bits = up.apply(delta, param_specs, rng=rng,
                                         shards=shards)
        del delta
        if not syncs:
            g = tree_map(torch.zeros_like, g)     # transmits nothing
        new_full = _apply_mean(full, tree_map(
            lambda gg: _dense_mean(gg, n_sync), g))
        del g, full
        return _finish(state, half, new_full, axes, inner_new, new_mem,
                       wire_bits, loss, syncs, n_sync, rng)

    def _sparse_mean(pl, n_sync: int):
        """One leaf's mean over the W workers' gathered payloads."""
        if pl[0] == "dense":
            arr = mesh.all_gather(pl[1])                  # [W, ...]
            if aggregate == "support_weighted":
                cnt = (arr != 0).to(torch.float32).sum(dim=0)
                return arr.sum(dim=0) / torch.clamp(cnt, min=1.0)
            return arr.sum(dim=0) / (_divisor(n_sync) if partial
                                     else arr.shape[0])
        _, idx, sel, ax, moved = pl[:5]
        # all W workers' slots of a row decode in one scatter-add
        dense, ii, ss = _decode_gathered(mesh.all_gather(idx),
                                         mesh.all_gather(sel), moved, ax)
        if aggregate == "support_weighted":
            cnt = _densify(ii, (ss != 0).to(torch.float32), moved, ax)
            return _decoded(pl, dense / torch.clamp(cnt, min=1.0))
        return _decoded(pl, dense / (_divisor(n_sync) if partial else R))

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
        axes = _z1(state)
        full = _gather_slices(state.master, axes, mesh)
        delta = _delta(state, full, half)
        if not partial:
            half = None          # freed before the compression
        payloads, _, wire_bits, new_mem = compressor.compact(
            delta, param_specs, rng=rng, shards=shards)
        del delta
        if not syncs:
            payloads = [_silent(pl) for pl in payloads]
        means = [_sparse_mean(pl, n_sync) for pl in payloads]
        del payloads
        _, mspec = tree_flatten(full)
        new_full = _apply_mean(full, tree_unflatten(mspec, means))
        del means, full
        return _finish(state, half, new_full, axes, inner_new, new_mem,
                       wire_bits, loss, syncs, n_sync, rng)

    sync_at = (sync_sparse_at if wire == "sparse_allgather"
               else sync_dense_at)

    def init_fn(params) -> DistQsparseState:
        """``params`` are the same on every rank of a data group (the
        replicated master: the rank's model shards above one model
        rank); under ``zero1`` each worker keeps its slice of it."""
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        axes = (_zero1_axes(params, param_specs, R) if zero1
                else [None] * len(leaves))
        return DistQsparseState(
            master=_own_slices(params, axes, mesh), local=params,
            memory=tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params),
            inner=inner_opt.init(params), step=0,
            bits=torch.zeros((), dtype=torch.float32, device=dev),
            rounds=0,
            bits_down=torch.zeros((), dtype=torch.float32, device=dev),
            # every worker's first view is the initial master
            view=params if carry_view else None,
            # the server's downlink memory for this worker starts at zero
            down_memory=down.init_memory(params) if down_active else None)

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
    cards hung (PERF.md §6).  Both take the per-step composition, as does
    every mesh above one model rank (the model's own collectives run
    inside each step).  Decided from the mesh, before anything runs."""
    if mesh.shape.get("model", 1) > 1:
        return False
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


# ---------------------------------------------------------------------------
# the fault runtime (DESIGN.md §9)
# ---------------------------------------------------------------------------


def refuse_faults_model_axis(size: int) -> None:
    """The fault runtime refuses a model axis above 1 (ROADMAP queue 1
    item 12e): its queue, recover and landing paths hold whole leaves."""
    if size > 1:
        raise PendingPort(
            f"the mesh fault runtime with a model axis of {size} is not "
            "ported (ROADMAP queue 1 item 12e)")


def _make_dist_fault_parts(grad_fn: Callable, inner_opt: GradientTransform,
                           compressor: Optional[ShardCompressor], mesh,
                           data_axes, param_specs, *, queue_depth: int,
                           aggregate: str, wire: str, staleness_weight: str,
                           downlink=None, zero1: bool = False):
    """(init_fn, step_at, check, plan_kw) of the mesh fault runtime:
    ``step_at(state, batch, plan, rng, lr, scalars=None) -> (state, loss)``
    runs one step's :class:`~repro_torch.core.engine.FaultPlan` (the
    fleet's, the same on every rank) for this rank's worker and leaves
    the queue's host tags as they are; ``plan_kw`` are the planner's
    keywords."""
    from repro_torch.core import scenarios as scn
    aggregate, wire = _validate(aggregate, wire)
    scn.validate_staleness_weight(staleness_weight)
    if queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    if zero1:
        raise ValueError(
            "zero1 master sharding is not supported under faults: the "
            "recover phase re-initializes workers from the full master "
            "inside the manual region (gather-free); run faults with "
            "zero1=False")
    if downlink is not None and not chn.ShardChannel(
            downlink, "downlink").is_identity():
        raise ValueError(
            "a compressed downlink is not supported under faults on the "
            "mesh engine; use the single-host engine "
            "(engine.make_fault_step) for compressed-downlink fault "
            "studies, or downlink=None here")
    _, R = _check_mesh(mesh, data_axes)
    refuse_faults_model_axis(mesh.shape.get("model", 1))
    if compressor is None:
        compressor = ShardCompressor("none")
    up = chn.ShardChannel(compressor, "uplink")
    down = chn.ShardChannel(None, "downlink")
    Dq = int(queue_depth)
    me = mesh.rank
    sparse = wire == "sparse_allgather"
    local_fn = _make_local(grad_fn, inner_opt)

    def _queue_leaves(queue) -> list:
        """Per master leaf: its queue buffer, or its (idx, val) pair."""
        if sparse:
            return list(queue)
        return tree_leaves(queue)

    def _payload_leaves(pay) -> list:
        """Per master leaf: the payload as the queue holds it (a dense
        tensor, or the compact (idx, val) pair)."""
        if not sparse:
            return tree_leaves(pay)
        return [pl[1] if pl[0] == "dense" else (pl[1], pl[2]) for pl in pay]

    def _enqueue(queue, pay, slot: int) -> None:
        """In place: this worker's payload into its slot of the queue."""
        for buf, p in zip(_queue_leaves(queue), _payload_leaves(pay)):
            if isinstance(buf, tuple):
                buf[0][slot].copy_(p[0])
                buf[1][slot].copy_(p[1])
            else:
                buf[slot].copy_(p)

    def _dequeue(queue, slots, meta) -> None:
        """In place: landed slots emptied (idx at the out-of-row
        sentinel, values zero)."""
        for buf, (_kind, _ax, moved) in zip(_queue_leaves(queue), meta):
            for s in slots:
                if isinstance(buf, tuple):
                    buf[0][s].fill_(moved[-1])
                    buf[1][s].zero_()
                else:
                    buf[s].zero_()

    def _divide(tot, cnt, n_arr: int):
        if aggregate == "support_weighted":
            return tot / torch.clamp(cnt, min=1.0)
        if aggregate == "mean_S":
            return tot / float(max(n_arr, 1))
        return tot / R

    def _landing(queue, pay, plan, slots):
        """Per master leaf: this worker's landing payloads in slot order
        (the fresh payload in its slot), weighted."""
        fresh = plan.slot if plan.fresh[me] else None
        w = plan.weight[me]
        pays = None if pay is None else _payload_leaves(pay)
        out = []
        for i, buf in enumerate(_queue_leaves(queue)):
            items = []
            for s in slots:
                if s == fresh:
                    x = pays[i]
                elif isinstance(buf, tuple):
                    x = (buf[0][s], buf[1][s])
                else:
                    x = buf[s]
                if w[s] != np.float32(1.0):
                    x = ((x[0], x[1] * float(w[s])) if isinstance(x, tuple)
                         else x * float(w[s]))
                items.append(x)
            out.append(items)
        return out

    def _land_dense(master, landing, n_arr: int) -> list:
        """dense_psum: each rank sums its landing payloads, one
        ``all_reduce`` a leaf (a rank with none contributes zeros)."""
        means = []
        for ml, items in zip(tree_leaves(master), landing):
            if not items:
                tot = torch.zeros(tuple(ml.shape), dtype=torch.float32,
                                  device=ml.device)
            elif len(items) == 1:
                tot = items[0].clone()      # the queue is never reduced
            else:
                tot = items[0] + items[1]
                for x in items[2:]:
                    tot = tot + x
            cnt = None
            if aggregate == "support_weighted":
                cnt = torch.zeros_like(tot)
                for x in items:
                    cnt = cnt + (x != 0).to(torch.float32)
                cnt = mesh.all_reduce_sum(cnt)
            means.append(_divide(mesh.all_reduce_sum(tot), cnt, n_arr))
        return means

    def _land_sparse(master, landing, n_arr: int, M: int, meta,
                     queue) -> list:
        """sparse_allgather: each rank's landing compact slots, padded to
        the step's most landings on any rank (M, from the host plan),
        gathered once and decoded in one scatter-add a leaf."""
        means = []
        for ml, items, (kind, ax, moved), buf in zip(
                tree_leaves(master), landing, meta, _queue_leaves(queue)):
            if kind == "dense":
                stack = torch.zeros((M,) + tuple(ml.shape),
                                    dtype=torch.float32, device=ml.device)
                for j, x in enumerate(items):
                    stack[j].copy_(x)
                arr = mesh.all_gather(stack).reshape(
                    (-1,) + tuple(ml.shape))            # [W * M, ...]
                cnt = ((arr != 0).to(torch.float32).sum(dim=0)
                       if aggregate == "support_weighted" else None)
                means.append(_divide(arr.sum(dim=0), cnt, n_arr))
                continue
            n, shape = moved[-1], tuple(buf[0].shape[1:])
            idx = torch.full((M,) + shape, n, dtype=torch.int32,
                             device=ml.device)
            val = torch.zeros((M,) + shape, dtype=torch.float32,
                              device=ml.device)
            for j, (ii, vv) in enumerate(items):
                idx[j].copy_(ii)
                val[j].copy_(vv)
            idx_all = mesh.all_gather(idx).reshape((-1,) + shape)
            val_all = mesh.all_gather(val).reshape((-1,) + shape)
            dense, ii, ss = _decode_gathered(idx_all, val_all, moved, ax)
            cnt = (_densify(ii, (ss != 0).to(torch.float32), moved, ax)
                   if aggregate == "support_weighted" else None)
            means.append(_divide(dense, cnt, n_arr))
        return means

    def step_at(state: DistQsparseState, batch, plan, rng, lr,
                scalars=None):
        dev = state.bits.device
        local, view, memory, inner = (state.local, state.view, state.memory,
                                      state.inner)
        if plan.recover[me]:
            # the crash lost the worker's state: it restarts from the
            # current master with no error memory and a fresh optimizer
            local = tree_map(lambda x, l: x.to(l.dtype), state.master, local)
            view = tree_map(lambda x, v: x.to(v.dtype), state.master, view)
            memory = tree_map(torch.zeros_like, memory)
            inner = inner_opt.init(local)
        half, inner_new, loss = local_fn(local, inner, batch, lr, scalars)
        if not plan.alive[me]:
            # a dead worker takes no step: its gradient is computed and
            # discarded (the loss averages all R), as repro's masking does
            half, inner_new = local, inner
        loss = mesh.mean(loss)
        if not plan.event:
            return state._replace(local=half, view=view, memory=memory,
                                  inner=inner_new,
                                  step=state.step + 1), loss
        queue, bits, pay = state.inflight, state.bits, None
        if plan.compute.any():
            # compute-time error feedback: memory and bits advance now;
            # every rank compresses (in step on the wire and the shared
            # generator), the workers that do not compute discard it
            delta = tree_map(lambda m, x, h: m + x.to(torch.float32)
                             - h.to(torch.float32), memory, view, half)
            if sparse:
                pay, _, wire_bits, mem_c = compressor.compact(
                    delta, param_specs, rng=rng)
            else:
                pay, mem_c, wire_bits = up.apply(delta, param_specs, rng=rng)
            del delta
            if plan.compute[me]:
                memory = mem_c
            else:
                wire_bits = torch.zeros_like(wire_bits)
            del mem_c
            bits = bits + mesh.all_reduce_sum(wire_bits)
            if plan.enqueue[me]:
                _enqueue(queue, pay, plan.slot)
        master = state.master
        n_arr = int(plan.arrive.sum())
        if n_arr:
            slots = [int(s) for s in np.flatnonzero(plan.arrive[me])]
            landing = _landing(queue, pay, plan, slots)
            meta = compressor.leaf_meta(master, param_specs)
            if sparse:
                means = _land_sparse(
                    master, landing, n_arr,
                    int(plan.arrive.sum(axis=1).max()), meta, queue)
            else:
                means = _land_dense(master, landing, n_arr)
            del landing, pay
            _, mspec = tree_flatten(master)
            master = _apply_mean(master, tree_unflatten(mspec, means))
            del means
            fresh = plan.slot if plan.fresh[me] else None
            _dequeue(queue, [s for s in slots if s != fresh], meta)
        receive = bool(plan.receive[me])
        n_recv = int(plan.receive.sum())
        bits_down = state.bits_down
        if n_recv:
            bits_down = bits_down + bitlib.f32(
                np.float32(n_recv) * np.float32(down.dense_bits(master)),
                dev)
        return state._replace(
            master=master, local=master if receive else half,
            memory=memory, inner=inner_new,
            view=master if receive else view, step=state.step + 1,
            bits=bits, rounds=state.rounds + plan.inc, bits_down=bits_down,
            inflight=queue), loss

    def check(state: DistQsparseState) -> None:
        if state.inflight is None or state.arrive_at is None:
            raise ValueError(
                "fault steps need the in-flight queue: build the state "
                "with this factory's init_fn")
        if tuple(state.arrive_at.shape) != (R, Dq):
            raise ValueError(
                f"state queue tags {tuple(state.arrive_at.shape)} != "
                f"({R}, {Dq}) these steps were built for")

    def init_fn(params) -> DistQsparseState:
        """``params`` are the same on every rank.  The queue is allocated
        once, at its full depth (each rank holds only its own worker's)."""
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        if sparse:
            bufs = []
            for leaf, (kind, _ax, moved), plan in zip(
                    leaves, compressor.leaf_meta(params, param_specs),
                    compressor._leaf_plans(leaves, param_specs)):
                if kind == "dense":
                    bufs.append(torch.zeros((Dq,) + tuple(leaf.shape),
                                            dtype=torch.float32, device=dev))
                    continue
                n = moved[-1]
                shape = (Dq,) + tuple(moved[:-1]) + (
                    dsp.capacity(plan[5], n),)
                bufs.append((torch.full(shape, n, dtype=torch.int32,
                                        device=dev),
                             torch.zeros(shape, dtype=torch.float32,
                                         device=dev)))
            inflight = tuple(bufs)
        else:
            inflight = tree_map(lambda x: torch.zeros(
                (Dq,) + tuple(x.shape), dtype=torch.float32, device=dev),
                params)
        return DistQsparseState(
            master=params, local=params,
            memory=tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params),
            inner=inner_opt.init(params), step=0,
            bits=torch.zeros((), dtype=torch.float32, device=dev),
            rounds=0,
            bits_down=torch.zeros((), dtype=torch.float32, device=dev),
            view=params, inflight=inflight,
            arrive_at=np.full((R, Dq), -1, np.int32),
            inflight_tau=np.zeros((R, Dq), np.int32))

    # the mesh's ``rounds`` counts landing events (repro: + any landing)
    plan_kw = dict(global_rounds=True, staleness_weight=staleness_weight)
    return init_fn, step_at, check, plan_kw


def make_dist_fault_steps(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    compressor: Optional[ShardCompressor],
    lr_schedule: Callable,
    mesh,
    data_axes: Sequence[str] = ("data",),
    param_specs=None,
    *,
    queue_depth: int,
    aggregate: str = "mean_R",
    wire: str = "dense_psum",
    staleness_weight: str = "uniform",
    downlink: Optional[ShardCompressor] = None,
    zero1: bool = False,
):
    """The mesh engine's counterpart of ``engine.make_fault_step``: the
    executed staleness regime on both wires (``repro``'s
    ``make_dist_fault_steps``).  A payload computed at step t (uplink
    error memory updated and wire bits charged then) waits in this
    worker's bounded queue (``queue_depth`` slots) and lands on the
    master at t + τ; workers crash (state frozen), recover (restart from
    the current master: error memory zeroed, inner state fresh), and
    payloads drop in flight, per the step's ``engine.FaultRow``.

    Returns ``(init_fn, fault_local_step, fault_sync_step)``, both
    ``(state, batch, row, rng=None) -> (state, loss)``: the host drives
    the dispatch from the fault tables (``scenarios.fault_replay``),
    event steps (a scheduled sync row or an arrival) through
    ``fault_sync_step``, the others through ``fault_local_step`` (recover
    and the alive-masked local step; it refuses an event step).

    The whole fleet's queue tags stay on the host, the same on every
    rank: a step's recover / compute / enqueue / land / receive rows come
    from ``engine.plan_fault_step`` (``rounds`` counts landing events), so
    a crashed worker's rank joins every collective with a zero
    contribution.  ``aggregate`` (mean_R: Σ/R; mean_S: by the fleet's
    landing count; support_weighted: by the landing support) and
    ``staleness_weight`` ("uniform", or "damped": 1/(1+τ)) as in the
    single-process engine.  ``dense_psum`` queues the decompressed
    payloads (float32 [depth, ...] a leaf) and all-reduces each rank's
    landing sum; ``sparse_allgather`` queues the compact (idx, val) slots
    and gathers the landing ones once a step, padded to the step's most
    landings on any rank, decoded in one scatter-add: the same ledgers.
    Enqueue and dequeue write the queue in place; a payload that lands
    in the step that computed it skips the queue, so trivial rows are
    :func:`make_dist_steps` bit for bit.  The loss is the mean over all R
    workers, dead ones included; ``bits_down`` charges the exact
    broadcast to each receiving worker.  ``zero1`` and a compressed
    ``downlink`` are refused, as in ``repro``."""
    init_fn, step_at, check, plan_kw = _make_dist_fault_parts(
        grad_fn, inner_opt, compressor, mesh, data_axes, param_specs,
        queue_depth=queue_depth, aggregate=aggregate,
        wire=wire, staleness_weight=staleness_weight, downlink=downlink,
        zero1=zero1)
    from repro_torch.core.engine import plan_fault_step

    def _step(state, batch, row, rng, local_only: bool):
        check(state)
        plan, arrive_at, tau = plan_fault_step(
            state.arrive_at, state.inflight_tau, state.step, row, **plan_kw)
        if local_only and plan.event:
            raise ValueError(
                f"step {state.step} is an event step (a sync or an "
                "arrival): run it through fault_sync_step")
        new, loss = step_at(state, batch, plan, rng,
                            lr_schedule(state.step))
        return new._replace(arrive_at=arrive_at, inflight_tau=tau), loss

    def fault_local_step(state: DistQsparseState, batch, row, rng=None):
        return _step(state, batch, row, rng, True)

    def fault_sync_step(state: DistQsparseState, batch, row, rng=None):
        return _step(state, batch, row, rng, False)

    return init_fn, fault_local_step, fault_sync_step


class DistFaultRounds:
    """The mesh fault runtime's round program: ``self(state, batch_block,
    rows, rng=None) -> (state, losses [L])`` runs one round of L steps
    (``batch_block`` leaves [L, ...] of this rank's batches, ``rows`` the
    round's [L, R] ``engine.FaultRow``), each step the full fault step of
    its host plan.  ``fused``: one ``engine.RoundRunner`` program keyed by
    the round's plans, as ``engine.FaultSuperstep`` (a CUDA graph on the
    card where :func:`round_fused` allows; a round that recovers a worker
    runs directly, its optimizer counts being reset).  Otherwise the
    per-step composition.  Bit for bit the per-step fault steps."""

    def __init__(self, step_at, check, lr_schedule, inner_opt, mesh,
                 plan_kw: dict):
        from repro_torch.core.engine import RoundRunner
        self.step_at, self.check = step_at, check
        self.lr_schedule, self.plan_kw = lr_schedule, plan_kw
        self.rank = mesh.rank
        self.fused = round_fused(mesh)
        # the state's tensors (the queue among them) become the runner's
        # buffers: the queue is not copied
        self.runner = (RoundRunner(step_at, lr_schedule, inner_opt,
                                   per_step_rows=True, adopt=True)
                       if self.fused else None)

    @property
    def captures(self) -> int:
        return 0 if self.runner is None else self.runner.captures

    @property
    def shapes(self) -> int:
        """Round programs made so far (repeating round shapes)."""
        return 0 if self.runner is None else len(self.runner.programs)

    def __call__(self, state: DistQsparseState, batch_block, rows,
                 rng=None):
        from repro_torch.core.engine import _plan_rounds, plan_rows
        self.check(state)
        L = int(tree_leaves(batch_block)[0].shape[0])
        plans, arrive_at, tau = _plan_rounds(state, rows, L, **self.plan_kw)
        if not self.fused:
            dev = state.bits.device
            losses = []
            for i, plan in enumerate(plans):
                batch = tree_map(lambda b: as_tensor(b[i], dev), batch_block)
                state, loss = self.step_at(state, batch, plan, rng,
                                           self.lr_schedule(state.step))
                losses.append(loss)
            return (state._replace(arrive_at=arrive_at, inflight_tau=tau),
                    torch.stack(losses))
        # the tags stay on the host, outside the program's state; the
        # optimizer's count is this rank's column of the plans' rows
        mine = {k: v[:, self.rank] for k, v in plan_rows(plans).items()}
        state, losses, _ = self.runner.run(
            state._replace(arrive_at=None, inflight_tau=None),
            tree_map(lambda x: x[None], batch_block), [tuple(plans)], rng,
            rows=mine, replay=not any(p.recover.any() for p in plans))
        return (state._replace(arrive_at=arrive_at, inflight_tau=tau),
                losses[0])


def make_dist_fault_round(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    compressor: Optional[ShardCompressor],
    lr_schedule: Callable,
    mesh,
    data_axes: Sequence[str] = ("data",),
    param_specs=None,
    *,
    queue_depth: int,
    aggregate: str = "mean_R",
    wire: str = "dense_psum",
    staleness_weight: str = "uniform",
):
    """Round program of the mesh fault runtime (``repro``'s
    ``make_dist_fault_round``): rounds close at every event step
    (``rounds.compile_fault_rounds``).  Returns ``(init_fn, round_fn,
    fused)``, ``round_fn`` a :class:`DistFaultRounds`: ``(state,
    batch_block, row_block, rng=None) -> (state, losses [L])`` with
    ``row_block`` the round's [L, R] rows (``engine.index_rows(rows,
    slice(start, stop))``).  Bit for bit :func:`make_dist_fault_steps`;
    the state is donated (its tensors become the program's buffers)."""
    init_fn, step_at, check, plan_kw = _make_dist_fault_parts(
        grad_fn, inner_opt, compressor, mesh, data_axes, param_specs,
        queue_depth=queue_depth, aggregate=aggregate,
        wire=wire, staleness_weight=staleness_weight)
    program = DistFaultRounds(step_at, check, lr_schedule, inner_opt, mesh,
                              plan_kw)
    return init_fn, program, program.fused
