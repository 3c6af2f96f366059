"""Unified Qsparse-local-SGD engine (paper Algorithms 1 and 2 as one
state machine; DESIGN.md §1).  A port of ``repro.core.engine``'s
per-step path (``init``, ``make_step``, ``run``) and round runtime.

One step function over the per-worker sync mask s ∈ {0,1}^R with
per-worker master views x_t^{(r)}:

  x̂_{t+1/2}^{(r)} = x̂_t^{(r)} - eta_t d_t^{(r)}            (local phase)
  r with s_r = 0:  keep (x^{(r)}, m^{(r)});  x̂_{t+1}^{(r)} = x̂_{t+1/2}^{(r)}
  r with s_r = 1:  g_t^{(r)} = QComp_k(m_t^{(r)} + x_t^{(r)} - x̂_{t+1/2}^{(r)})
                   m_{t+1}^{(r)} = m_t^{(r)} + x_t^{(r)} - x̂_{t+1/2}^{(r)} - g
  master:          x̄_{t+1} = x̄_t - (1/R) Σ_{r: s_r} g_t^{(r)}
  r with s_r = 1:  x_{t+1}^{(r)} = x̂_{t+1}^{(r)} = x̄_{t+1}       (broadcast)

with an optional compressed downlink (error-compensated broadcast of
the master delta, server-side memory md^{(r)}); see ``repro``'s module
docstring for the full statement.

How the port differs from ``repro`` in form, not in math:

* the worker axis is a leading ``[R, ...]`` dimension of every
  per-worker tensor (``repro`` vmaps); the local phase runs ``grad_fn``
  worker by worker and steps the inner optimizer on all workers at
  once;
* the sync mask is numpy on the host, so a step with no syncing worker
  skips the sync phase with a Python ``if`` (``repro``'s ``lax.cond``),
  and the sync phase compresses the syncing workers only — all of them
  through one launch per kernel bucket (``channel_compress_tree``,
  ``batched=True``); non-syncing workers transmit nothing and keep
  their state, as ``repro``'s masking does;
* the state is updated out of place, like ``repro``'s: a new
  ``EngineState`` per step (the old one stays valid);
* randomness is a ``torch.Generator`` (or a ``Uniforms`` feed), used by
  the stochastic operators only;
* ``step`` and ``rounds`` are Python ints; ``bits`` / ``bits_down`` are
  float32 scalar tensors on the state's device.

The per-leaf-group ledger (``leaf_ledger``) charges each top-level
parameter group (``leaf_group_names``) its own [G] float32 vector per
direction, folded as ``repro`` folds it: per syncing worker the group's
leaves in flatten order, then the workers in order.  The Algorithm 1 /
2 wrappers (``core/qsparse.py``, ``core/async_qsparse.py``) drive this
engine.

The round runtime (``make_superstep``, ``run_rounds``, ``make_multiround``,
``run_rounds_overlap``) runs each sync round, L - 1 local steps and the
step with the sync phase, as one program: a CUDA graph per round shape
on the card (:class:`RoundRunner`), the counterpart of ``repro``'s
scanned, donated round program.  It takes the step's learning rate (and
an optimizer's step scalars) from static buffers instead of the host, so
a graph replays each step's own values.

The staleness-first fault runtime (``make_fault_step``,
``make_fault_superstep``, ``run_faults``, ``run_fault_rounds``; DESIGN.md
§9) splits a sync into a compute time and an apply time: payloads wait
in a per-worker in-flight queue (``init(..., queue_depth=)``), workers
crash and recover, payloads are lost in flight.  The queue's values
(``inflight``) live on the device; its arrival steps and staleness tags
(``arrive_at``, ``inflight_tau``, int32 [R, depth]) stay on the host,
as ``step`` and ``rounds`` do: every value in them follows from the
host's fault rows, so which rows recover, compute, arrive and receive
is decided on the host (:func:`plan_fault_step`) before the device
works, and a fault round is keyed by those decisions.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bits as bitlib, channel as chn
from repro_torch.core import policy as pol, rounds as rnd
from repro_torch.core import scenarios as scn
from repro_torch.core.scenarios import AGGREGATES
from repro_torch.core.operators import CompressionOp, Uniforms
from repro_torch.device import as_tensor, resolve_device
from repro_torch.graphs import CudaGraph
from repro_torch.kernels import dispatch as dsp
from repro_torch.optim.transforms import GradientTransform, apply_updates
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


class EngineState(NamedTuple):
    master: Any           # x̄_t — the true master parameters
    master_view: Any      # x_t^{(r)}: last master copy worker r received [R]
    local: Any            # x̂_t^{(r)} [R]
    memory: Any           # m_t^{(r)} uplink error-feedback memory [R]
    inner: Any            # inner-optimizer state, all workers [R]
    step: int             # global clock t
    bits: torch.Tensor    # float32 cumulative UPLINK wire bits (Σ workers)
    rounds: int           # see ``global_rounds`` in make_step
    # server-side per-worker downlink error memory md^{(r)} [R] — None
    # unless a compressed downlink is configured (init(..., downlink=op))
    down_memory: Any = None
    bits_down: Optional[torch.Tensor] = None  # cumulative DOWNLINK bits
    # per-leaf-group ledgers: cumulative wire bits per top-level
    # parameter group, float32 [G] per direction (group names from
    # ``leaf_group_names``) — None unless built with leaf_ledger=True
    leaf_bits: Optional[torch.Tensor] = None
    leaf_bits_down: Optional[torch.Tensor] = None
    # the fault runtime's in-flight payload queue (DESIGN.md §9): a ring
    # of ``queue_depth`` slots a worker holding *decompressed* payloads
    # (float32, zeros in empty slots), with their global arrival step
    # (-1 = empty) and staleness τ.  A payload computed at t sits in slot
    # ``t % depth`` until its arrival step.  None unless init(...,
    # queue_depth=) allocated it.
    inflight: Any = None                       # [R, depth, ...] leaves
    arrive_at: Optional[np.ndarray] = None     # int32 [R, depth], host
    inflight_tau: Optional[np.ndarray] = None  # int32 [R, depth], host


def replicate(tree, R: int):
    """Copy a tree onto a leading worker axis of size R."""
    return tree_map(lambda x: x[None].repeat((R,) + (1,) * x.dim()), tree)


def leaf_group_names(params) -> tuple:
    """Top-level parameter-group names of the per-leaf ledger, in the
    order ``state.leaf_bits`` / ``leaf_bits_down`` index them."""
    return pol.leaf_groups(params)[0]


def init(params, inner_opt: GradientTransform, R: int, downlink=None,
         leaf_ledger: bool = False, device=None,
         queue_depth: Optional[int] = None) -> EngineState:
    """Engine state for ``params`` (tensors or numpy arrays) on
    ``device`` (default cuda).  ``downlink``: the server→worker operator
    (or Channel) the state will be stepped with — needed here only to
    allocate the server-side memory; None/Identity allocates nothing.
    ``leaf_ledger``: allocate the per-group ledgers (pass the same flag
    to :func:`make_step`).  ``queue_depth``: allocate the fault
    runtime's in-flight queue (``FaultSpec.depth`` slots a worker; pass
    the same value to :func:`make_fault_step`); None leaves the queue
    fields None."""
    dev = resolve_device(device)
    if queue_depth is not None and queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    master = tree_map(lambda x: as_tensor(x, dev).clone(), params)
    local = replicate(master, R)
    down = chn.as_channel(downlink, "downlink")
    G = len(leaf_group_names(master)) if leaf_ledger else 0
    return EngineState(
        master=master,
        master_view=tree_map(torch.clone, local),
        local=local,
        memory=tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=dev), local),
        inner=per_worker(inner_opt.init(local), R),
        step=0,
        bits=torch.zeros((), dtype=torch.float32, device=dev),
        rounds=0,
        down_memory=None if down.is_identity() else down.init_memory(local),
        bits_down=torch.zeros((), dtype=torch.float32, device=dev),
        leaf_bits=(torch.zeros((G,), dtype=torch.float32, device=dev)
                   if leaf_ledger else None),
        leaf_bits_down=(torch.zeros((G,), dtype=torch.float32, device=dev)
                        if leaf_ledger else None),
        inflight=(None if queue_depth is None else tree_map(
            lambda x: torch.zeros((R, queue_depth) + tuple(x.shape),
                                  dtype=torch.float32, device=dev), master)),
        arrive_at=(None if queue_depth is None
                   else np.full((R, queue_depth), -1, np.int32)),
        inflight_tau=(None if queue_depth is None
                      else np.zeros((R, queue_depth), np.int32)),
    )


def per_worker(inner, R: int):
    """An inner-optimizer state over [R, ...] leaves with each host count
    (an int, Adam's step count) made one int32 count a worker, as
    ``repro``'s state vmapped over R holds it: faults freeze and reset
    workers one by one."""
    return tree_map(lambda x: np.full((R,), x, np.int32)
                    if isinstance(x, (int, np.integer))
                    and not isinstance(x, bool) else x, inner)


def _group_bits(per_leaf: list, gidx: tuple, G: int) -> torch.Tensor:
    """[G] ledger increment from per-leaf [S] bits of the S syncing
    workers: each worker's group folds its leaves in flatten order, then
    the workers fold in order (``repro``'s segment sum, then its sum
    over workers; non-syncing workers add nothing there either)."""
    per_group = [bitlib.ledger_sum([b for b, i in zip(per_leaf, gidx)
                                    if i == g]) for g in range(G)]
    return bitlib.ledger_sum(torch.stack(per_group).unbind(1))


def _inner_update(inner_opt: GradientTransform, grads, inner, params, lr,
                  scalars=None):
    """One inner-optimizer update; ``scalars`` (the transform's host
    values for this step, on the device) only where the caller has them."""
    if scalars is None:
        return inner_opt.update(grads, inner, params, lr)
    return inner_opt.update(grads, inner, params, lr, scalars=scalars)


def _make_local_phase(grad_fn: Callable, inner_opt: GradientTransform,
                      R: int):
    """The per-step local phase (Algorithm 1/2 lines 5-7): gradients
    worker by worker, then one optimizer step over all workers at the
    learning rate ``lr`` (a float32 scalar tensor)."""

    def local_phase(state: EngineState, batch, lr, scalars=None):
        grads, losses = [], []
        for r in range(R):
            loss, g = grad_fn(tree_map(lambda x: x[r], state.local),
                              tree_map(lambda b: b[r], batch))
            grads.append(g)
            losses.append(loss)
        grads = tree_map(lambda *gs: torch.stack(gs), *grads)
        updates, inner = _inner_update(inner_opt, grads, state.inner,
                                       state.local, lr, scalars)
        return apply_updates(state.local, updates), inner, torch.stack(losses)

    return local_phase


def _mask_of(sync_mask, R: int) -> np.ndarray:
    m = np.asarray(sync_mask, dtype=bool).reshape(-1)
    return np.broadcast_to(m, (R,)).copy()


def _take(tree, idx: Optional[torch.Tensor]):
    """Rows ``idx`` of every [R, ...] leaf (all rows when idx is None)."""
    return tree if idx is None else tree_map(lambda x: x[idx], tree)


def _put(tree, idx: Optional[torch.Tensor], rows):
    """``tree`` with rows ``idx`` replaced by ``rows`` (new tensors)."""
    if idx is None:
        return rows
    return tree_map(lambda x, v: x.index_copy(0, idx, v.to(x.dtype)),
                    tree, rows)


def _idx(mask: np.ndarray, R: int, const, dev) -> Optional[torch.Tensor]:
    """The rows ``mask`` selects as a device index (None for all R), made
    once per mask (a CUDA graph of a step copies nothing from the host)."""
    if mask.all():
        return None
    return const(("idx", mask.tobytes(), dev), lambda: torch.as_tensor(
        np.flatnonzero(mask), device=dev))


def _put_rows(tree, idx: Optional[torch.Tensor], mask: np.ndarray, rows,
              what: str):
    """:func:`_put` over a tree that may hold host counts: rows ``idx``
    (the rows ``mask`` selects) replaced on the tensors and on each
    count a worker (int arrays, :func:`per_worker`).  A count shared by
    all workers (a plain int) may only be kept where it agrees."""
    if idx is None:
        return rows

    def one(x, v):
        if isinstance(x, torch.Tensor):
            return x.index_copy(0, idx, v.to(x.dtype))
        if isinstance(x, np.ndarray):
            out = x.copy()
            out[mask] = v
            return out
        if x != v:
            raise ValueError(
                f"{what}: the inner optimizer's state holds a count shared "
                f"by all workers ({x!r} against {v!r} for some rows), which "
                "cannot differ from worker to worker; keep one count a "
                "worker (engine.per_worker)")
        return x

    return tree_map(one, tree, rows)


class _Parts(NamedTuple):
    """The phases the engine's steps are made of (see ``_make_parts``)."""
    const: Callable
    local_phase: Callable
    uplink: Callable
    aggregate: Callable
    broadcast: Callable
    check: Callable


def _make_parts(grad_fn: Callable, inner_opt: GradientTransform,
                operator, R: int, *,
                dispatch: Optional[dsp.DispatchConfig] = None,
                downlink=None, leaf_ledger: bool = False,
                aggregate: str = "mean_R") -> _Parts:
    """The phases :func:`make_step` and :func:`make_fault_step` share:

    * ``uplink(state, half, idx, rng)``: rows ``idx`` (None = all)
      compress m + x - x̂ (Algorithm 1/2 lines 8-11); returns (g [n, ...],
      memory, bits, leaf_bits) with the memory and ledgers updated;
    * ``aggregate(master, pay, n)``: the master minus the rule's mean of
      the n payload rows ``pay``;
    * ``broadcast(state, half, new_master, idx, n, rng)``: rows ``idx``
      receive the new master (exact, or through the compressed downlink);
      returns (view, local, down_memory, bits_down, leaf_bits_down)."""
    scn.validate_aggregate(aggregate)
    up_ch = (operator if isinstance(operator, chn.Channel)
             else chn.Channel(operator, "uplink", dispatch))
    down_ch = chn.as_channel(downlink, "downlink", dispatch)
    compressed_down = not down_ch.is_identity()
    local_phase = _make_local_phase(grad_fn, inner_opt, R)
    # device constants made once, at a step's first (eager) call, so a
    # CUDA graph of the step copies nothing from the host
    consts: dict = {}

    def const(key, make):
        if key not in consts:
            consts[key] = make()
        return consts[key]

    def uplink(state: EngineState, half, idx, rng):
        """Masked compress (Algorithm 1/2 lines 8-11) of rows ``idx``."""
        acc = tree_map(lambda m, x, h: m + x.to(torch.float32)
                       - h.to(torch.float32),
                       _take(state.memory, idx), _take(state.master_view, idx),
                       _take(half, idx))
        if leaf_ledger:
            gnames, gidx = pol.leaf_groups(state.master)
            g, m_out, bits, lb = up_ch.apply(rng, acc, batched=True,
                                             per_leaf=True)
            new_leaf_bits = state.leaf_bits + _group_bits(lb, gidx,
                                                          len(gnames))
        else:
            g, m_out, bits = up_ch.apply(rng, acc, batched=True)
            new_leaf_bits = state.leaf_bits
        return (g, _put(state.memory, idx, m_out),
                state.bits + bitlib.ledger_sum(bits.unbind(0)), new_leaf_bits)

    def aggregate_fn(master, pay, n: int):
        if aggregate == "mean_R":
            g_sum = tree_map(lambda gg: gg.sum(dim=0) / R, pay)
        elif aggregate == "mean_S":
            d = torch.tensor(float(max(n, 1)), dtype=torch.float32)
            g_sum = tree_map(lambda gg: gg.sum(dim=0) / d, pay)
        else:  # support_weighted
            g_sum = tree_map(lambda gg: gg.sum(dim=0) / torch.clamp(
                (gg != 0).to(torch.float32).sum(dim=0), min=1.0), pay)
        return tree_map(lambda x, gg: (x.to(torch.float32) - gg).to(x.dtype),
                        master, g_sum)

    def broadcast(state: EngineState, half, new_master, idx, n: int, rng):
        dev = state.bits.device
        view_s = _take(state.master_view, idx)
        if compressed_down:
            dacc = tree_map(lambda dm, v, nm: dm + nm.to(torch.float32)
                            - v.to(torch.float32),
                            _take(state.down_memory, idx), view_s,
                            new_master)
            if leaf_ledger:
                gnames, gidx = pol.leaf_groups(state.master)
                q, dm_out, dbits, dlb = down_ch.apply(rng, dacc, batched=True,
                                                      per_leaf=True)
                new_leaf_down = state.leaf_bits_down + _group_bits(
                    dlb, gidx, len(gnames))
            else:
                q, dm_out, dbits = down_ch.apply(rng, dacc, batched=True)
                new_leaf_down = state.leaf_bits_down
            new_view_s = tree_map(
                lambda v, qq: (v.to(torch.float32) + qq).to(v.dtype),
                view_s, q)
            new_down_mem = _put(state.down_memory, idx, dm_out)
            down_bits = state.bits_down + bitlib.ledger_sum(dbits.unbind(0))
        else:
            # exact broadcast: the receivers get x̄_{t+1} verbatim; the
            # ledger charges the dense per-receiver cost
            new_view_s = tree_map(
                lambda nm: nm[None].expand((n,) + tuple(nm.shape)),
                new_master)
            new_down_mem = state.down_memory
            down_bits = state.bits_down + bitlib.f32(
                np.float32(n) * np.float32(down_ch.dense_bits(state.master)),
                dev)
            new_leaf_down = state.leaf_bits_down
            if leaf_ledger:
                _, gidx = pol.leaf_groups(state.master)
                G = len(state.leaf_bits_down)

                # the per-receiver dense cost of each group, added leaf
                # by leaf in flatten order
                def dense_vec():
                    vec = np.zeros((G,), np.float32)
                    for leaf, i in zip(tree_leaves(state.master), gidx):
                        vec[i] += np.float32(32.0 * leaf.numel())
                    return torch.from_numpy(np.float32(n) * vec).to(dev)

                new_leaf_down = new_leaf_down + const(
                    ("dense_vec", n, dev), dense_vec)
        # (on an all-row exact broadcast both are views of new_master; the
        # engine never writes a state tensor in place)
        return (_put(state.master_view, idx, new_view_s),
                _put(half, idx, new_view_s), new_down_mem, down_bits,
                new_leaf_down)

    def check(state: EngineState) -> None:
        if compressed_down and state.down_memory is None:
            raise ValueError(
                "compressed downlink needs server-side error memory: "
                "initialize with engine.init(..., downlink=<op>)")
        if not compressed_down and state.down_memory is not None:
            raise ValueError(
                "state carries downlink error memory but this step was "
                "built without downlink=: pass the same downlink to "
                "make_step and init (or re-init without one)")
        if leaf_ledger and state.leaf_bits is None:
            raise ValueError(
                "per-leaf ledger needs state fields: initialize with "
                "engine.init(..., leaf_ledger=True)")

    return _Parts(const, local_phase, uplink, aggregate_fn, broadcast, check)


def _make_phases(grad_fn: Callable, inner_opt: GradientTransform,
                 operator, R: int, *,
                 dispatch: Optional[dsp.DispatchConfig] = None,
                 global_rounds: bool = False, downlink=None,
                 leaf_ledger: bool = False, aggregate: str = "mean_R"):
    """The engine's step as ``(step, check)``: ``step(state, batch, mask,
    rng, lr, scalars=None) -> (new_state, mean_loss)`` takes its learning
    rate (and the inner optimizer's step scalars) from the caller, so the
    per-step runtime and the round program share it; ``check(state)``
    validates the state against the build options."""
    p = _make_parts(grad_fn, inner_opt, operator, R, dispatch=dispatch,
                    downlink=downlink, leaf_ledger=leaf_ledger,
                    aggregate=aggregate)

    def sync_phase(state: EngineState, half, inner, mask: np.ndarray, rng):
        """Masked compress-and-aggregate (Algorithm 1/2 lines 8-20)."""
        n_sync = int(mask.sum())
        idx = _idx(mask, R, p.const, state.bits.device)
        g, new_mem, new_bits, new_leaf_bits = p.uplink(state, half, idx, rng)
        new_master = p.aggregate(state.master, g, n_sync)
        new_view, new_local, new_down_mem, down_bits, new_leaf_down = (
            p.broadcast(state, half, new_master, idx, n_sync, rng))
        inc = int(n_sync > 0) if global_rounds else n_sync
        return state._replace(
            master=new_master,
            master_view=new_view,
            local=new_local,
            memory=new_mem,
            inner=inner,
            step=state.step + 1,
            bits=new_bits,
            rounds=state.rounds + inc,
            down_memory=new_down_mem,
            bits_down=down_bits,
            leaf_bits=new_leaf_bits,
            leaf_bits_down=new_leaf_down,
        )

    def step(state: EngineState, batch, mask: Optional[np.ndarray], rng,
             lr, scalars=None):
        """One step at learning rate ``lr``; ``mask`` None is a step
        known to sync no worker (a round's head)."""
        half, inner, losses = p.local_phase(state, batch, lr, scalars)
        if mask is not None and mask.any():
            new_state = sync_phase(state, half, inner, mask, rng)
        else:
            new_state = state._replace(local=half, inner=inner,
                                       step=state.step + 1)
        return new_state, losses.mean()

    return step, p.check


def make_step(
    grad_fn: Callable,               # (params, batch) -> (loss, grads)
    inner_opt: GradientTransform,
    operator: CompressionOp | Any,   # op or tree-of-ops (Corollary 1)
    lr_schedule: Callable,
    R: int,
    *,
    dispatch: Optional[dsp.DispatchConfig] = None,
    global_rounds: bool = False,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
):
    """Build the unified step ``(state, batch, sync_mask, rng) ->
    (new_state, mean_loss)``.

    ``grad_fn`` takes one worker's params and batch and returns
    ``(loss, grads)``; ``batch`` leaves lead with the worker axis.
    ``sync_mask`` is bool[R] on the host (a scalar broadcasts): which
    workers hit a sync index at t+1.

    global_rounds: ``state.rounds`` counts master rounds (+1 whenever
    any worker syncs) when True, worker sync events (+Σ s_r) when False.

    aggregate: how the master divides the syncing subset's payload sum
    (DESIGN.md §8): "mean_R" (the paper's Σ/R), "mean_S" (Σ/|S|) or
    "support_weighted" (per coordinate, by the number of syncing
    workers whose payload carried it; zero-support coordinates keep the
    master value).

    downlink: server→worker compression of the per-worker master delta
    with a server-side memory (pass the same ``downlink`` to
    :func:`init`).  None/Identity keeps the exact dense broadcast and
    charges its dense cost to ``state.bits_down``.

    leaf_ledger: also accumulate ``state.leaf_bits`` / ``leaf_bits_down``,
    the wire bits per top-level parameter group (``leaf_group_names``).
    Pure accounting: the trajectory is unchanged.
    """
    step, check = _make_phases(
        grad_fn, inner_opt, operator, R, dispatch=dispatch,
        global_rounds=global_rounds, downlink=downlink,
        leaf_ledger=leaf_ledger, aggregate=aggregate)

    def step_fn(state: EngineState, batch, sync_mask, rng=None):
        check(state)
        return step(state, batch, _mask_of(sync_mask, R), rng,
                    lr_schedule(state.step))

    return step_fn


def run(state: EngineState, step_fn, batches, sync_mask, rng=None
        ) -> tuple[EngineState, list[float]]:
    """Drive T steps: ``sync_mask`` is bool[T] (all workers agree) or
    bool[T, R]; each batch's leaves lead with the worker axis and are
    moved to the state's device."""
    dev = state.bits.device
    losses = []
    for t, batch in enumerate(batches):
        batch = tree_map(lambda b: as_tensor(b, dev), batch)
        state, loss = step_fn(state, batch, np.asarray(sync_mask)[t], rng)
        losses.append(loss)
    return state, [float(l) for l in losses]


# ---------------------------------------------------------------------------
# the round runtime: one program per sync round
# ---------------------------------------------------------------------------


def _is_host(x) -> bool:
    return not isinstance(x, torch.Tensor)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _copy_into(dsts: list, srcs: list) -> None:
    """``dst.copy_(src)`` pairwise, skipping a source that IS its
    destination; a source that shares memory with any destination being
    written is cloned first, so the order of the copies cannot matter."""
    todo = [(d, s) for d, s in zip(dsts, srcs) if s is not d]
    written = {_storage(d) for d, _ in todo}
    todo = [(d, s.clone() if _storage(s) in written else s) for d, s in todo]
    for d, s in todo:
        d.copy_(s)


def _to_device(dst: torch.Tensor, src) -> None:
    """Copy a host (numpy / CPU) or device block into a static buffer; a
    host block to the card goes through pinned memory, asynchronously."""
    if isinstance(src, np.ndarray):
        src = torch.from_numpy(np.ascontiguousarray(src))
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"block leaf {tuple(src.shape)} {src.dtype} does "
                         f"not match the program's {tuple(dst.shape)} "
                         f"{dst.dtype}")
    if src.device.type == "cpu" and dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


#: round programs a runner keeps at most (static block, buffers, graph)
MAX_PROGRAMS = 8


def _block_sig(block) -> tuple:
    return tuple((tuple(x.shape), str(x.dtype)) for x in tree_leaves(block))


class _Program:
    """W rounds of L steps with tail masks ``masks``: the body of one
    round shape, made when the shape repeats.  Its static inputs (the
    [W, L, ...] batch block, the W * L learning rates and optimizer
    scalars) and outputs (the [W, L] losses, the per-round ledger
    snapshots) are allocated here, outside any graph pool; the state
    lives in the runner's buffers."""

    def __init__(self, runner: "RoundRunner", W: int, L: int, masks: tuple,
                 block_like, rng, scalar_shape: Optional[tuple]):
        dev = runner.device
        self.runner, self.W, self.L, self.masks, self.rng = (
            runner, W, L, masks, rng)
        self.block = tree_map(lambda x: torch.empty(
            tuple(x.shape), dtype=as_tensor(x[:0]).dtype, device=dev),
            block_like)
        self.lr = torch.empty((W * L,), dtype=torch.float32, device=dev)
        self.scalars = (None if scalar_shape is None else torch.empty(
            (W * L,) + tuple(scalar_shape), dtype=torch.float32,
            device=dev))
        self.loss = torch.empty((W, L), dtype=torch.float32, device=dev)
        self.leds = {f: torch.empty((W,) + tuple(t.shape), dtype=t.dtype,
                                    device=dev)
                     for f, t in runner.ledger_tensors.items()}
        self.host_in: list = []
        self.host_delta: Optional[list] = None     # the state's host ints
        self.led_delta: Optional[list] = None      # per round, ``ledger_ints``
        self.graph = None
        if runner.graphed:
            gens = ((rng,) if isinstance(rng, torch.Generator)
                    and rng.device.type == "cuda" else ())
            static = [self.lr, self.loss] + runner.bufs
            # the shape's first run (RoundRunner.run) was its warm-up, on
            # the runner's stream: the first call captures
            self.graph = CudaGraph(self.body, static, pool=runner.pool,
                                   generators=gens, stream=runner.stream,
                                   warmed=True)

    def body(self) -> None:
        r = self.runner
        state = r.rebuild(r.bufs, self.host_in)
        base = [getattr(state, f) for f in r.ledger_ints]
        led_ints = []
        for w, (state, losses) in enumerate(r.rounds(
                state, self.block, self.lr, self.scalars, self.masks,
                self.rng)):
            self.loss[w].copy_(torch.stack(losses))
            for f, buf in self.leds.items():
                buf[w].copy_(getattr(state, f))
            led_ints.append([getattr(state, f) for f in r.ledger_ints])
        host_out = r.store(state)
        self.host_delta = [_host_delta(a, b)
                           for a, b in zip(self.host_in, host_out)]
        self.led_delta = [[v - b for v, b in zip(row, base)]
                          for row in led_ints]

    def __call__(self) -> None:
        if self.graph is None:
            self.body()
        else:
            self.graph()


def _host_delta(before, after):
    """How a host leaf of the state moves over one run of a program:
    ints (step, rounds, an optimizer's count) and int arrays (a count a
    worker) by a fixed amount, None for no move; other host values may
    not move at all."""
    if isinstance(before, np.ndarray) and before.dtype.kind in "iu":
        delta = np.asarray(after) - before
        return delta if delta.any() else None
    if isinstance(before, (int, np.integer)) and not isinstance(before, bool):
        return (int(after) - int(before)) or None
    if after is not before and after != before:
        raise ValueError(f"a host value of the state changed in a round "
                         f"program ({before!r} -> {after!r}); only ints "
                         "may advance")
    return None


class RoundRunner:
    """Runs a step function round by round: W rounds of L steps, the
    last step of each with its tail mask, one round shape (W, L, tail
    masks, block signature) at a time.

    ``step(state, batch, tail, rng, lr, scalars) -> (state, loss)``:
    ``tail`` is None on a round's head steps and the round's tail mask on
    its last step; with ``per_step_rows`` (the fault rounds) a round's
    "mask" is its L per-step rows (each with a ``key()``), one to a
    step.  The state is a NamedTuple whose tensor leaves the runner
    keeps in its own buffers (made from the first state it is given,
    outside any graph pool) and whose int leaves (step, rounds, an
    optimizer's count) stay on the host.

    A shape's first run goes through the step directly, with nothing
    kept; a shape that repeats gets a program (:class:`_Program`: static
    block, learning rates, losses and ledger snapshots), at most
    :data:`MAX_PROGRAMS` of them (later new shapes keep running
    directly), so an async schedule's rarely repeating tail masks hold
    no memory.
    On a CUDA device (``graphed``) a program is a
    :class:`~repro_torch.graphs.CudaGraph` captured at the shape's second
    run (the first, on the runner's stream, was its warm-up) and replayed
    after: its body reads the state buffers, the batch block and the
    learning rates, and writes the new state back into the buffers
    (``copy_``) and the losses and ledger snapshots into its outputs.
    Replays advance the host ints as the captured run did.  On the CPU
    the program's body runs eagerly.

    Donation, as in ``repro``: the state passed in is consumed (copied
    into the buffers unless it already is them; with ``adopt``, the first
    state's tensors that own their memory alone become the buffers), and
    the returned state aliases the buffers, so the next call overwrites
    it.
    """

    #: the state fields snapshotted after each round, where the state has
    #: them (tensors on the device, ints on the host)
    LEDGER = ("bits", "bits_down", "leaf_bits", "leaf_bits_down", "rounds")

    def __init__(self, step: Callable, lr_schedule: Callable,
                 inner_opt: Optional[GradientTransform],
                 per_step_rows: bool = False, adopt: bool = False):
        self.step, self.lr_schedule, self.inner_opt = (
            step, lr_schedule, inner_opt)
        # True: the first state's tensors that own their memory alone
        # become the buffers themselves (a large queue is not copied)
        self.adopt = adopt
        # True: a round's "mask" is a sequence of L per-step rows (each
        # with a ``key()``), handed to every step; False: one tail mask
        self.per_step_rows = per_step_rows
        self.max_programs = MAX_PROGRAMS
        self.graphed: Optional[bool] = None
        self.device: Optional[torch.device] = None
        self.bufs: list = []
        self.kinds: list = []      # per state leaf: a host value?
        self.spec = None
        self.state_type = None
        self.ledger_tensors: dict = {}
        self.ledger_ints: tuple = ()
        self.seen: set = set()     # round shapes run at least once
        self.programs: dict = {}
        self.pool = None
        self.stream = None

    # -- state <-> buffers ------------------------------------------------
    def leaves(self, state) -> list:
        leaves, spec = tree_flatten(tuple(state))
        if self.spec is not None and (
                len(leaves) != len(self.kinds) or
                [_is_host(x) for x in leaves] != self.kinds):
            raise ValueError("the state's structure differs from the one "
                             "this round runtime was built on")
        return leaves

    def rebuild(self, bufs: list, host: list):
        it_b, it_h = iter(bufs), iter(host)
        leaves = [next(it_h) if k else next(it_b) for k in self.kinds]
        return self.state_type(*tree_unflatten(self.spec, leaves))

    def store(self, state) -> list:
        """Copy ``state``'s tensors into the buffers; its host leaves."""
        leaves = self.leaves(state)
        _copy_into(self.bufs, [x for x in leaves if not _is_host(x)])
        return [x for x in leaves if _is_host(x)]

    def _bind(self, state) -> list:
        """Consume ``state`` into the buffers; its host leaves."""
        if self.spec is None:
            leaves, self.spec = tree_flatten(tuple(state))
            self.kinds = [_is_host(x) for x in leaves]
            self.state_type = type(state)
            tensors = [x for x in leaves if not _is_host(x)]
            self.device = tensors[0].device
            self.graphed = self.device.type == "cuda"
            if self.graphed:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream(self.device)
            owners: dict = {}
            for x in tensors:
                owners[_storage(x)] = owners.get(_storage(x), 0) + 1
            self.bufs = [
                x if (self.adopt and owners[_storage(x)] == 1
                      and x.is_contiguous() and x.storage_offset() == 0
                      and x.untyped_storage().nbytes()
                      == x.numel() * x.element_size())
                else torch.empty(tuple(x.shape), dtype=x.dtype,
                                 device=self.device) for x in tensors]
            self.ledger_tensors = {
                f: getattr(state, f) for f in self.LEDGER
                if isinstance(getattr(state, f, None), torch.Tensor)}
            self.ledger_ints = tuple(
                f for f in self.LEDGER
                if isinstance(getattr(state, f, None), int))
        leaves = self.leaves(state)
        for x, b in zip([x for x in leaves if not _is_host(x)], self.bufs):
            if tuple(x.shape) != tuple(b.shape) or x.dtype != b.dtype:
                raise ValueError("the state's tensors differ from the ones "
                                 "this round runtime was built on")
        return self.store(state)

    # -- one call -----------------------------------------------------------
    def rounds(self, state, block, lr, scalars, masks, rng):
        """The W rounds' steps: yields (state, [L] losses) after each
        round; ``block`` leaves [W, L, ...] on the device, ``lr`` [W * L]
        and ``scalars`` [W * L, n] (or None) device tensors."""
        W, L = (int(n) for n in tree_leaves(block)[0].shape[:2])
        for w in range(W):
            losses = []
            for i in range(L):
                j = w * L + i
                row = (masks[w][i] if self.per_step_rows else
                       masks[w] if i == L - 1 else None)
                state, loss = self.step(
                    state, tree_map(lambda b: b[w, i], block), row, rng,
                    lr[j], None if scalars is None else scalars[j])
                losses.append(loss)
            yield state, losses

    def _direct(self, host_in, blocks, masks, lrs, scal, rng):
        """A shape's run without a program: the steps on the runner's
        stream (on the card, the capture's warm-up), the new state into
        the buffers.  (losses [W, L], ledger tensors {f: [W, ...]}, host
        leaves after, ledger ints after each round)."""
        dev = self.device
        state = self.rebuild(self.bufs, host_in)
        block = tree_map(lambda x: as_tensor(x, dev), blocks)
        lr = lrs.to(dev)
        sc = None if scal is None else torch.from_numpy(scal).to(dev)
        loss_rows, led_rows, led_ints = [], [], []
        for state, losses in self.rounds(state, block, lr, sc, masks, rng):
            loss_rows.append(torch.stack(losses))
            led_rows.append({f: getattr(state, f).clone()
                             for f in self.ledger_tensors})
            led_ints.append([getattr(state, f) for f in self.ledger_ints])
        host_out = self.store(state)
        leds = {f: torch.stack([row[f] for row in led_rows])
                for f in self.ledger_tensors}
        return torch.stack(loss_rows), leds, host_out, led_ints

    def _step_values(self, state, n: int, rows=None):
        """The n steps' learning rates and the inner optimizer's step
        scalars; ``rows`` (alive / recover, bool [n, ...]) for a fault
        run's counts."""
        lrs = torch.stack([torch.as_tensor(
            self.lr_schedule(state.step + i), dtype=torch.float32).to(
                "cpu").reshape(()) for i in range(n)])
        fn = getattr(self.inner_opt, "step_scalars", None)
        scal = None if fn is None else np.asarray(
            fn(state.inner, n, **(rows or {})), np.float32)
        return lrs, scal

    @property
    def captures(self) -> int:
        """Graphs captured so far (one per round shape run twice)."""
        return sum(p.graph.captures for p in self.programs.values()
                   if p.graph is not None)

    def run(self, state, blocks, masks: Sequence[np.ndarray], rng,
            rows=None, replay: bool = True):
        """W rounds: ``blocks`` leaves [W, L, ...], ``masks`` the W tail
        masks.  Returns (state, losses [W, L], ledger snapshots after
        each round: {field: [W, ...]}), the ledger's ints as CPU int64.
        ``rows``: the steps' alive / recover rows for the optimizer's
        step scalars (fault rounds).  ``replay`` False: the rounds run
        directly and make no program (a round that resets host counts,
        which no fixed delta replays)."""
        host_in = self._bind(state)
        if self.graphed and isinstance(rng, Uniforms):
            raise ValueError(
                "a Uniforms feed hands out host arrays, which a CUDA graph "
                "cannot hold: pass a torch.Generator on the device (or run "
                "runtime='step')")
        lead = tree_leaves(blocks)[0]
        W, L = int(lead.shape[0]), int(lead.shape[1])
        if self.per_step_rows:
            masks = tuple(tuple(m) for m in masks)
            if any(len(m) != L for m in masks):
                raise ValueError(f"a round of {L} steps needs {L} rows")
            sig = tuple(b"".join(r.key() for r in m) for m in masks)
        else:
            masks = tuple(np.asarray(m, bool).copy() for m in masks)
            sig = tuple(m.tobytes() for m in masks)
        if len(masks) != W:
            raise ValueError(f"{len(masks)} tail masks for {W} rounds")
        key = (W, L, sig, _block_sig(blocks))
        lrs, scal = self._step_values(state, W * L, rows)
        base = self.rebuild(self.bufs, host_in)
        prog = self.programs.get(key) if replay else None
        if prog is None and (key not in self.seen or not replay
                             or len(self.programs) >= self.max_programs):
            if replay:
                self.seen.add(key)
            if self.graphed:
                cur = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(cur)
                with torch.cuda.stream(self.stream):
                    losses, leds, host_out, led_ints = self._direct(
                        host_in, blocks, masks, lrs, scal, rng)
                cur.wait_stream(self.stream)
            else:
                losses, leds, host_out, led_ints = self._direct(
                    host_in, blocks, masks, lrs, scal, rng)
            for j, f in enumerate(self.ledger_ints):
                leds[f] = torch.tensor([row[j] for row in led_ints])
            return self.rebuild(self.bufs, host_out), losses, leds
        if prog is None:
            prog = _Program(self, W, L, masks, blocks, rng,
                            None if scal is None else scal.shape[1:])
            self.programs[key] = prog
        elif prog.graph is not None and prog.rng is not rng:
            raise ValueError("a round graph draws from the generator it was "
                             "captured with; pass the same rng every call")
        prog.rng = rng
        for dst, src in zip(tree_leaves(prog.block), tree_leaves(blocks)):
            _to_device(dst, src)
        prog.lr.copy_(lrs)
        if prog.scalars is not None:
            prog.scalars.copy_(torch.from_numpy(scal))
        prog.host_in = host_in
        prog()
        host_out = [h if d is None else h + d
                    for h, d in zip(host_in, prog.host_delta)]
        leds = {f: prog.leds[f].clone() for f in prog.leds}
        for j, f in enumerate(self.ledger_ints):
            leds[f] = torch.tensor([getattr(base, f) + row[j]
                                    for row in prog.led_delta])
        return (self.rebuild(self.bufs, host_out), prog.loss.clone(), leds)


class Superstep:
    """A round program over :class:`RoundRunner`: one sync round a call
    (``__call__``), or a window of equal-length rounds
    (:meth:`multiround`).  ``to_runner`` / ``from_runner`` convert the
    caller's state to and from the runner's (the Algorithm 1 / 2
    wrappers keep their own state types); ``check`` vets a state before
    a call."""

    def __init__(self, runner: RoundRunner, R: int,
                 check: Optional[Callable] = None,
                 to_runner: Callable = lambda s: s,
                 from_runner: Callable = lambda s: s):
        self.runner, self.R, self.check = runner, R, check
        self.to_runner, self.from_runner = to_runner, from_runner

    @property
    def captures(self) -> int:
        return self.runner.captures

    @property
    def shapes(self) -> int:
        """Distinct round shapes run so far (captured or direct)."""
        return len(self.runner.seen)

    def __call__(self, state, batch_block, tail_mask, rng=None):
        """One round: ``batch_block`` leaves [L, R, ...], ``tail_mask``
        the tail step's sync row (bool[R]; a scalar broadcasts).
        Returns (state, losses [L])."""
        state, losses, _ = self.multiround(
            state, tree_map(lambda x: x[None], batch_block), [tail_mask],
            rng)
        return state, losses[0]

    def multiround(self, state, blocks, tail_masks, rng=None):
        """W rounds of L steps: ``blocks`` leaves [W, L, R, ...],
        ``tail_masks`` the W tail rows ([W] or [W, R]).  Returns (state,
        losses [W, L], leds): ``leds`` the ledger after each round
        ({"bits", "bits_down", "rounds"} and the group vectors where the
        ledger is on, [W, ...] each)."""
        state = self.to_runner(state)
        if self.check is not None:
            self.check(state)
        masks = [_mask_of(m, self.R) for m in tail_masks]
        state, losses, leds = self.runner.run(state, blocks, masks, rng)
        return self.from_runner(state), losses, leds


def make_superstep(
    grad_fn: Callable,               # (params, batch) -> (loss, grads)
    inner_opt: GradientTransform,
    operator: CompressionOp | Any,
    lr_schedule: Callable,
    R: int,
    *,
    dispatch: Optional[dsp.DispatchConfig] = None,
    global_rounds: bool = False,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
) -> Superstep:
    """Build the round program: one program per sync round, L - 1 local
    steps (the no-sync branch of :func:`make_step`'s step, verbatim),
    then the step with the sync phase once at the tail.  Arguments as in
    :func:`make_step`.

    The built :class:`Superstep` takes ``(state, batch_block, tail_mask,
    rng=None)``: ``batch_block`` stacks the round's L per-step batches on
    a new leading axis ([L, R, ...] leaves, numpy or tensors) and
    ``tail_mask`` is the tail step's sync row (bool[R]; a scalar
    broadcasts; all-False for a trailing partial round, whose tail is a
    local step too).  It returns ``(new_state, losses)`` with ``losses``
    the [L] per-step mean losses, one tensor per round; ``rng`` advances
    as the L per-step calls would advance it.

    On a CUDA device each (round length, tail mask) that repeats is
    captured once as a CUDA graph (:class:`RoundRunner`; ``superstep.
    captures`` counts them) whose static inputs are the batch block and
    the L learning rates, refreshed before each replay; a random draw
    comes from ``rng`` (a ``torch.Generator`` registered with the graph;
    a ``Uniforms`` feed raises ``ValueError``).  On the CPU the same round
    body runs eagerly.  Either way the trajectory is bit for bit the
    per-step path's on every state tensor and ledger.

    Donation, as ``repro``'s donated jit: the state passed in is consumed
    and the returned state aliases the program's buffers, so read what
    you need of a state (ledger, eval, checkpoint) before the next call.
    """
    step, check = _make_phases(
        grad_fn, inner_opt, operator, R, dispatch=dispatch,
        global_rounds=global_rounds, downlink=downlink,
        leaf_ledger=leaf_ledger, aggregate=aggregate)
    return Superstep(RoundRunner(step, lr_schedule, inner_opt), R, check)


def stack_block(step_batches):
    """Stack a round's per-step batches into one [L, ...] block (numpy
    when every leaf is numpy, else a tensor)."""
    def stack(*xs):
        if all(isinstance(x, np.ndarray) for x in xs):
            return np.stack(xs)
        return torch.stack([as_tensor(x) for x in xs])

    return tree_map(stack, *step_batches)


def stack_window(steps, W: int, L: int):
    """Stack W·L per-step batches into one [W, L, ...] window block."""
    return tree_map(lambda x: x.reshape((W, L) + tuple(x.shape[1:])),
                    stack_block(steps))


def round_calls(batches, sync_mask, window: int = 1,
                boundary_steps: Sequence[int] = ()):
    """The calls of the round runtime over a schedule, the one driver
    loop of :func:`run_rounds_overlap`, the trainer and the LM launcher:
    segment ``sync_mask`` (bool[T] or bool[T, R]) into round plans,
    group consecutive equal-length rounds into windows of up to
    ``window`` (``rounds.window_rounds``; a round holding a step of
    ``boundary_steps`` runs alone), and take each window's batches.

    Yields ``(plans, block, tails)`` a call: the W rounds it runs, their
    batches stacked [W, L, ...] and their tail rows [W, ...].  A window
    the batch stream runs dry inside is run round by round, and the
    stream's end stops the schedule, as :func:`run` stops: a truncated
    round is yielded with the length it reaches and an all-False tail
    (it never reaches the plan's tail, the only step that can sync)."""
    plans = rnd.compile_rounds(sync_mask)
    it = iter(batches)
    for win in rnd.window_rounds(plans, max_window=window,
                                 boundary_steps=sorted(boundary_steps)):
        W, L = len(win), win[0].length
        steps = []
        for _ in range(W * L):
            try:
                steps.append(next(it))
            except StopIteration:
                break
        if W > 1 and len(steps) == W * L:
            yield (win, stack_window(steps, W, L),
                   np.stack([np.asarray(p.mask) for p in win]))
            continue
        for wi, plan in enumerate(win):
            seg = steps[wi * L:(wi + 1) * L]
            if not seg:
                return
            if len(seg) < plan.length:
                plan = plan._replace(length=len(seg),
                                     mask=np.zeros_like(plan.mask))
            yield ([plan], stack_window(seg, 1, len(seg)),
                   np.asarray(plan.mask)[None])
            if len(seg) < L:
                return


def run_rounds(state: EngineState, superstep: Superstep, batches, sync_mask,
               rng=None) -> tuple[EngineState, list[float]]:
    """Drive a whole schedule round by round: segment ``sync_mask``
    (bool[T] or bool[T, R]) into round plans (``core/rounds.py``), stack
    each round's batches into one block and run it as one superstep
    call.  A batch stream shorter than the schedule stops where it ends,
    as :func:`run` does: the truncated round's tail is all-False.  The
    per-step losses come back as floats, fetched at the end.
    Trajectories are bit for bit :func:`run`'s.  The state argument is
    consumed."""
    return run_rounds_overlap(state, superstep, batches, sync_mask, rng,
                              window=1)


def make_multiround(superstep: Superstep):
    """A window of W equal-length rounds as one program (one CUDA graph
    on the card): the overlapped driver's unit, ``superstep.multiround``
    (:meth:`Superstep.multiround`).  Its body is the superstep's, round
    after round, so everything is bit for bit W superstep calls."""
    return superstep.multiround


def run_rounds_overlap(state: EngineState, superstep: Superstep, batches,
                       sync_mask, rng=None, window: int = 8
                       ) -> tuple[EngineState, list[float]]:
    """The overlapped counterpart of :func:`run_rounds`: consecutive
    equal-length rounds run as multi-round windows of up to ``window``
    (:func:`round_calls`), one program each, so the host pays one launch
    per window.  Trajectories (states, ledgers, losses, the generator)
    are bit for bit :func:`run_rounds`'.  The state argument is
    consumed."""
    losses = []
    for _, block, tails in round_calls(batches, sync_mask, window):
        state, ls, _ = superstep.multiround(state, block, tails, rng)
        losses.append(ls)
    return state, [float(x) for ls in losses for x in ls.reshape(-1).tolist()]


# ---------------------------------------------------------------------------
# the staleness-first fault runtime (DESIGN.md §9)
# ---------------------------------------------------------------------------


class FaultRow(NamedTuple):
    """One step's fault data over the worker axis (leading-R numpy
    arrays; the [T, R]-stacked form from :func:`fault_rows` drives the
    per-step loop and the fault round program)."""

    sync: Any      # bool[R]  — scheduled sync fires at this step
    delay: Any     # int32[R] — staleness τ of a payload computed now
    alive: Any     # bool[R]  — worker is up this step
    drop: Any      # bool[R]  — a payload computed now is lost in flight
    recover: Any   # bool[R]  — first alive step after an outage


def fault_rows(mask, tables, R: int) -> FaultRow:
    """Stack a [T]/[T, R] sync mask and expanded
    :class:`~repro_torch.core.scenarios.FaultTables` into one [T, R]
    FaultRow (numpy).  Slice step t with :func:`index_rows`."""
    m = np.asarray(mask, bool)
    if m.ndim == 1:
        m = np.broadcast_to(m[:, None], (m.shape[0], R)).copy()
    T = m.shape[0]
    if tables.delay.shape[0] < T or tables.delay.shape[1] != R:
        raise ValueError(
            f"fault tables of shape {tables.delay.shape} don't cover the "
            f"[{T}, {R}] mask — expand the spec with tables(T, R)")
    return FaultRow(sync=m,
                    delay=np.asarray(tables.delay[:T], np.int32),
                    alive=np.asarray(tables.alive[:T], bool),
                    drop=np.asarray(tables.drop[:T], bool),
                    recover=np.asarray(tables.recover[:T], bool))


def index_rows(rows: FaultRow, sl) -> FaultRow:
    """Slice stacked [T, R] fault rows along the step axis."""
    return FaultRow(*(np.asarray(x)[sl] for x in rows))


class FaultPlan(NamedTuple):
    """One fault step's host decisions (:func:`plan_fault_step`), all
    fixed by the fault row, the step and the queue's host tags: the
    device step reads these and nothing else of the queue's tags."""

    alive: np.ndarray     # bool[R]: rows that take the local step
    recover: np.ndarray   # bool[R]: rows re-initialized from the master
    compute: np.ndarray   # bool[R]: rows that compress (sync & alive)
    fresh: np.ndarray     # bool[R]: computed, kept, τ = 0: applied now
    enqueue: np.ndarray   # bool[R]: computed, kept, τ > 0: into the slot
    slot: int             # the queue slot of payloads computed now
    arrive: np.ndarray    # bool[R, depth]: slots whose payload lands now
    weight: np.ndarray    # float32[R, depth]: their staleness weights
    receive: np.ndarray   # bool[R]: rows the new master is broadcast to
    event: bool           # any compute or arrival (else a local step)
    inc: int              # what ``rounds`` gains

    def key(self) -> bytes:
        return b"".join(np.ascontiguousarray(x).tobytes() for x in (
            self.alive, self.recover, self.compute, self.fresh,
            self.enqueue, np.int64(self.slot), self.arrive, self.weight,
            self.receive, np.bool_(self.event), np.int64(self.inc)))


def plan_fault_step(arrive_at: np.ndarray, tau: np.ndarray, step: int,
                    row: FaultRow, *, global_rounds: bool = False,
                    staleness_weight: str = "uniform"):
    """The host half of a fault step (``repro``'s ``make_fault_step``
    phases, on the queue's host tags): ``(plan, arrive_at, tau)`` after
    the step.  A payload computed at ``step`` and kept is tagged to
    arrive at step + τ in slot ``step % depth``; every payload whose
    arrival step is ``step`` lands and its slot is freed."""
    R, D = arrive_at.shape
    as_r = lambda x, dt: np.broadcast_to(  # noqa: E731
        np.asarray(x, dt).reshape(-1), (R,)).copy()
    sync, delay = as_r(row.sync, bool), as_r(row.delay, np.int32)
    alive, drop = as_r(row.alive, bool), as_r(row.drop, bool)
    recover = as_r(row.recover, bool)
    compute = sync & alive
    slot = int(step % D)
    none = np.zeros(R, bool)
    event = bool(compute.any() or (arrive_at == step).any())
    if not event:
        plan = FaultPlan(alive, recover, compute, none, none, slot,
                         np.zeros((R, D), bool), np.zeros((R, D), np.float32),
                         none, False, 0)
        return plan, arrive_at, tau
    keep = compute & ~drop
    arrive_at, tau = arrive_at.copy(), tau.copy()
    arrive_at[keep, slot] = np.int32(step) + delay[keep]
    tau[keep, slot] = delay[keep]
    arr = arrive_at == step
    if staleness_weight == "damped":
        weight = np.float32(1.0) / (np.float32(1.0) + tau.astype(np.float32))
    else:
        weight = np.ones((R, D), np.float32)
    weight = np.where(arr, weight, np.float32(0.0)).astype(np.float32)
    inc = int(arr.any()) if global_rounds else int(compute.sum())
    plan = FaultPlan(alive, recover, compute, keep & (delay == 0),
                     keep & (delay > 0), slot, arr, weight,
                     arr.any(axis=1) & alive, True, inc)
    return (plan, np.where(arr, -1, arrive_at).astype(np.int32),
            np.where(arr, 0, tau).astype(np.int32))


def plan_rows(plans) -> dict:
    """The plans' alive / recover rows, stacked (``step_scalars``' keyword
    arguments)."""
    return dict(alive=np.stack([p.alive for p in plans]),
                recover=np.stack([p.recover for p in plans]))


def _plan_rounds(state, rows: FaultRow, L: int, **kw):
    """Plans for the L steps of ``rows`` (leaves [L, R]) from ``state``'s
    queue tags; the tags after the last."""
    arrive_at, tau = state.arrive_at, state.inflight_tau
    plans = []
    for i in range(L):
        plan, arrive_at, tau = plan_fault_step(
            arrive_at, tau, state.step + i, index_rows(rows, i), **kw)
        plans.append(plan)
    return plans, arrive_at, tau


def _make_fault_phases(grad_fn: Callable, inner_opt: GradientTransform,
                       operator, R: int, *, queue_depth: int,
                       dispatch: Optional[dsp.DispatchConfig] = None,
                       downlink=None, leaf_ledger: bool = False,
                       aggregate: str = "mean_R"):
    """The device half of a fault step as ``(step, check)``: ``step(state,
    batch, plan, rng, lr, scalars=None) -> (state, mean_loss)`` runs the
    :class:`FaultPlan`'s phases (recover, local, compute / enqueue,
    apply, broadcast) and leaves the queue's host tags as they are."""
    p = _make_parts(grad_fn, inner_opt, operator, R, dispatch=dispatch,
                    downlink=downlink, leaf_ledger=leaf_ledger,
                    aggregate=aggregate)
    D = int(queue_depth)
    if D < 1:
        raise ValueError(f"queue_depth must be >= 1, got {D}")

    def rows_of(mask: np.ndarray, dev):
        return _idx(mask, R, p.const, dev)

    def index(values, dev):
        values = np.asarray(values, np.int64)
        return p.const(("pos", values.tobytes(), dev),
                       lambda: torch.as_tensor(values, device=dev))

    def recover_phase(state: EngineState, rec: np.ndarray):
        idx = rows_of(rec, state.bits.device)
        n = int(rec.sum())
        bcast = tree_map(lambda m: m[None].expand((n,) + tuple(m.shape)),
                         state.master)
        local = _put(state.local, idx, bcast)
        fresh = inner_opt.init(_take(local, idx))
        return state._replace(
            local=local,
            master_view=_put(state.master_view, idx, bcast),
            memory=_put(state.memory, idx, tree_map(
                torch.zeros_like, _take(state.memory, idx))),
            inner=_put_rows(state.inner, idx, rec, fresh,
                            "worker recovery"))

    def select(alive: np.ndarray, new, old, dev):
        """``new`` on the alive rows, ``old`` on the dead ones."""
        if alive.all():
            return new
        if not alive.any():
            return old
        dead = ~alive
        idx = rows_of(dead, dev)
        return _put_rows(new, idx, dead, tree_map(
            lambda o: o[idx] if isinstance(o, torch.Tensor)
            else o[dead] if isinstance(o, np.ndarray) else o, old),
            "dead workers")

    def arriving(state, queue, g, plan: FaultPlan, dev):
        """The landing payloads [n, ...] in ``repro``'s flat (worker,
        slot) order, weighted; the queue with their slots freed."""
        flat = np.flatnonzero(plan.arrive.reshape(-1))
        n = len(flat)
        comp_pos = np.cumsum(plan.compute) - 1     # row -> position in g
        fresh = [f % D == plan.slot and bool(plan.fresh[f // D])
                 for f in flat]
        from_g = [(j, int(comp_pos[f // D]))
                  for j, (f, fr) in enumerate(zip(flat, fresh)) if fr]
        from_q = [(j, int(f)) for j, (f, fr) in enumerate(zip(flat, fresh))
                  if not fr]
        if not from_q and len(from_g) == int(plan.compute.sum()):
            pay = g             # every computed payload lands now, in order
        elif not from_q:
            gi = index([s for _, s in from_g], dev)
            pay = tree_map(lambda gg: gg.index_select(0, gi), g)
        else:
            qi = index([f for _, f in from_q], dev)
            qpos = index([j for j, _ in from_q], dev)

            def gather(qq, gg=None):
                flat_q = qq.reshape((R * D,) + tuple(qq.shape[2:]))
                out = flat_q.new_empty((n,) + tuple(qq.shape[2:]))
                out.index_copy_(0, qpos, flat_q.index_select(0, qi))
                if from_g:
                    out.index_copy_(0, index([j for j, _ in from_g], dev),
                                    gg.index_select(0, index(
                                        [s for _, s in from_g], dev)))
                return out

            pay = (tree_map(gather, queue) if not from_g
                   else tree_map(gather, queue, g))
            queue = tree_map(lambda qq: qq.reshape(
                (R * D,) + tuple(qq.shape[2:])).index_fill(0, qi, 0.0)
                .reshape(qq.shape), queue)
        w = plan.weight.reshape(-1)[flat]
        if not np.all(w == np.float32(1.0)):
            wt = p.const(("w", w.tobytes(), dev),
                         lambda: torch.from_numpy(w.copy()).to(dev))
            pay = tree_map(lambda x: x * wt.reshape(
                (n,) + (1,) * (x.dim() - 1)), pay)
        return pay, n, queue

    def step(state: EngineState, batch, plan: FaultPlan, rng, lr,
             scalars=None):
        dev = state.bits.device
        if plan.recover.any():
            state = recover_phase(state, plan.recover)
        half_raw, inner_raw, losses = p.local_phase(state, batch, lr, scalars)
        # dead workers take no local step (their gradient is computed and
        # discarded, as repro's masking does; the loss averages all R)
        half = select(plan.alive, half_raw, state.local, dev)
        inner = select(plan.alive, inner_raw, state.inner, dev)
        if not plan.event:
            return state._replace(local=half, inner=inner,
                                  step=state.step + 1), losses.mean()
        g, new_mem, new_bits, new_leaf_bits = None, state.memory, \
            state.bits, state.leaf_bits
        if plan.compute.any():
            g, new_mem, new_bits, new_leaf_bits = p.uplink(
                state, half, rows_of(plan.compute, dev), rng)
        queue = state.inflight
        if plan.enqueue.any():
            comp_pos = np.cumsum(plan.compute) - 1
            src = index(comp_pos[plan.enqueue], dev)
            dst = index(np.flatnonzero(plan.enqueue) * D + plan.slot, dev)
            queue = tree_map(lambda qq, gg: qq.reshape(
                (R * D,) + tuple(qq.shape[2:])).index_copy(
                    0, dst, gg.index_select(0, src)).reshape(qq.shape),
                queue, g)
        new_master = state.master
        n_arr = int(plan.arrive.sum())
        if n_arr:
            pay, n_arr, queue = arriving(state, queue, g, plan, dev)
            new_master = p.aggregate(state.master, pay, n_arr)
            del pay
        new_view, new_local = state.master_view, half
        new_down_mem, down_bits = state.down_memory, state.bits_down
        new_leaf_down = state.leaf_bits_down
        if plan.receive.any():
            new_view, new_local, new_down_mem, down_bits, new_leaf_down = (
                p.broadcast(state, half, new_master,
                            rows_of(plan.receive, dev),
                            int(plan.receive.sum()), rng))
        return state._replace(
            master=new_master, master_view=new_view, local=new_local,
            memory=new_mem, inner=inner, step=state.step + 1, bits=new_bits,
            rounds=state.rounds + plan.inc, down_memory=new_down_mem,
            bits_down=down_bits, leaf_bits=new_leaf_bits,
            leaf_bits_down=new_leaf_down, inflight=queue), losses.mean()

    def check(state: EngineState) -> None:
        if state.inflight is None or state.arrive_at is None:
            raise ValueError(
                "fault step needs the in-flight queue: initialize with "
                f"engine.init(..., queue_depth={D})")
        if tuple(state.arrive_at.shape) != (R, D):
            raise ValueError(
                f"state queue depth {tuple(state.arrive_at.shape)} != "
                f"({R}, {D}) this step was built for")
        p.check(state)

    return step, check


def make_fault_step(
    grad_fn: Callable,               # (params, batch) -> (loss, grads)
    inner_opt: GradientTransform,
    operator: CompressionOp | Any,
    lr_schedule: Callable,
    R: int,
    *,
    queue_depth: int,
    dispatch: Optional[dsp.DispatchConfig] = None,
    global_rounds: bool = False,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
    staleness_weight: str = "uniform",
):
    """Build the fault / staleness step ``(state, batch, row, rng=None)
    -> (new_state, mean_loss)`` (DESIGN.md §9; ``repro``'s
    ``make_fault_step``), ``row`` a :class:`FaultRow`.

    Same algebra as :func:`make_step` with the sync event split into a
    *compute* time and an *apply* time.  Per step t:

    1. **recover**: workers on their first alive step after an outage
       re-initialize from the current master (local and view ← x̄_t,
       error memory ← 0, a fresh inner-optimizer state);
    2. **local phase**: every worker's gradient is computed (the loss is
       the mean over all R), alive workers step, dead ones stay frozen;
    3. **compute** (scheduled sync AND alive): the error-compensated
       payload of :func:`make_step`, memory updated and bits charged
       now, then enqueued to arrive at t + τ; a dropped payload is
       charged and compensated but never enqueued;
    4. **apply**: every payload whose arrival step is t joins the
       aggregation, weighted per ``staleness_weight`` ("uniform", or
       "damped": 1/(1+τ)); "mean_S" counts arriving payloads,
       "support_weighted" arriving support;
    5. **broadcast**: alive workers with a payload landing now receive
       the new master (exact or through the compressed downlink).

    With trivial rows (τ ≡ 0, all alive, no drops) every phase is
    :func:`make_step`'s, bit for bit.  The state must come from
    ``init(..., queue_depth=queue_depth)``.  The decisions of a step are
    made on the host (:func:`plan_fault_step`); a phase with no rows
    (nobody computes, nothing lands, nobody receives) launches nothing.
    """
    scn.validate_staleness_weight(staleness_weight)
    step, check = _make_fault_phases(
        grad_fn, inner_opt, operator, R, queue_depth=queue_depth,
        dispatch=dispatch, downlink=downlink, leaf_ledger=leaf_ledger,
        aggregate=aggregate)

    def step_fn(state: EngineState, batch, row: FaultRow, rng=None):
        check(state)
        plan, arrive_at, tau = plan_fault_step(
            state.arrive_at, state.inflight_tau, state.step, row,
            global_rounds=global_rounds, staleness_weight=staleness_weight)
        new, loss = step(state, batch, plan, rng, lr_schedule(state.step))
        return new._replace(arrive_at=arrive_at, inflight_tau=tau), loss

    return step_fn


class FaultSuperstep(Superstep):
    """A fault round program over :class:`RoundRunner`: every step of the
    round is the full fault step, its :class:`FaultPlan` made on the host
    first.  A program is keyed by its plans (rows, slots, arrivals), so a
    fault round shape that repeats (``preset:none``, a fixed delay) is
    captured once; most fault rounds are first sightings and run
    directly."""

    def __init__(self, runner: RoundRunner, R: int, check: Callable, *,
                 global_rounds: bool, staleness_weight: str):
        super().__init__(runner, R, check)
        self.plan_kw = dict(global_rounds=global_rounds,
                            staleness_weight=staleness_weight)

    def __call__(self, state, batch_block, rows: FaultRow, rng=None):
        """One round: ``batch_block`` leaves [L, R, ...], ``rows`` the
        round's [L, R] fault rows.  Returns (state, losses [L])."""
        state, losses, _ = self.multiround(
            state, tree_map(lambda x: x[None], batch_block), [rows], rng)
        return state, losses[0]

    def multiround(self, state, blocks, rows_list, rng=None):
        """W rounds of L steps: ``blocks`` leaves [W, L, R, ...],
        ``rows_list`` the W rounds' [L, R] fault rows.  Returns (state,
        losses [W, L], ledger after each round)."""
        state = self.to_runner(state)
        self.check(state)
        L = int(tree_leaves(blocks)[0].shape[1])
        plans, cur = [], state
        for rows in rows_list:
            ps, arrive_at, tau = _plan_rounds(cur, rows, L, **self.plan_kw)
            plans.append(tuple(ps))
            cur = cur._replace(step=cur.step + L, arrive_at=arrive_at,
                               inflight_tau=tau)
        # the tags stay on the host, outside the program's state; the
        # optimizer's counts follow the plans' alive / recover rows, and a
        # round that resets counts runs directly (no delta replays it)
        flat = [p for ps in plans for p in ps]
        state, losses, leds = self.runner.run(
            state._replace(arrive_at=None, inflight_tau=None), blocks, plans,
            rng, rows=plan_rows(flat),
            replay=not any(p.recover.any() for p in flat))
        return (self.from_runner(state._replace(arrive_at=arrive_at,
                                                inflight_tau=tau)),
                losses, leds)


def make_fault_superstep(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    operator: CompressionOp | Any,
    lr_schedule: Callable,
    R: int,
    *,
    queue_depth: int,
    dispatch: Optional[dsp.DispatchConfig] = None,
    global_rounds: bool = False,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
    staleness_weight: str = "uniform",
) -> FaultSuperstep:
    """Round program of the fault runtime: the full fault step over each
    of the round's steps (crashes and recoveries happen anywhere;
    arrivals close rounds, ``rounds.compile_fault_rounds``), as one
    program on :class:`RoundRunner` (a CUDA graph per repeating round
    shape on the card).  ``(state, batch_block, rows, rng=None) ->
    (state, losses [L])``, bit for bit the per-step loop of
    :func:`make_fault_step`; the state is donated as in
    :func:`make_superstep`."""
    scn.validate_staleness_weight(staleness_weight)
    step, check = _make_fault_phases(
        grad_fn, inner_opt, operator, R, queue_depth=queue_depth,
        dispatch=dispatch, downlink=downlink, leaf_ledger=leaf_ledger,
        aggregate=aggregate)
    return FaultSuperstep(
        RoundRunner(step, lr_schedule, inner_opt, per_step_rows=True), R,
        check, global_rounds=global_rounds,
        staleness_weight=staleness_weight)


def _queue_depth_of(state) -> int:
    if state.arrive_at is None:
        raise ValueError("fault drivers need a queue-bearing state: "
                         "initialize with engine.init(..., queue_depth=)")
    return state.arrive_at.shape[0]


def run_faults(state: EngineState, step_fn, batches, mask, tables, rng=None
               ) -> tuple[EngineState, list[float]]:
    """Drive T fault steps (the per-step loop; the oracle the round
    driver is held to)."""
    R = _queue_depth_of(state)
    rows = fault_rows(mask, tables, R)
    dev = state.bits.device
    losses = []
    for t, batch in enumerate(batches):
        batch = tree_map(lambda b: as_tensor(b, dev), batch)
        state, loss = step_fn(state, batch, index_rows(rows, t), rng)
        losses.append(loss)
    return state, [float(l) for l in losses]


def run_fault_rounds(state: EngineState, superstep: FaultSuperstep, batches,
                     mask, tables, rng=None
                     ) -> tuple[EngineState, list[float]]:
    """Drive the schedule as fault-round programs: rounds close at event
    steps (scheduled syncs and payload arrivals,
    ``rounds.compile_fault_rounds``), so master and ledgers change only
    at round tails.  A batch stream shorter than the schedule stops
    where it ends (the truncated round's steps sync nothing).  The state
    argument is consumed."""
    R = _queue_depth_of(state)
    rows = fault_rows(mask, tables, R)
    losses = []
    it = iter(batches)
    for plan in rnd.compile_fault_rounds(rows.sync, tables):
        steps = []
        for _ in range(plan.length):
            try:
                steps.append(next(it))
            except StopIteration:
                break
        if not steps:
            break
        block_rows = index_rows(rows, slice(plan.start,
                                            plan.start + len(steps)))
        if len(steps) < plan.length:
            block_rows = block_rows._replace(
                sync=np.zeros_like(block_rows.sync))
        state, ls = superstep(state, stack_block(steps), block_rows, rng)
        losses.append(ls)
        if len(steps) < plan.length:
            break
    return state, [float(x) for ls in losses for x in ls.tolist()]


# ---------------------------------------------------------------------------
# diagnostics (Lemma 4/5/7/8 empirical quantities)
# ---------------------------------------------------------------------------


def memory_sq_norms(state) -> torch.Tensor:
    """||m_t^{(r)}||_2^2 per worker (flattened over the whole tree)."""
    leaves = tree_leaves(state.memory)
    total = None
    for l in leaves:
        sq = (l.to(torch.float32) ** 2).reshape(l.shape[0], -1).sum(dim=1)
        total = sq if total is None else total + sq
    return total


def local_deviation_sq(state) -> torch.Tensor:
    """(1/R) Σ_r ||x̄ - x̂^{(r)}||^2 (Lemma 7/8 quantity), x̄ the mean
    of the local iterates."""
    leaves = tree_leaves(state.local)
    total = None
    for l in leaves:
        x = l.to(torch.float32)
        d = ((x - x.mean(dim=0, keepdim=True)) ** 2).sum()
        total = d if total is None else total + d
    return total / leaves[0].shape[0]
