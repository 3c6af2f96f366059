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
a graph replays each step's own values.  The fault runtime is still to
be ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bits as bitlib, channel as chn
from repro_torch.core import policy as pol, rounds as rnd
from repro_torch.core.operators import CompressionOp, Uniforms
from repro_torch.device import as_tensor, resolve_device
from repro_torch.graphs import CudaGraph
from repro_torch.kernels import dispatch as dsp
from repro_torch.optim.transforms import GradientTransform, apply_updates
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

AGGREGATES = ("mean_R", "mean_S", "support_weighted")


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


def replicate(tree, R: int):
    """Copy a tree onto a leading worker axis of size R."""
    return tree_map(lambda x: x[None].repeat((R,) + (1,) * x.dim()), tree)


def leaf_group_names(params) -> tuple:
    """Top-level parameter-group names of the per-leaf ledger, in the
    order ``state.leaf_bits`` / ``leaf_bits_down`` index them."""
    return pol.leaf_groups(params)[0]


def init(params, inner_opt: GradientTransform, R: int, downlink=None,
         leaf_ledger: bool = False, device=None) -> EngineState:
    """Engine state for ``params`` (tensors or numpy arrays) on
    ``device`` (default cuda).  ``downlink``: the server→worker operator
    (or Channel) the state will be stepped with — needed here only to
    allocate the server-side memory; None/Identity allocates nothing.
    ``leaf_ledger``: allocate the per-group ledgers (pass the same flag
    to :func:`make_step`)."""
    dev = resolve_device(device)
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
        inner=inner_opt.init(local),
        step=0,
        bits=torch.zeros((), dtype=torch.float32, device=dev),
        rounds=0,
        down_memory=None if down.is_identity() else down.init_memory(local),
        bits_down=torch.zeros((), dtype=torch.float32, device=dev),
        leaf_bits=(torch.zeros((G,), dtype=torch.float32, device=dev)
                   if leaf_ledger else None),
        leaf_bits_down=(torch.zeros((G,), dtype=torch.float32, device=dev)
                        if leaf_ledger else None),
    )


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
    if aggregate not in AGGREGATES:
        raise ValueError(f"aggregate must be one of {AGGREGATES}, "
                         f"got {aggregate!r}")
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

    def sync_phase(state: EngineState, half, inner, mask: np.ndarray, rng):
        """Masked compress-and-aggregate (Algorithm 1/2 lines 8-20)."""
        dev = state.bits.device
        n_sync = int(mask.sum())
        idx = (None if n_sync == R else
               const(("idx", mask.tobytes(), dev), lambda: torch.as_tensor(
                   np.flatnonzero(mask), device=dev)))
        acc = tree_map(lambda m, x, h: m + x.to(torch.float32)
                       - h.to(torch.float32),
                       _take(state.memory, idx), _take(state.master_view, idx),
                       _take(half, idx))
        if leaf_ledger:
            gnames, gidx = pol.leaf_groups(state.master)
            G = len(gnames)
            g, m_out, bits, lb = up_ch.apply(rng, acc, batched=True,
                                             per_leaf=True)
            new_leaf_bits = state.leaf_bits + _group_bits(lb, gidx, G)
        else:
            g, m_out, bits = up_ch.apply(rng, acc, batched=True)
            new_leaf_bits = state.leaf_bits
        new_mem = _put(state.memory, idx, m_out)
        if aggregate == "mean_R":
            g_sum = tree_map(lambda gg: gg.sum(dim=0) / R, g)
        elif aggregate == "mean_S":
            n = torch.tensor(float(max(n_sync, 1)), dtype=torch.float32)
            g_sum = tree_map(lambda gg: gg.sum(dim=0) / n, g)
        else:  # support_weighted
            g_sum = tree_map(lambda gg: gg.sum(dim=0) / torch.clamp(
                (gg != 0).to(torch.float32).sum(dim=0), min=1.0), g)
        new_master = tree_map(
            lambda x, gg: (x.to(torch.float32) - gg).to(x.dtype),
            state.master, g_sum)

        view_s = _take(state.master_view, idx)
        if compressed_down:
            dacc = tree_map(lambda dm, v, nm: dm + nm.to(torch.float32)
                            - v.to(torch.float32),
                            _take(state.down_memory, idx), view_s,
                            new_master)
            if leaf_ledger:
                q, dm_out, dbits, dlb = down_ch.apply(rng, dacc, batched=True,
                                                      per_leaf=True)
                new_leaf_down = state.leaf_bits_down + _group_bits(
                    dlb, gidx, G)
            else:
                q, dm_out, dbits = down_ch.apply(rng, dacc, batched=True)
                new_leaf_down = state.leaf_bits_down
            new_view_s = tree_map(
                lambda v, qq: (v.to(torch.float32) + qq).to(v.dtype),
                view_s, q)
            new_down_mem = _put(state.down_memory, idx, dm_out)
            down_bits = state.bits_down + bitlib.ledger_sum(dbits.unbind(0))
        else:
            # exact broadcast: workers in S receive x̄_{t+1} verbatim; the
            # ledger charges the dense per-receiver cost
            new_view_s = tree_map(
                lambda nm: nm[None].expand((n_sync,) + tuple(nm.shape)),
                new_master)
            new_down_mem = state.down_memory
            down_bits = state.bits_down + bitlib.f32(
                np.float32(n_sync)
                * np.float32(down_ch.dense_bits(state.master)), dev)
            new_leaf_down = state.leaf_bits_down
            if leaf_ledger:
                # the per-receiver dense cost of each group, added leaf
                # by leaf in flatten order
                def dense_vec():
                    vec = np.zeros((G,), np.float32)
                    for leaf, i in zip(tree_leaves(state.master), gidx):
                        vec[i] += np.float32(32.0 * leaf.numel())
                    return torch.from_numpy(np.float32(n_sync) * vec).to(dev)

                new_leaf_down = new_leaf_down + const(
                    ("dense_vec", n_sync, dev), dense_vec)
        # (on an all-sync exact broadcast both are views of new_master;
        # the engine never writes a state tensor in place)
        new_view = _put(state.master_view, idx, new_view_s)
        new_local = _put(half, idx, new_view_s)
        inc = int(n_sync > 0) if global_rounds else n_sync
        return EngineState(
            master=new_master,
            master_view=new_view,
            local=new_local,
            memory=new_mem,
            inner=inner,
            step=state.step + 1,
            bits=state.bits + bitlib.ledger_sum(bits.unbind(0)),
            rounds=state.rounds + inc,
            down_memory=new_down_mem,
            bits_down=down_bits,
            leaf_bits=new_leaf_bits,
            leaf_bits_down=new_leaf_down,
        )

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

    def step(state: EngineState, batch, mask: Optional[np.ndarray], rng,
             lr, scalars=None):
        """One step at learning rate ``lr``; ``mask`` None is a step
        known to sync no worker (a round's head)."""
        half, inner, losses = local_phase(state, batch, lr, scalars)
        if mask is not None and mask.any():
            new_state = sync_phase(state, half, inner, mask, rng)
        else:
            new_state = state._replace(local=half, inner=inner,
                                       step=state.step + 1)
        return new_state, losses.mean()

    return step, check


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
                 block_like, rng, scalar_width: int):
        dev = runner.device
        self.runner, self.W, self.L, self.masks, self.rng = (
            runner, W, L, masks, rng)
        self.block = tree_map(lambda x: torch.empty(
            tuple(x.shape), dtype=as_tensor(x[:0]).dtype, device=dev),
            block_like)
        self.lr = torch.empty((W * L,), dtype=torch.float32, device=dev)
        self.scalars = (None if not scalar_width else torch.empty(
            (W * L, scalar_width), dtype=torch.float32, device=dev))
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
    ints (step, rounds, an optimizer's count) by a fixed amount, other
    host values not at all."""
    if isinstance(before, (int, np.integer)) and not isinstance(before, bool):
        return int(after) - int(before)
    if after is not before and after != before:
        raise ValueError(f"a host value of the state changed in a round "
                         f"program ({before!r} -> {after!r}); only ints "
                         "may advance")
    return 0


class RoundRunner:
    """Runs a step function round by round: W rounds of L steps, the
    last step of each with its tail mask, one round shape (W, L, tail
    masks, block signature) at a time.

    ``step(state, batch, tail, rng, lr, scalars) -> (state, loss)``:
    ``tail`` is None on a round's head steps and the round's tail mask on
    its last step.  The state is a NamedTuple whose tensor leaves the
    runner keeps in its own buffers (made from the first state it is
    given, outside any graph pool) and whose int leaves (step, rounds,
    an optimizer's count) stay on the host.

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
    into the buffers unless it already is them), and the returned state
    aliases the buffers, so the next call overwrites it.
    """

    #: the state fields snapshotted after each round, where the state has
    #: them (tensors on the device, ints on the host)
    LEDGER = ("bits", "bits_down", "leaf_bits", "leaf_bits_down", "rounds")

    def __init__(self, step: Callable, lr_schedule: Callable,
                 inner_opt: Optional[GradientTransform]):
        self.step, self.lr_schedule, self.inner_opt = (
            step, lr_schedule, inner_opt)
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
            self.bufs = [torch.empty(tuple(x.shape), dtype=x.dtype,
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
                state, loss = self.step(
                    state, tree_map(lambda b: b[w, i], block),
                    masks[w] if i == L - 1 else None, rng, lr[j],
                    None if scalars is None else scalars[j])
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

    def _step_values(self, state, n: int):
        lrs = torch.stack([torch.as_tensor(
            self.lr_schedule(state.step + i), dtype=torch.float32).to(
                "cpu").reshape(()) for i in range(n)])
        fn = getattr(self.inner_opt, "step_scalars", None)
        scal = None if fn is None else np.asarray(fn(state.inner, n),
                                                  np.float32)
        return lrs, scal

    @property
    def captures(self) -> int:
        """Graphs captured so far (one per round shape run twice)."""
        return sum(p.graph.captures for p in self.programs.values()
                   if p.graph is not None)

    def run(self, state, blocks, masks: Sequence[np.ndarray], rng):
        """W rounds: ``blocks`` leaves [W, L, ...], ``masks`` the W tail
        masks.  Returns (state, losses [W, L], ledger snapshots after
        each round: {field: [W, ...]}), the ledger's ints as CPU int64."""
        host_in = self._bind(state)
        if self.graphed and isinstance(rng, Uniforms):
            raise ValueError(
                "a Uniforms feed hands out host arrays, which a CUDA graph "
                "cannot hold: pass a torch.Generator on the device (or run "
                "runtime='step')")
        lead = tree_leaves(blocks)[0]
        W, L = int(lead.shape[0]), int(lead.shape[1])
        masks = tuple(np.asarray(m, bool).copy() for m in masks)
        if len(masks) != W:
            raise ValueError(f"{len(masks)} tail masks for {W} rounds")
        key = (W, L, tuple(m.tobytes() for m in masks), _block_sig(blocks))
        lrs, scal = self._step_values(state, W * L)
        base = self.rebuild(self.bufs, host_in)
        prog = self.programs.get(key)
        if prog is None and (key not in self.seen
                             or len(self.programs) >= self.max_programs):
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
                            0 if scal is None else scal.shape[1])
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
        host_out = [h + d if d else h
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
