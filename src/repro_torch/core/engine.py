"""Unified Qsparse-local-SGD engine (paper Algorithms 1 and 2 as one
state machine; DESIGN.md §1).  A port of ``repro.core.engine``'s
per-step path: ``init``, ``make_step`` and ``run``.

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
engine; the round, fault and overlap runtimes are still to be ported
(ROADMAP queue 1 items 9-10).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bits as bitlib, channel as chn
from repro_torch.core import policy as pol
from repro_torch.core.operators import CompressionOp
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels import dispatch as dsp
from repro_torch.optim.transforms import GradientTransform, apply_updates
from repro_torch.tree import tree_leaves, tree_map

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


def _make_local_phase(grad_fn: Callable, inner_opt: GradientTransform,
                      lr_schedule: Callable, R: int):
    """The per-step local phase (Algorithm 1/2 lines 5-7): gradients
    worker by worker, then one optimizer step over all workers."""

    def local_phase(state: EngineState, batch):
        lr = lr_schedule(state.step)
        grads, losses = [], []
        for r in range(R):
            loss, g = grad_fn(tree_map(lambda x: x[r], state.local),
                              tree_map(lambda b: b[r], batch))
            grads.append(g)
            losses.append(loss)
        grads = tree_map(lambda *gs: torch.stack(gs), *grads)
        updates, inner = inner_opt.update(grads, state.inner, state.local, lr)
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
    if aggregate not in AGGREGATES:
        raise ValueError(f"aggregate must be one of {AGGREGATES}, "
                         f"got {aggregate!r}")
    up_ch = (operator if isinstance(operator, chn.Channel)
             else chn.Channel(operator, "uplink", dispatch))
    down_ch = chn.as_channel(downlink, "downlink", dispatch)
    compressed_down = not down_ch.is_identity()
    local_phase = _make_local_phase(grad_fn, inner_opt, lr_schedule, R)

    def sync_phase(state: EngineState, half, inner, mask: np.ndarray, rng):
        """Masked compress-and-aggregate (Algorithm 1/2 lines 8-20)."""
        dev = state.bits.device
        n_sync = int(mask.sum())
        idx = (None if n_sync == R else
               torch.as_tensor(np.flatnonzero(mask), device=dev))
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
            down_bits = state.bits_down + (
                torch.tensor(float(n_sync), dtype=torch.float32)
                * torch.tensor(down_ch.dense_bits(state.master),
                               dtype=torch.float32)).to(dev)
            new_leaf_down = state.leaf_bits_down
            if leaf_ledger:
                # the per-receiver dense cost of each group, added leaf
                # by leaf in flatten order
                dense_vec = np.zeros((G,), np.float32)
                for leaf, i in zip(tree_leaves(state.master), gidx):
                    dense_vec[i] += np.float32(32.0 * leaf.numel())
                new_leaf_down = new_leaf_down + torch.from_numpy(
                    np.float32(n_sync) * dense_vec).to(dev)
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

    def step_fn(state: EngineState, batch, sync_mask, rng=None):
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
        mask = _mask_of(sync_mask, R)
        half, inner, losses = local_phase(state, batch)
        if mask.any():
            new_state = sync_phase(state, half, inner, mask, rng)
        else:
            new_state = state._replace(local=half, inner=inner,
                                       step=state.step + 1)
        return new_state, losses.mean()

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
