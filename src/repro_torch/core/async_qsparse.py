"""Qsparse-local-SGD with asynchronous updates (paper Algorithm 2): a
port of ``repro.core.async_qsparse``.

A thin wrapper over the unified engine (``core/engine.py``), whose
per-worker sync mask is Algorithm 2 itself; this module keeps
``repro``'s state and API names.  All workers advance on a common
global clock but synchronize at per-worker times I_T^{(r)} with
gap(I_T^{(r)}) <= H, so each worker's view of the master x_t^{(r)} (the
last broadcast it received) can lag the true master.

Per step t (Algorithm 2 lines 4-20), with s_r = [t+1 in I_T^{(r)}]:

  x̂_{t+1/2}^{(r)} = x̂_t^{(r)} - eta_t d_t^{(r)}
  if not s_r:  x_{t+1}^{(r)} = x_t^{(r)};  m_{t+1}^{(r)} = m_t^{(r)};
               x̂_{t+1}^{(r)} = x̂_{t+1/2}^{(r)}
  else:        g_t^{(r)} = QComp_k(m_t^{(r)} + x_t^{(r)} - x̂_{t+1/2}^{(r)})
               m_{t+1}^{(r)} = m_t^{(r)} + x_t^{(r)} - x̂_{t+1/2}^{(r)} - g
  master:      x̄_{t+1} = x̄_t - (1/R) sum_{r in S} g_t^{(r)}
  workers in S: x_{t+1}^{(r)} = x̂_{t+1}^{(r)} = x̄_{t+1}

The round runtime (``make_superstep`` / ``run_rounds``) closes a round at
every step where any worker syncs (``engine.make_superstep``).  The
*executed* staleness regime (``make_fault_step`` / ``run_faults``) runs
the engine's fault runtime: a payload computed at t is applied at t + τ
out of a per-worker in-flight queue, with crashes, recoveries and lost
payloads injected through ``scenarios.FaultSpec``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.kernels import dispatch as dsp
from repro_torch.optim.transforms import GradientTransform


class AsyncQsparseState(NamedTuple):
    # field order mirrors engine.EngineState, so the two convert by splat
    master: Any           # x̄_t (true master)
    master_view: Any      # x_t^{(r)}: last master copy each worker got [R]
    local: Any            # x̂_t^{(r)} [R]
    memory: Any           # m_t^{(r)} [R]
    inner: Any            # [R]
    step: int
    bits: torch.Tensor    # uplink wire bits
    rounds: int           # total worker-sync events
    down_memory: Any = None
    bits_down: Optional[torch.Tensor] = None
    leaf_bits: Optional[torch.Tensor] = None
    leaf_bits_down: Optional[torch.Tensor] = None
    # the fault runtime's in-flight queue; None unless init(...,
    # queue_depth=) allocated it
    inflight: Any = None
    arrive_at: Optional[np.ndarray] = None
    inflight_tau: Optional[np.ndarray] = None


def init(params, inner_opt: GradientTransform, R: int, downlink=None,
         leaf_ledger: bool = False, device=None,
         queue_depth: Optional[int] = None) -> AsyncQsparseState:
    """State for ``params`` on ``device`` (default cuda); ``queue_depth``
    allocates the fault runtime's queue (the fault spec's ``depth``)."""
    return AsyncQsparseState(*engine.init(
        params, inner_opt, R, downlink=downlink, leaf_ledger=leaf_ledger,
        device=device, queue_depth=queue_depth))


def make_step(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    operator,
    lr_schedule: Callable,
    R: int,
    *,
    dispatch: Optional[dsp.DispatchConfig] = None,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
):
    """The Algorithm-2 step ``(state, batch, sync_flags, rng=None) ->
    (new_state, mean_loss)``; ``sync_flags`` is bool[R], which workers
    hit a sync index at t+1 (``global_rounds=False``: ``rounds`` counts
    worker sync events).  Non-syncing workers transmit nothing and keep
    their state; a step where no worker syncs skips compression.
    ``downlink`` / ``leaf_ledger`` / ``aggregate`` as in the engine; pass
    the same ``downlink`` / ``leaf_ledger`` to :func:`init`."""
    engine_step = engine.make_step(
        grad_fn, inner_opt, operator, lr_schedule, R, dispatch=dispatch,
        global_rounds=False, downlink=downlink, leaf_ledger=leaf_ledger,
        aggregate=aggregate)

    def step_fn(state: AsyncQsparseState, batch, sync_flags, rng=None):
        new, loss = engine_step(engine.EngineState(*state), batch,
                                sync_flags, rng)
        return AsyncQsparseState(*new), loss

    return step_fn


def make_superstep(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    operator,
    lr_schedule: Callable,
    R: int,
    *,
    dispatch: Optional[dsp.DispatchConfig] = None,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
):
    """Round program for Algorithm 2: rounds close at every step where
    any worker syncs, so the head steps are uncommunicated and the tail
    carries the per-worker sync row.  ``(state, batch_block, tail_flags,
    rng=None) -> (state, losses [L])``; bit for bit the per-step
    trajectories.  Drive with :func:`run_rounds`."""
    engine_super = engine.make_superstep(
        grad_fn, inner_opt, operator, lr_schedule, R, dispatch=dispatch,
        global_rounds=False, downlink=downlink, leaf_ledger=leaf_ledger,
        aggregate=aggregate)
    return engine.Superstep(
        engine_super.runner, R, engine_super.check,
        to_runner=lambda s: engine.EngineState(*s),
        from_runner=lambda s: AsyncQsparseState(*s))


def make_fault_step(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    operator,
    lr_schedule: Callable,
    R: int,
    *,
    queue_depth: int,
    dispatch: Optional[dsp.DispatchConfig] = None,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
    staleness_weight: str = "uniform",
):
    """The *executed* Algorithm-2 staleness regime (the engine's fault
    runtime, DESIGN.md §9): a payload computed at t is applied to the
    master at t + τ out of a per-worker in-flight queue, with worker
    crash / recover and payload drops from ``scenarios.FaultSpec``.  The
    step takes ``(state, batch, fault_row, rng=None)`` with ``fault_row``
    an ``engine.FaultRow``; allocate the state with ``init(...,
    queue_depth=queue_depth)`` (the fault spec's ``depth``).  Drive with
    :func:`run_faults`."""
    engine_step = engine.make_fault_step(
        grad_fn, inner_opt, operator, lr_schedule, R,
        queue_depth=queue_depth, dispatch=dispatch, global_rounds=False,
        downlink=downlink, leaf_ledger=leaf_ledger, aggregate=aggregate,
        staleness_weight=staleness_weight)

    def step_fn(state: AsyncQsparseState, batch, fault_row, rng=None):
        new, loss = engine_step(engine.EngineState(*state), batch,
                                fault_row, rng)
        return AsyncQsparseState(*new), loss

    return step_fn


def run(state, step_fn, batches, sync_mask, rng=None):
    """Drive T steps; ``sync_mask`` is bool[T, R] from
    ``schedule.async_schedule``."""
    return engine.run(state, step_fn, batches, sync_mask, rng)


def run_rounds(state, superstep, batches, sync_mask, rng=None):
    """Drive the schedule (bool[T, R]) round by round: rounds close at
    the steps where any worker syncs (``core/rounds.py``)."""
    return engine.run_rounds(state, superstep, batches, sync_mask, rng)


def run_faults(state, step_fn, batches, sync_mask, tables, rng=None):
    """Drive the executed-staleness regime: ``sync_mask`` bool[T, R] plus
    the FaultSpec's expanded ``tables(T, R)``."""
    new, losses = engine.run_faults(state, step_fn, batches, sync_mask,
                                    tables, rng)
    return AsyncQsparseState(*new), losses
