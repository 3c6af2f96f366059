"""Qsparse-local-SGD, synchronous (paper Algorithm 1): a port of
``repro.core.qsparse``.

A thin wrapper over the unified engine (``core/engine.py``): Algorithm 1
is the engine's special case where every worker shares one sync index
set I_T, so the per-worker sync mask is ``s_r = sync`` for all r and
every worker's master view equals the true master at all times.  All
sync-phase math lives in the engine; this module keeps ``repro``'s
state and API shape.

Per step t (Algorithm 1 lines 4-20):

  x̂_{t+1/2}^{(r)} = x̂_t^{(r)} - eta_t * d_t^{(r)}      (local step; d
        includes momentum when the inner optimizer has it)

  if t+1 not in I_T:
      x_{t+1} = x_t ;  m_{t+1} = m_t ;  x̂_{t+1} = x̂_{t+1/2}
  else:
      g_t^{(r)} = QComp_k(m_t^{(r)} + x_t - x̂_{t+1/2}^{(r)})
      m_{t+1}^{(r)} = m_t^{(r)} + x_t - x̂_{t+1/2}^{(r)} - g_t^{(r)}
      x_{t+1} = x_t - (1/R) sum_r g_t^{(r)}
      x̂_{t+1}^{(r)} = x_{t+1}

The same engine doubles as every baseline of the paper: vanilla
distributed SGD (Identity, H=1), local SGD (Identity, H>1), TopK-SGD
(TopK, H=1), EF-SignSGD (Sign, H=1), EF-QSGD (QSGDQuantizer, H=1), and
the composed operators at any H.

With the exact broadcast the state carries no master views
(``master_view`` is None): each step rebuilds them as a broadcast of the
master (an ``expand`` view, which the engine reads and never writes).
The round runtime (``make_superstep`` / ``run_rounds``) runs a sync round
as one program, a CUDA graph on the card (``engine.make_superstep``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import channel as chn, engine
from repro_torch.core.operators import CompressionOp
from repro_torch.kernels import dispatch as dsp
from repro_torch.optim.transforms import GradientTransform
from repro_torch.tree import tree_map

class QsparseState(NamedTuple):
    master: Any          # x_t
    local: Any           # x̂_t^{(r)}, leading axis R
    memory: Any          # m_t^{(r)}, leading axis R
    inner: Any           # inner-optimizer state, leading axis R
    step: int
    bits: torch.Tensor   # float32 cumulative uplink bits (sum over workers)
    rounds: int          # sync rounds so far
    # downlink channel state: the views are carried only under a
    # compressed ``downlink=`` (with the exact broadcast they equal the
    # master and are rebuilt as a broadcast)
    master_view: Any = None
    down_memory: Any = None
    bits_down: Optional[torch.Tensor] = None
    # optional per-leaf-group ledgers (leaf_ledger=True)
    leaf_bits: Optional[torch.Tensor] = None
    leaf_bits_down: Optional[torch.Tensor] = None


def _broadcast(tree, R: int):
    """An [R, ...] read-only view of every leaf (no copy)."""
    return tree_map(lambda x: x[None].expand((R,) + tuple(x.shape)), tree)


def _from_engine(e: engine.EngineState, keep_view: bool) -> QsparseState:
    return QsparseState(
        master=e.master, local=e.local, memory=e.memory, inner=e.inner,
        step=e.step, bits=e.bits, rounds=e.rounds,
        master_view=e.master_view if keep_view else None,
        down_memory=e.down_memory, bits_down=e.bits_down,
        leaf_bits=e.leaf_bits, leaf_bits_down=e.leaf_bits_down,
    )


def _to_engine(state: QsparseState, R: int) -> engine.EngineState:
    # with the exact broadcast, all-agree masks keep every view equal to
    # the master; a compressed downlink makes views lag, and they are
    # carried in the state
    view = (state.master_view if state.master_view is not None
            else _broadcast(state.master, R))
    return engine.EngineState(
        master=state.master, master_view=view, local=state.local,
        memory=state.memory, inner=state.inner, step=state.step,
        bits=state.bits, rounds=state.rounds,
        down_memory=state.down_memory, bits_down=state.bits_down,
        leaf_bits=state.leaf_bits, leaf_bits_down=state.leaf_bits_down,
    )


def _keeps_view(downlink) -> bool:
    return not chn.as_channel(downlink, "downlink").is_identity()


def init(params, inner_opt: GradientTransform, R: int, downlink=None,
         leaf_ledger: bool = False, device=None) -> QsparseState:
    """State for ``params`` on ``device`` (default cuda); pass the same
    ``downlink`` and ``leaf_ledger`` to :func:`make_step`."""
    return _from_engine(
        engine.init(params, inner_opt, R, downlink=downlink,
                    leaf_ledger=leaf_ledger, device=device),
        _keeps_view(downlink))


def make_step(
    grad_fn: Callable,              # (params, batch) -> (loss, grads)
    inner_opt: GradientTransform,
    operator: CompressionOp | Any,  # op or tree-of-ops (Corollary 1)
    lr_schedule: Callable,
    R: int,
    *,
    dispatch: Optional[dsp.DispatchConfig] = None,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
):
    """The Algorithm-1 step ``(state, batch, sync, rng=None) ->
    (new_state, mean_loss)``: the engine with an all-agree mask and
    ``global_rounds=True``.  ``sync`` is a host bool, whether t+1 is in
    I_T.  ``downlink``: server→worker compression (None/Identity = exact
    dense broadcast); ``leaf_ledger``: per-group ledgers; ``aggregate``:
    the master's division rule (with all-agree masks "mean_S" equals
    "mean_R").  Pass the same ``downlink`` / ``leaf_ledger`` to
    :func:`init`."""
    engine_step = engine.make_step(
        grad_fn, inner_opt, operator, lr_schedule, R, dispatch=dispatch,
        global_rounds=True, downlink=downlink, leaf_ledger=leaf_ledger,
        aggregate=aggregate)
    keep_view = _keeps_view(downlink)

    def step_fn(state: QsparseState, batch, sync, rng=None):
        mask = np.broadcast_to(np.asarray(sync, dtype=bool).reshape(-1),
                               (R,))
        new, loss = engine_step(_to_engine(state, R), batch, mask, rng)
        return _from_engine(new, keep_view), loss

    return step_fn


def make_superstep(
    grad_fn: Callable,
    inner_opt: GradientTransform,
    operator: CompressionOp | Any,
    lr_schedule: Callable,
    R: int,
    *,
    dispatch: Optional[dsp.DispatchConfig] = None,
    downlink=None,
    leaf_ledger: bool = False,
    aggregate: str = "mean_R",
):
    """Round program for Algorithm 1: ``(state, batch_block, tail_sync,
    rng=None) -> (state, losses [L])`` with ``tail_sync`` the host bool
    "is t+1 in I_T" of the round's last step; bit for bit the per-step
    trajectories (``engine.make_superstep``, whose donation contract it
    keeps).  Drive with :func:`run_rounds`."""
    engine_super = engine.make_superstep(
        grad_fn, inner_opt, operator, lr_schedule, R, dispatch=dispatch,
        global_rounds=True, downlink=downlink, leaf_ledger=leaf_ledger,
        aggregate=aggregate)
    keep_view = _keeps_view(downlink)
    return engine.Superstep(
        engine_super.runner, R, engine_super.check,
        to_runner=lambda s: _to_engine(s, R),
        from_runner=lambda s: _from_engine(s, keep_view))


def run(state: QsparseState, step_fn, batches, sync_mask, rng=None
        ) -> tuple[QsparseState, list[float]]:
    """Drive T steps; ``sync_mask`` is bool[T]."""
    return engine.run(state, step_fn, batches, sync_mask, rng)


def run_rounds(state: QsparseState, superstep, batches, sync_mask,
               rng=None) -> tuple[QsparseState, list[float]]:
    """Drive the schedule (bool[T]) round by round, one superstep call
    a round (``engine.run_rounds``)."""
    return engine.run_rounds(state, superstep, batches, sync_mask, rng)


def memory_sq_norms(state: QsparseState) -> torch.Tensor:
    """||m_t^{(r)}||_2^2 per worker (flattened over the whole tree)."""
    return engine.memory_sq_norms(state)


def local_deviation_sq(state: QsparseState) -> torch.Tensor:
    """(1/R) sum_r ||x̄ - x̂^{(r)}||^2 (Lemma 7/8 quantity)."""
    return engine.local_deviation_sq(state)
