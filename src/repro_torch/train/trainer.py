"""Training loop driving the unified Qsparse-local-SGD engine (a port of
``repro.train.trainer``'s per-step path).

The synchronous schedule (Algorithm 1) is a [T] mask broadcast to all
workers, the asynchronous one (Algorithm 2) a [T, R] per-worker mask.
Compression dispatches to the CUDA kernels per ``RunConfig.dispatch``
("auto" | "kernel" | "reference"; see kernels/dispatch.py), with
same-bucket leaves of all workers megabuffer-packed into one kernel
launch per bucket per sync round.

``RunConfig`` keeps the ``repro`` fields that switch a module on.  Those
whose modules have not been ported yet raise ``NotImplementedError``
naming their ROADMAP item; the fields that only tune such a module
(``ckpt_every``, ``overlap_window``, ``retune``, ``fault_seed``,
``staleness_weight``) arrive with it.  ``runtime`` defaults to
``"step"``, the only runtime so far
(``repro`` pins its round runtime to the step runtime, so ``History`` is
the same either way).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core import engine, schedule as sched
from repro_torch.core.operators import CompressionOp
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.dispatch import DispatchConfig
from repro_torch.optim.transforms import GradientTransform
from repro_torch.tree import tree_map


@dataclasses.dataclass
class RunConfig:
    total_steps: int
    R: int
    H: int = 1
    asynchronous: bool = False
    seed: int = 0
    log_every: int = 50
    eval_every: int = 0
    ckpt_dir: Optional[str] = None
    target_loss: Optional[float] = None
    dispatch: str = "auto"  # "auto" | "kernel" | "reference"
    pack: bool = True       # megabuffer-pack same-bucket leaves per round
    runtime: str = "step"   # "step"; "round" is ROADMAP queue 1 item 9
    overlap: bool = False
    tune: bool = False
    policy: Optional[Union[str, CompressionOp, Any]] = None
    leaf_ledger: bool = False
    scenario: Optional[Any] = None
    aggregate: str = "mean_R"
    downlink_op: Optional[CompressionOp] = None
    faults: Optional[Any] = None
    resume: bool = False


#: RunConfig options whose modules are still to be ported: (field, value
#: meaning "unused", the ROADMAP item that brings it)
_NOT_YET = (
    ("runtime", "step", "queue 1 item 9 (round runtime)"),
    ("overlap", False, "queue 1 item 9 (round runtime, overlap)"),
    ("policy", None, "queue 1 item 6 (core/policy.py)"),
    ("leaf_ledger", False, "queue 1 item 6 (core/policy.py leaf groups)"),
    ("scenario", None, "queue 1 item 10 (scenarios)"),
    ("faults", None, "queue 1 item 10 (faults)"),
    ("tune", False, "queue 1 item 11 (kernels/autotune.py)"),
    ("ckpt_dir", None, "queue 1 item 7 (train/checkpoint.py)"),
    ("resume", False, "queue 1 item 7 (train/checkpoint.py)"),
)


def _check_ported(run: RunConfig) -> None:
    if run.runtime not in ("round", "step"):
        raise ValueError(f"RunConfig.runtime must be 'round' or 'step', "
                         f"got {run.runtime!r}")
    for field, unused, item in _NOT_YET:
        if getattr(run, field) != unused:
            raise NotImplementedError(
                f"RunConfig.{field}={getattr(run, field)!r} is not ported "
                f"to repro_torch yet: ROADMAP {item}")
    if run.downlink_op is not None and not isinstance(run.downlink_op,
                                                      CompressionOp):
        raise NotImplementedError(
            "RunConfig.downlink_op as a spec string needs core/policy.py: "
            "ROADMAP queue 1 item 6; pass a CompressionOp")


@dataclasses.dataclass
class History:
    steps: list = dataclasses.field(default_factory=list)
    loss: list = dataclasses.field(default_factory=list)
    bits: list = dataclasses.field(default_factory=list)
    bits_down: list = dataclasses.field(default_factory=list)
    rounds: list = dataclasses.field(default_factory=list)
    eval_steps: list = dataclasses.field(default_factory=list)
    eval_metrics: list = dataclasses.field(default_factory=list)
    bits_to_target: Optional[float] = None
    steps_to_target: Optional[int] = None
    wall_time: float = 0.0

    def summary(self) -> dict:
        return {
            "final_loss": self.loss[-1] if self.loss else None,
            "total_bits": self.bits[-1] if self.bits else 0.0,
            "total_bits_down": self.bits_down[-1] if self.bits_down else 0.0,
            "rounds": self.rounds[-1] if self.rounds else 0,
            "bits_to_target": self.bits_to_target,
            "steps_to_target": self.steps_to_target,
            "wall_time": self.wall_time,
        }


def make_mask(run: RunConfig) -> np.ndarray:
    """The engine's [T, R] sync mask for this run's schedule."""
    if run.scenario is not None:
        raise NotImplementedError(
            "RunConfig.scenario is not ported to repro_torch yet: ROADMAP "
            "queue 1 item 10 (scenarios)")
    if run.asynchronous:
        return sched.async_schedule(run.total_steps, run.R, run.H,
                                    seed=run.seed)
    fixed = sched.fixed_schedule(run.total_steps, run.H)
    return np.broadcast_to(fixed[:, None], (run.total_steps, run.R)).copy()


def train(
    grad_fn: Callable,                       # (params, batch)->(loss, grads)
    params: Any,
    inner_opt: GradientTransform,
    operator: CompressionOp | Any = None,
    lr_schedule: Callable = None,
    batches: Iterable = None,
    run: RunConfig = None,
    eval_fn: Optional[Callable] = None,      # (master_params) -> metrics dict
    smooth: int = 20,
    device=None,
) -> tuple[engine.EngineState, History]:
    """Runs Algorithm 1 (or Algorithm 2 when ``run.asynchronous``)
    through the engine, one step at a time, on ``device`` (default
    cuda; raises when no GPU is present).  ``batches`` yields trees
    whose leaves lead with the worker axis (numpy or tensors)."""
    _check_ported(run)
    if operator is None:
        raise ValueError("no compression configured: pass an operator")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    hist = History()
    t0 = time.time()
    dispatch = DispatchConfig(mode=run.dispatch, pack=run.pack)
    downlink = run.downlink_op
    state = engine.init(params, inner_opt, run.R, downlink=downlink,
                        device=dev)
    mask = make_mask(run)
    step_fn = engine.make_step(
        grad_fn, inner_opt, operator, lr_schedule, run.R,
        dispatch=dispatch, global_rounds=not run.asynchronous,
        downlink=downlink, aggregate=run.aggregate)

    recent = []
    for t, batch in enumerate(batches):
        if t >= run.total_steps:
            break
        batch = tree_map(lambda b: as_tensor(b, dev), batch)
        state, loss = step_fn(state, batch, mask[t], gen)
        lossf = float(loss)
        recent.append(lossf)
        if len(recent) > smooth:
            recent.pop(0)
        sm = float(np.mean(recent))
        bits = float(state.bits)
        if (t + 1) % run.log_every == 0 or t == run.total_steps - 1:
            hist.steps.append(t + 1)
            hist.loss.append(sm)
            hist.bits.append(bits)
            hist.bits_down.append(float(state.bits_down))
            hist.rounds.append(int(state.rounds))
        if (run.target_loss is not None and hist.bits_to_target is None
                and sm <= run.target_loss and len(recent) == smooth):
            hist.bits_to_target = bits
            hist.steps_to_target = t + 1
        if eval_fn and run.eval_every and (t + 1) % run.eval_every == 0:
            hist.eval_steps.append(t + 1)
            hist.eval_metrics.append(
                {k: float(v) for k, v in eval_fn(state.master).items()})
    hist.wall_time = time.time() - t0
    return state, hist
