"""Training loop driving the unified Qsparse-local-SGD engine (a port of
``repro.train.trainer``'s per-step path).

The synchronous schedule (Algorithm 1) is a [T] mask broadcast to all
workers, the asynchronous one (Algorithm 2) a [T, R] per-worker mask.
Compression dispatches to the CUDA kernels per ``RunConfig.dispatch``
("auto" | "kernel" | "reference"; see kernels/dispatch.py), with
same-bucket leaves of all workers megabuffer-packed into one kernel
launch per bucket per sync round.

Compression comes from ``RunConfig.policy`` (a ``core.policy`` spec
resolved per leaf against the parameters, uplink and optional downlink)
or from the ``operator`` argument plus ``RunConfig.downlink_op``, as in
``repro``.  ``leaf_ledger`` keeps the per-group ledgers in ``History``;
``ckpt_dir`` writes the master as ``step_<N>`` at every ``ckpt_every``
steps and as ``final`` at the end, with the policy in the manifest.

Two runtimes drive the schedule (``RunConfig.runtime``), as in
``repro``:

* ``"round"`` (default): the schedule is segmented into round plans
  (``core/rounds.py``) and each round (the local steps up to a sync, then
  the sync) runs as one program, ``engine.make_superstep``: a CUDA graph
  per round shape on the card, the same body eagerly on the CPU.  Losses
  come back as one tensor per round and the ledger is read once per
  round.  ``overlap`` runs windows of up to ``overlap_window``
  equal-length rounds as one program each (``engine.make_multiround``);
* ``"step"``: the per-step loop, eager.

Trajectories and ``History`` are the same either way: a mid-round log
point reads the ledger of the round before (bits and rounds change only
at syncs), and a mid-round eval or checkpoint reads the master before
the round runs (it too changes only at syncs).

``RunConfig`` keeps the ``repro`` fields that switch a module on.  Those
whose modules have not been ported yet raise ``NotImplementedError``
naming their ROADMAP item; the fields that only tune such a module
(``retune``, ``fault_seed``, ``staleness_weight``) arrive with it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core import engine, policy as pol, schedule as sched
from repro_torch.core.operators import CompressionOp
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.dispatch import DispatchConfig
from repro_torch.optim.transforms import GradientTransform
from repro_torch.train import checkpoint
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
    ckpt_every: int = 0
    target_loss: Optional[float] = None
    dispatch: str = "auto"  # "auto" | "kernel" | "reference"
    pack: bool = True       # megabuffer-pack same-bucket leaves per round
    # "round": one program (a CUDA graph on the card) per sync round;
    # "step": the eager per-step loop.  The same History either way.
    runtime: str = "round"  # "round" | "step"
    # windows of equal-length rounds as one program (round runtime only)
    overlap: bool = False
    overlap_window: int = 8   # most rounds a window (power-of-2 chunks)
    tune: bool = False
    # ``core.policy`` spec: PolicySpec / ChannelSpec / OpSpec or a DSL
    # string; the ``operator`` argument and ``downlink_op`` then stay unset
    policy: Optional[Union[str, pol.PolicySpec, pol.ChannelSpec,
                           pol.OpSpec]] = None
    leaf_ledger: bool = False
    scenario: Optional[Any] = None
    aggregate: str = "mean_R"
    # the pre-policy downlink knob (an operator or a spec string); prefer
    # ``policy="<uplink> >> <downlink>"``
    downlink_op: Optional[Union[CompressionOp, str]] = None
    faults: Optional[Any] = None
    resume: bool = False


#: RunConfig options whose modules are still to be ported: (field, value
#: meaning "unused", the ROADMAP item that brings it)
_NOT_YET = (
    ("scenario", None, "queue 1 item 10 (scenarios)"),
    ("faults", None, "queue 1 item 10 (faults)"),
    ("tune", False, "queue 1 item 11 (kernels/autotune.py)"),
    ("resume", False, "queue 1 item 10 (checkpoint.restore_train_state)"),
)


def _check_ported(run: RunConfig) -> None:
    if run.runtime not in ("round", "step"):
        raise ValueError(f"RunConfig.runtime must be 'round' or 'step', "
                         f"got {run.runtime!r}")
    if run.overlap:
        if run.runtime != "round":
            raise ValueError(
                "RunConfig.overlap requires the round runtime "
                "(runtime='round'); the per-step loop has no rounds "
                "to window")
        if run.faults is not None:
            raise ValueError(
                "RunConfig.overlap is unsupported with fault injection: "
                "the fault runtime's arrival events segment rounds "
                "dynamically (run with overlap=False)")
    for field, unused, item in _NOT_YET:
        if getattr(run, field) != unused:
            raise NotImplementedError(
                f"RunConfig.{field}={getattr(run, field)!r} is not ported "
                f"to repro_torch yet: ROADMAP {item}")


def resolve_run_channels(operator, run: RunConfig, params):
    """(uplink_tree, downlink_tree | None, channel_spec | None) from
    ``run.policy``, or from the ``operator`` argument and
    ``run.downlink_op`` (an operator or a registry-validated spec
    string), as ``repro``'s trainer resolves them.  ``channel_spec`` is
    the serializable spec kept in checkpoints when the policy surface
    was used."""
    if run.policy is not None:
        if operator is not None:
            raise ValueError(
                "pass the compression through RunConfig.policy OR the "
                "operator argument, not both")
        if run.downlink_op is not None:
            raise ValueError(
                "RunConfig.downlink_op conflicts with RunConfig.policy; "
                "put the downlink in the policy ('uplink >> downlink')")
        spec = pol.as_channel_spec(run.policy)
        up, down = spec.resolve(params)
        return up, down, spec
    if operator is None:
        raise ValueError("no compression configured: set RunConfig.policy "
                         "or pass an operator")
    downlink = run.downlink_op
    if isinstance(downlink, str):
        downlink = pol.resolve(downlink, params)
    if isinstance(operator, (str, pol.OpSpec, pol.PolicySpec)):
        operator = pol.resolve(operator, params)
    return operator, downlink, None


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
    # per-leaf-group ledger (RunConfig.leaf_ledger): group names plus,
    # per log point, the cumulative [G] bits per direction
    leaf_groups: list = dataclasses.field(default_factory=list)
    leaf_bits: list = dataclasses.field(default_factory=list)
    leaf_bits_down: list = dataclasses.field(default_factory=list)
    # round runtime: one (start_step, length, n_synced) per round program
    # run; the per-round losses flatten into ``loss`` / ``steps`` above
    round_blocks: list = dataclasses.field(default_factory=list)
    captures: int = 0   # the round runtime's CUDA graphs (0 on the CPU)

    def summary(self) -> dict:
        out = {
            "final_loss": self.loss[-1] if self.loss else None,
            "total_bits": self.bits[-1] if self.bits else 0.0,
            "total_bits_down": self.bits_down[-1] if self.bits_down else 0.0,
            "rounds": self.rounds[-1] if self.rounds else 0,
            "bits_to_target": self.bits_to_target,
            "steps_to_target": self.steps_to_target,
            "wall_time": self.wall_time,
        }
        if self.leaf_groups and self.leaf_bits:
            out["leaf_bits"] = dict(zip(self.leaf_groups,
                                        self.leaf_bits[-1]))
            out["leaf_bits_down"] = dict(zip(self.leaf_groups,
                                             self.leaf_bits_down[-1]))
        return out


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
    rng=None,
) -> tuple[engine.EngineState, History]:
    """Runs Algorithm 1 (or Algorithm 2 when ``run.asynchronous``)
    through the engine, round by round (``run.runtime == "round"``, the
    default) or one step at a time, on ``device`` (default cuda; raises
    when no GPU is present).  ``batches`` yields trees
    whose leaves lead with the worker axis (numpy or tensors).  ``rng``:
    what the stochastic operators draw from, a ``torch.Generator`` or a
    ``core.operators.Uniforms`` feed (default: a generator on ``device``
    seeded with ``run.seed``; a CUDA graph cannot take a feed, so on the
    card a feed needs ``runtime="step"``)."""
    _check_ported(run)
    operator, downlink, channel_spec = resolve_run_channels(operator, run,
                                                            params)
    dev = resolve_device(device)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(run.seed)
    hist = History()
    t0 = time.time()
    dispatch = DispatchConfig(mode=run.dispatch, pack=run.pack)
    state = engine.init(params, inner_opt, run.R, downlink=downlink,
                        leaf_ledger=run.leaf_ledger, device=dev)
    mask = make_mask(run)
    ckpt_policy = None if channel_spec is None else channel_spec.to_dict()
    if run.leaf_ledger:
        hist.leaf_groups = list(engine.leaf_group_names(state.master))

    # per-step bookkeeping, shared by both runtimes: ``led`` is the
    # ledger the step's state holds (in the round runtime a mid-round
    # step reads the round before's, which is the per-step value)
    recent = []

    def snapshot_ledger(st) -> dict:
        led = {"bits": float(st.bits), "bits_down": float(st.bits_down),
               "rounds": int(st.rounds)}
        if run.leaf_ledger:
            led["leaf_bits"] = st.leaf_bits.tolist()
            led["leaf_bits_down"] = st.leaf_bits_down.tolist()
        return led

    def bookkeep_loss(t: int, lossf: float, led: dict) -> None:
        recent.append(lossf)
        if len(recent) > smooth:
            recent.pop(0)
        sm = float(np.mean(recent))
        if (t + 1) % run.log_every == 0 or t == run.total_steps - 1:
            hist.steps.append(t + 1)
            hist.loss.append(sm)
            hist.bits.append(led["bits"])
            hist.bits_down.append(led["bits_down"])
            hist.rounds.append(led["rounds"])
            if run.leaf_ledger:
                hist.leaf_bits.append(list(led["leaf_bits"]))
                hist.leaf_bits_down.append(list(led["leaf_bits_down"]))
        if (run.target_loss is not None and hist.bits_to_target is None
                and sm <= run.target_loss and len(recent) == smooth):
            hist.bits_to_target = led["bits"]
            hist.steps_to_target = t + 1

    def maybe_eval_ckpt(t: int, master) -> None:
        """Eval / checkpoint of step t, on the master the per-step loop
        holds after step t (mid-round: the master before the round)."""
        if eval_fn and run.eval_every and (t + 1) % run.eval_every == 0:
            hist.eval_steps.append(t + 1)
            hist.eval_metrics.append(
                {k: float(v) for k, v in eval_fn(master).items()})
        if run.ckpt_dir and run.ckpt_every and (t + 1) % run.ckpt_every == 0:
            checkpoint.save(f"{run.ckpt_dir}/step_{t + 1}", master,
                            step=t + 1, policy=ckpt_policy)

    book = (snapshot_ledger, bookkeep_loss, maybe_eval_ckpt)
    if run.runtime == "round":
        superstep = engine.make_superstep(
            grad_fn, inner_opt, operator, lr_schedule, run.R,
            dispatch=dispatch, global_rounds=not run.asynchronous,
            downlink=downlink, leaf_ledger=run.leaf_ledger,
            aggregate=run.aggregate)
        state = _drive_rounds(
            state, superstep, batches, mask, rng, run, hist, *book,
            window=run.overlap_window if run.overlap else 1)
        hist.captures = superstep.captures
    else:
        step_fn = engine.make_step(
            grad_fn, inner_opt, operator, lr_schedule, run.R,
            dispatch=dispatch, global_rounds=not run.asynchronous,
            downlink=downlink, leaf_ledger=run.leaf_ledger,
            aggregate=run.aggregate)
        for t, batch in enumerate(batches):
            if t >= run.total_steps:
                break
            batch = tree_map(lambda b: as_tensor(b, dev), batch)
            state, loss = step_fn(state, batch, mask[t], rng)
            bookkeep_loss(t, float(loss), snapshot_ledger(state))
            maybe_eval_ckpt(t, state.master)
    hist.wall_time = time.time() - t0
    if run.ckpt_dir:
        checkpoint.save(f"{run.ckpt_dir}/final", state.master,
                        step=run.total_steps, policy=ckpt_policy)
    return state, hist


def _drive_rounds(state, superstep, batches, mask, rng, run: RunConfig,
                  hist: History, snapshot_ledger, bookkeep_loss,
                  maybe_eval_ckpt, window: int = 1):
    """The round runtime's loop (``repro``'s ``_drive_rounds``, and with
    ``window`` > 1 its ``_drive_rounds_overlap``) over
    ``engine.round_calls``: one program a round, or a window of up to
    ``window`` consecutive equal-length rounds; the [W, L] losses and the
    per-round ledger snapshots read once a call, so every round
    boundary's History entry is the serial rounds'.  A mid-round log
    point reads the round before's ledger (the per-step value).

    Donation: every read of a state (ledger, eval, checkpoint) happens
    before the next call overwrites it.  Rounds holding an eval or
    checkpoint step run alone: their mid-round points (whose per-step
    semantics freeze the previous sync's master) are read before the
    round, the tail's after it."""
    T = run.total_steps
    bounds = set()
    if run.eval_every:
        bounds.update(t for t in range(T) if (t + 1) % run.eval_every == 0)
    if run.ckpt_dir and run.ckpt_every:
        bounds.update(t for t in range(T) if (t + 1) % run.ckpt_every == 0)
    keys = ["bits", "bits_down", "rounds"]
    if run.leaf_ledger:
        keys += ["leaf_bits", "leaf_bits_down"]
    led = snapshot_ledger(state)
    for plans, block, tails in engine.round_calls(batches, mask[:T], window,
                                                  bounds):
        alone = len(plans) == 1
        if alone:
            for i in range(plans[0].length - 1):
                maybe_eval_ckpt(plans[0].start + i, state.master)
        state, losses, leds = superstep.multiround(state, block, tails, rng)
        losses = losses.tolist()
        leds = {k: leds[k].tolist() for k in keys}
        for wi, plan in enumerate(plans):
            round_led = {k: leds[k][wi] for k in keys}
            for i in range(plan.length):
                bookkeep_loss(plan.start + i, losses[wi][i],
                              round_led if i == plan.length - 1 else led)
            hist.round_blocks.append(
                (plan.start, plan.length, int(np.sum(np.asarray(plan.mask)))))
            led = round_led
        if alone:
            maybe_eval_ckpt(plans[0].stop - 1, state.master)
    return state
