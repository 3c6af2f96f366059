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

Fleet scenarios (``scenario``: partial participation, stragglers,
mid-round dropout, heterogeneous H; ``core/scenarios.py``) compile into
the [T, R] mask.  ``faults`` runs the staleness-first fault runtime
(``engine.make_fault_step`` / ``make_fault_superstep``): payloads land
τ steps late, are lost in flight, or come from workers that crash and
recover, from tables expanded with the fault seed.  ``ckpt_dir`` with
``ckpt_every`` also writes full train-state snapshots ``full_step_<N>``
(the round runtime: at the first round boundary at or after each
point), and ``resume`` continues from the latest one.

``RunConfig`` keeps the ``repro`` fields that switch a module on.  Those
whose modules have not been ported yet (``tune``) raise
``NotImplementedError`` naming their ROADMAP item; ``retune``, which
only tunes that module, arrives with it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core import engine, policy as pol, rounds as rnd
from repro_torch.core import scenarios as scn, schedule as sched
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
    # fleet scenario (core/scenarios.py): a Scenario, a "k=v,..." string
    # or "preset:<name>", compiled into the [T, R] mask; mutually
    # exclusive with ``asynchronous``
    scenario: Optional[Union[str, scn.Scenario]] = None
    # the master's division rule: "mean_R" (the paper's Σ/R), "mean_S"
    # or "support_weighted"; mean_R under a partial scenario warns once
    aggregate: str = "mean_R"
    # the pre-policy downlink knob (an operator or a spec string); prefer
    # ``policy="<uplink> >> <downlink>"``
    downlink_op: Optional[Union[CompressionOp, str]] = None
    # fault injection (scenarios.FaultSpec, a "k=v,..." string or
    # "preset:<name>"): the staleness-first fault runtime, its tables
    # expanded from the fault seed (never the run's generator);
    # "preset:none" is bit for bit the fault-free run
    faults: Optional[Union[str, scn.FaultSpec]] = None
    fault_seed: Optional[int] = None       # overrides the spec's seed
    # arriving payloads: "uniform" as computed, "damped" times 1/(1+τ)
    staleness_weight: str = "uniform"
    # continue from the latest full snapshot under ckpt_dir (queue,
    # memories, ledgers, generator, cursor); the batch iterable must
    # replay from the start (the first ``cursor`` batches are skipped)
    resume: bool = False


#: RunConfig options whose modules are still to be ported: (field, value
#: meaning "unused", the ROADMAP item that brings it)
_NOT_YET = (
    ("tune", False, "queue 1 item 11 (kernels/autotune.py)"),
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
    round_shapes: int = 0   # distinct round shapes the round runtime ran

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
        if run.asynchronous:
            raise ValueError(
                "RunConfig.scenario and RunConfig.asynchronous are "
                "mutually exclusive: a scenario already generates the "
                "per-worker mask (use hetero_H for staggered workers)")
        return scn.parse(run.scenario).mask(run.total_steps, run.R,
                                            H=run.H)
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
    card a feed needs ``runtime="step"``; full snapshots and ``resume``
    need a generator)."""
    _check_ported(run)
    operator, downlink, channel_spec = resolve_run_channels(operator, run,
                                                            params)
    dev = resolve_device(device)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(run.seed)
    hist = History()
    t0 = time.time()
    dispatch = DispatchConfig(mode=run.dispatch, pack=run.pack)
    scn.validate_staleness_weight(run.staleness_weight)
    fault_spec = tables = None
    if run.faults is not None:
        fault_spec = scn.parse_faults(run.faults)
        if run.fault_seed is not None:
            fault_spec = dataclasses.replace(fault_spec,
                                             seed=int(run.fault_seed))
    state = engine.init(params, inner_opt, run.R, downlink=downlink,
                        leaf_ledger=run.leaf_ledger, device=dev,
                        queue_depth=fault_spec.depth if fault_spec else None)
    mask = make_mask(run)
    if fault_spec is not None:
        # the tables come from the fault seed's own stream, apart from
        # the run's generator: faults never perturb batches or draws
        tables = fault_spec.tables(run.total_steps, run.R)
    if run.scenario is not None:
        scn.warn_if_biased(mask, run.aggregate)
    ckpt_policy = None if channel_spec is None else channel_spec.to_dict()
    if run.leaf_ledger:
        hist.leaf_groups = list(engine.leaf_group_names(state.master))
    faults_str = fault_spec.to_string() if fault_spec else None

    # ---- crash-consistent resume --------------------------------------
    start = 0
    if run.resume:
        if not run.ckpt_dir:
            raise ValueError("RunConfig.resume needs ckpt_dir")
        full = checkpoint.latest_full(run.ckpt_dir)
        if full is not None:
            path = f"{run.ckpt_dir}/full_step_{full}"
            info = checkpoint.train_state_info(path)
            if info.get("faults") != faults_str:
                raise ValueError(
                    f"resume fault spec mismatch: checkpoint recorded "
                    f"{info.get('faults')!r}, this run derives "
                    f"{faults_str!r}")
            state, rng, _ = checkpoint.restore_train_state(path, state, rng)
            start = int(info["cursor"])
            it0 = iter(batches)
            for _ in range(start):   # the batch stream replays from 0
                next(it0, None)
            batches = it0

    def save_full(t_next: int, st) -> None:
        if not isinstance(rng, torch.Generator):
            raise ValueError("full train-state snapshots keep the run's "
                             "torch.Generator; a Uniforms feed has no state "
                             "to keep (drop ckpt_every or pass a generator)")
        checkpoint.save_train_state(
            f"{run.ckpt_dir}/full_step_{t_next}", st, key=rng,
            cursor=t_next, policy=ckpt_policy, faults=faults_str,
            staleness_weight=run.staleness_weight)

    def full_due(g0: int, L: int) -> bool:
        """Does a round over steps [g0, g0 + L) reach a ckpt point?"""
        return bool(run.ckpt_dir and run.ckpt_every
                    and (g0 + L) // run.ckpt_every > g0 // run.ckpt_every)

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

    book = (snapshot_ledger, bookkeep_loss, maybe_eval_ckpt, save_full,
            full_due)
    kw = dict(dispatch=dispatch, global_rounds=not run.asynchronous,
              downlink=downlink, leaf_ledger=run.leaf_ledger,
              aggregate=run.aggregate)
    fkw = (dict(kw, queue_depth=fault_spec.depth,
                staleness_weight=run.staleness_weight)
           if fault_spec is not None else None)
    if run.runtime == "round":
        if fault_spec is not None:
            superstep = engine.make_fault_superstep(
                grad_fn, inner_opt, operator, lr_schedule, run.R, **fkw)
            state = _drive_fault_rounds(
                state, superstep, batches, mask, tables, rng, run, hist,
                *book, start=start)
        else:
            superstep = engine.make_superstep(
                grad_fn, inner_opt, operator, lr_schedule, run.R, **kw)
            state = _drive_rounds(
                state, superstep, batches, mask, rng, run, hist, *book,
                window=run.overlap_window if run.overlap else 1, start=start)
        hist.captures = superstep.captures
        hist.round_shapes = superstep.shapes
    else:
        if fault_spec is not None:
            rows = engine.fault_rows(mask[:run.total_steps], tables, run.R)
            step_fn = engine.make_fault_step(
                grad_fn, inner_opt, operator, lr_schedule, run.R, **fkw)
        else:
            step_fn = engine.make_step(
                grad_fn, inner_opt, operator, lr_schedule, run.R, **kw)
        for t, batch in enumerate(batches, start=start):
            if t >= run.total_steps:
                break
            batch = tree_map(lambda b: as_tensor(b, dev), batch)
            row = (mask[t] if fault_spec is None
                   else engine.index_rows(rows, t))
            state, loss = step_fn(state, batch, row, rng)
            bookkeep_loss(t, float(loss), snapshot_ledger(state))
            maybe_eval_ckpt(t, state.master)
            if full_due(t, 1):
                save_full(t + 1, state)
    hist.wall_time = time.time() - t0
    if run.ckpt_dir:
        checkpoint.save(f"{run.ckpt_dir}/final", state.master,
                        step=run.total_steps, policy=ckpt_policy)
    return state, hist


def _drive_rounds(state, superstep, batches, mask, rng, run: RunConfig,
                  hist: History, snapshot_ledger, bookkeep_loss,
                  maybe_eval_ckpt, save_full, full_due, window: int = 1,
                  start: int = 0):
    """The round runtime's loop (``repro``'s ``_drive_rounds``, and with
    ``window`` > 1 its ``_drive_rounds_overlap``) over
    ``engine.round_calls``: one program a round, or a window of up to
    ``window`` consecutive equal-length rounds; the [W, L] losses and the
    per-round ledger snapshots read once a call, so every round
    boundary's History entry is the serial rounds'.  A mid-round log
    point reads the round before's ledger (the per-step value).
    ``start``: the global step the (resumed) schedule starts at.

    Donation: every read of a state (ledger, eval, checkpoint, full
    snapshot) happens before the next call overwrites it.  Rounds
    holding an eval or checkpoint step run alone: their mid-round points
    (whose per-step semantics freeze the previous sync's master) are
    read before the round, the tail's and the full snapshot after it."""
    T = run.total_steps
    bounds = set()
    if run.eval_every:
        bounds.update(t - start for t in range(start, T)
                      if (t + 1) % run.eval_every == 0)
    if run.ckpt_dir and run.ckpt_every:
        bounds.update(t - start for t in range(start, T)
                      if (t + 1) % run.ckpt_every == 0)
    keys = ["bits", "bits_down", "rounds"]
    if run.leaf_ledger:
        keys += ["leaf_bits", "leaf_bits_down"]
    led = snapshot_ledger(state)
    for plans, block, tails in engine.round_calls(batches, mask[start:T],
                                                  window, bounds):
        alone = len(plans) == 1
        g0 = start + plans[0].start
        if alone:
            for i in range(plans[0].length - 1):
                maybe_eval_ckpt(g0 + i, state.master)
        state, losses, leds = superstep.multiround(state, block, tails, rng)
        losses = losses.tolist()
        leds = {k: leds[k].tolist() for k in keys}
        for wi, plan in enumerate(plans):
            round_led = {k: leds[k][wi] for k in keys}
            for i in range(plan.length):
                bookkeep_loss(start + plan.start + i, losses[wi][i],
                              round_led if i == plan.length - 1 else led)
            hist.round_blocks.append(
                (start + plan.start, plan.length,
                 int(np.sum(np.asarray(plan.mask)))))
            led = round_led
        if alone:
            maybe_eval_ckpt(start + plans[0].stop - 1, state.master)
            if full_due(g0, plans[0].length):
                # the first state boundary at or after each ckpt point
                save_full(g0 + plans[0].length, state)
    return state


def _drive_fault_rounds(state, superstep, batches, mask, tables, rng,
                        run: RunConfig, hist: History, snapshot_ledger,
                        bookkeep_loss, maybe_eval_ckpt, save_full, full_due,
                        start: int = 0):
    """The round loop of the fault runtime (``repro``'s
    ``_drive_fault_rounds``): rounds close at event steps (scheduled
    syncs, even all-crashed ones, and payload arrivals,
    ``rounds.compile_fault_rounds``), so mid-round ledger reads stay the
    per-step path's.  On resume the restored queue's pending arrivals are
    extra round boundaries.  ``round_blocks`` records the payloads
    applied at each round's tail."""
    T = run.total_steps
    rows = engine.fault_rows(mask[:T], tables, run.R)
    win = engine.index_rows(rows, slice(start, T))
    win_tables = scn.FaultTables(*(np.asarray(x)[start:T] for x in tables))
    extra = None
    if start > 0:
        extra = [int(a) - start for a in np.unique(state.arrive_at)
                 if a >= start]
    plans = rnd.compile_fault_rounds(win.sync, win_tables,
                                     extra_events=extra)
    _, arrivals, _ = scn.fault_replay(win.sync, win_tables)
    led = snapshot_ledger(state)
    it = iter(batches)
    for plan in plans:
        steps = []
        for _ in range(plan.length):
            try:
                steps.append(next(it))
            except StopIteration:
                break
        if not steps:
            break
        L = len(steps)
        g0 = start + plan.start
        block_rows = engine.index_rows(win, slice(plan.start,
                                                  plan.start + L))
        if L < plan.length:
            # truncated block: the steps reached are event-free heads
            block_rows = block_rows._replace(
                sync=np.zeros_like(block_rows.sync))
        for i in range(L - 1):
            maybe_eval_ckpt(g0 + i, state.master)
        state, losses = superstep(state, engine.stack_block(steps),
                                  block_rows, rng)
        losses = losses.tolist()
        new_led = snapshot_ledger(state)
        for i in range(L):
            bookkeep_loss(g0 + i, losses[i], new_led if i == L - 1 else led)
        maybe_eval_ckpt(g0 + L - 1, state.master)
        n_applied = (int(arrivals[plan.start + L - 1].sum())
                     if L == plan.length else 0)
        hist.round_blocks.append((g0, L, n_applied))
        led = new_led
        if full_due(g0, L):
            save_full(g0 + L, state)
        if L < plan.length:
            break
    return state
