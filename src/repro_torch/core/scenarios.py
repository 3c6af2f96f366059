"""Fleet scenario simulator (DESIGN.md §8), a numpy copy of
``repro.core.scenarios``: declarative partial-
participation / straggler / dropout specs compiled to the engine's
``[T, R]`` per-worker sync mask.

The paper's convergence theory (Theorems 1-4) assumes every worker
contributes to every sync round; a production fleet does not.  The
engine already executes *arbitrary* per-worker masks (the generalized
``s ∈ {0,1}^R`` of ``core/engine.py``), so fleet behaviour is purely a
mask-generation problem plus an aggregation-rule question:

  * **participation** — each scheduled sync event survives i.i.d. with
    probability p (a worker that misses its sync keeps training locally
    against its lagging view; its error memory keeps accumulating).
  * **mid-round dropout** — a second, independent thinning applied to
    the survivors: the worker reached the round but its payload was
    lost (network partition, preemption) — statistically identical to
    non-participation at the mask layer, kept as a separate knob so
    specs document *why* a sync is missing and failure-injection tests
    can target it.
  * **stragglers** — a fixed fraction of workers sync k× less often
    (they only land every ``straggler_stale_rounds``-th of their
    scheduled syncs), modelling persistently slow hosts whose
    contributions are k rounds stale.
  * **heterogeneous H** — per-worker local-step periods drawn uniformly
    from ``hetero_H=(lo, hi)`` instead of the shared ``H``.

Masks are plain numpy bool arrays, deterministic in ``seed``; with all
knobs at their defaults ``Scenario().mask(T, R, H)`` is bit-for-bit the
trainer's synchronous fixed schedule, so a scenario run degenerates
exactly to the paper's Algorithm 1/2.

The matching aggregation rules (``aggregate=`` in ``core/engine.py`` /
``core/distributed.py``) are:

  * ``mean_R`` — the paper's Σ/R (divide by the *fleet* size).  Under
    partial participation this silently scales the update by |S|/R;
    :func:`warn_if_biased` emits a one-time warning for such runs.
  * ``mean_S`` — divide by the syncing-subset size |S|; equals mean_R
    bit-for-bit when every worker participates.
  * ``support_weighted`` — FedDropoutAvg-style per-coordinate mean:
    each coordinate is divided by its *survivor count* (the number of
    syncing workers whose compressed payload carried that coordinate),
    with zero-support coordinates falling back to the master value
    (the numerator is exactly zero there, so the guard is the
    ``max(count, 1)`` denominator).  With Identity compression every
    syncing worker supports every coordinate, so it equals mean_S
    bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import policy as pol, schedule as sched

#: aggregation rules understood by the engines (see module docstring)
AGGREGATES = ("mean_R", "mean_S", "support_weighted")


def validate_aggregate(aggregate: str) -> str:
    if aggregate not in AGGREGATES:
        raise ValueError(
            f"unknown aggregate {aggregate!r}; expected one of "
            f"{AGGREGATES} (wire formats moved to wire=, see "
            f"core/distributed.py)")
    return aggregate


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative fleet-behaviour spec; ``mask(T, R, H)`` compiles it.

    All knobs default to the lossless fleet: ``Scenario().mask(T, R, H)``
    is exactly the synchronous fixed schedule broadcast to R workers.
    """

    participation: float = 1.0        # P(scheduled sync survives)
    dropout_mid_round: float = 0.0    # P(survivor drops mid-round)
    straggler_frac: float = 0.0       # fraction of persistently slow workers
    straggler_stale_rounds: int = 4   # stragglers land every k-th sync only
    hetero_H: Optional[tuple] = None  # per-worker H ~ U{lo..hi}; None = shared
    seed: int = 0

    def __post_init__(self):
        if not (0.0 <= self.participation <= 1.0):
            raise ValueError(f"participation must be in [0, 1], "
                             f"got {self.participation}")
        if not (0.0 <= self.dropout_mid_round <= 1.0):
            raise ValueError(f"dropout_mid_round must be in [0, 1], "
                             f"got {self.dropout_mid_round}")
        if not (0.0 <= self.straggler_frac <= 1.0):
            raise ValueError(f"straggler_frac must be in [0, 1], "
                             f"got {self.straggler_frac}")
        if self.straggler_stale_rounds < 1:
            raise ValueError("straggler_stale_rounds must be >= 1")
        if self.hetero_H is not None:
            lo, hi = self.hetero_H
            if not (1 <= int(lo) <= int(hi)):
                raise ValueError(f"hetero_H must be (lo, hi) with "
                                 f"1 <= lo <= hi, got {self.hetero_H}")

    # ---- mask compilation ------------------------------------------------

    def mask(self, T: int, R: int, H: int = 1) -> np.ndarray:
        """The ``[T, R]`` bool sync mask of this scenario.

        Worker r's base schedule is ``fixed_schedule(T, H_r)`` (H_r = H,
        or drawn from ``hetero_H``); stragglers then keep only every
        ``straggler_stale_rounds``-th of their scheduled syncs, and each
        remaining sync event survives participation and mid-round
        dropout independently.  Deterministic in ``seed`` (one
        ``RandomState`` consumed in worker-major order); all-False rows
        and columns are legal engine inputs (pure-local steps / workers
        that never sync).
        """
        if T < 1 or R < 1:
            raise ValueError(f"need T >= 1 and R >= 1, got T={T}, R={R}")
        rng = np.random.RandomState(self.seed)
        if self.hetero_H is not None:
            lo, hi = int(self.hetero_H[0]), int(self.hetero_H[1])
            Hs = rng.randint(lo, hi + 1, size=R)
        else:
            Hs = np.full(R, int(H))
        n_strag = int(round(self.straggler_frac * R))
        stragglers = set(
            rng.choice(R, size=n_strag, replace=False)) if n_strag else set()
        mask = np.zeros((T, R), bool)
        for r in range(R):
            col = sched.fixed_schedule(T, int(Hs[r]))
            events = np.flatnonzero(col)
            if r in stragglers:
                # keep every k-th scheduled sync (1-indexed events), so a
                # straggler's contribution is always ~k rounds stale
                keep = (np.arange(1, len(events) + 1)
                        % self.straggler_stale_rounds) == 0
                events = events[keep]
            if self.participation < 1.0 and len(events):
                events = events[rng.rand(len(events)) < self.participation]
            if self.dropout_mid_round > 0.0 and len(events):
                events = events[
                    rng.rand(len(events)) >= self.dropout_mid_round]
            mask[events, r] = True
        return mask

    # ---- spec string surface --------------------------------------------

    def to_string(self) -> str:
        """Canonical ``k=v,...`` spec string (round-trips via parse)."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v == f.default:
                continue
            if f.name == "hetero_H":
                parts.append(f"hetero_H={int(v[0])}-{int(v[1])}")
            else:
                parts.append(f"{f.name}={v}")
        return ",".join(parts)


#: named fleet presets (``--scenario preset:<name>``)
PRESETS = {
    # the lossless fleet: pure Algorithm-1 schedule
    "lossless": Scenario(),
    # the CI failure-injection profile: partial participation,
    # mid-round payload loss, a slow eighth of the fleet, and
    # heterogeneous local-step periods — every knob nonzero
    "flaky_fleet": Scenario(participation=0.85, dropout_mid_round=0.05,
                            straggler_frac=0.125, straggler_stale_rounds=3,
                            hetero_H=(1, 8), seed=7),
    # isolate one failure mode each
    "dropout": Scenario(participation=0.7, seed=11),
    "stragglers": Scenario(straggler_frac=0.25, straggler_stale_rounds=4,
                           seed=13),
    "hetero": Scenario(hetero_H=(1, 16), seed=17),
}


def parse(spec) -> Scenario:
    """A Scenario from a spec string, preset name, or Scenario.

    Accepts ``"preset:<name>"`` (see :data:`PRESETS`), a ``k=v,...``
    string (``"participation=0.8,straggler_frac=0.1,seed=3"``, with
    ``hetero_H=lo-hi``), or an existing :class:`Scenario` (returned
    as-is).  Unknown keys and presets raise.
    """
    if isinstance(spec, Scenario):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"scenario spec must be a Scenario or str, "
                        f"got {type(spec).__name__}")
    s = spec.strip()
    if s.startswith("preset:"):
        name = s[len("preset:"):]
        try:
            return PRESETS[name]
        except KeyError:
            raise KeyError(
                f"unknown scenario preset {name!r}; available: "
                f"{sorted(PRESETS)}") from None
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(Scenario)}
    for item in filter(None, (p.strip() for p in s.split(","))):
        if "=" not in item:
            raise ValueError(f"bad scenario item {item!r}: expected k=v")
        k, v = (x.strip() for x in item.split("=", 1))
        if k not in fields:
            raise KeyError(f"unknown scenario field {k!r}; available: "
                           f"{sorted(fields)}")
        if k == "hetero_H":
            lo, _, hi = v.partition("-")
            kwargs[k] = (int(lo), int(hi or lo))
        elif k in ("straggler_stale_rounds", "seed"):
            kwargs[k] = int(v)
        else:
            kwargs[k] = float(v)
    return Scenario(**kwargs)


# ---------------------------------------------------------------------------
# mask diagnostics
# ---------------------------------------------------------------------------


def is_partial(mask) -> bool:
    """Does any sync step have a strict subset of workers syncing?
    (the regime where mean_R's Σ/R silently downscales the update)"""
    m = np.asarray(mask, bool)
    if m.ndim == 1:
        return False
    rows = m.sum(axis=1)
    return bool(np.any((rows > 0) & (rows < m.shape[1])))


def participation_of(mask) -> float:
    """Mean fraction of workers syncing over the steps where anyone
    does (1.0 for an all-agree schedule; 0.0 when nothing syncs)."""
    m = np.asarray(mask, bool)
    if m.ndim == 1:
        m = m[:, None]
    any_rows = m.any(axis=1)
    if not any_rows.any():
        return 0.0
    return float(m[any_rows].mean())


def warn_if_biased(mask, aggregate: str) -> bool:
    """One-time warning for the silent Σ/R bias: under partial
    participation ``mean_R`` scales every update down by |S|/R (the
    paper-faithful default, but rarely what a fleet operator means).
    Returns whether the warning condition held."""
    biased = aggregate == "mean_R" and is_partial(mask)
    if biased:
        pol.warn_once(
            "scenario-mean_R-partial",
            "scenario has partial participation (mean fraction "
            f"{participation_of(mask):.2f}) with aggregate='mean_R': "
            "the paper's Σ/R divides by the full fleet size, scaling "
            "each update down by |S|/R. Pass aggregate='mean_S' or "
            "'support_weighted' for unbiased partial-participation "
            "averaging.")
    return biased


# ---------------------------------------------------------------------------
# failure injection (the differential-test surface)
# ---------------------------------------------------------------------------


def inject_dropout(mask, worker: int, step: int) -> np.ndarray:
    """Mask-layer failure: remove worker's sync at ``step`` entirely
    (its payload never arrives; the master round proceeds without it)."""
    m = np.array(mask, bool, copy=True)
    if not m[step, worker]:
        raise ValueError(f"worker {worker} does not sync at step {step}")
    m[step, worker] = False
    return m


def defer_sync(mask, worker: int, step: int, later: int) -> np.ndarray:
    """Stale-arrival failure: worker's sync at ``step`` lands at
    ``later`` instead — the *modelled* form of staleness (the whole
    sync event moves, so the payload is computed late too).  For the
    paper-faithful *executed* form — payload computed at ``step``,
    applied at ``step + τ`` — use :class:`FaultSpec` delays, which keep
    the compute time (and hence the error-feedback algebra) intact."""
    if later <= step:
        raise ValueError(f"deferred step {later} must follow {step}")
    m = inject_dropout(mask, worker, step)
    m[later, worker] = True
    return m


# ---------------------------------------------------------------------------
# fault specs (DESIGN.md §9): executed staleness, crash/recover, drops
# ---------------------------------------------------------------------------


class FaultTables(NamedTuple):
    """Per-step ``[T, R]`` expansion of a :class:`FaultSpec`.

    * ``delay``   — int32, payload computed at t arrives at t+delay[t,r];
    * ``alive``   — bool, worker r is up at step t (a dead worker takes
      no local step, computes no payload, and receives no broadcast);
    * ``recover`` — bool, step t is worker r's first alive step after an
      outage (error memory is lost; local/view re-init from the master);
    * ``drop``    — bool, the payload computed at (t, r) is lost in
      flight (memory was already updated at compute time — the
      error-feedback algebra absorbs the loss over later rounds).

    All tables are deterministic in the spec's ``seed`` (a dedicated
    ``np.random.RandomState`` — a stream fully separate from the run's
    ``torch.Generator``, so enabling faults never perturbs batch
    construction or compression randomness).
    """

    delay: np.ndarray     # int32 [T, R]
    alive: np.ndarray     # bool  [T, R]
    recover: np.ndarray   # bool  [T, R]
    drop: np.ndarray      # bool  [T, R]

    @property
    def depth(self) -> int:
        """In-flight queue depth the engine must allocate: one slot per
        possible outstanding delay (``max observed delay + 1``)."""
        return int(self.delay.max()) + 1 if self.delay.size else 1

    @property
    def trivial(self) -> bool:
        """No faults at all — the tables of ``FaultSpec()``."""
        return (not self.delay.any() and bool(self.alive.all())
                and not self.drop.any())


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault-injection spec; ``tables(T, R)`` expands it.

    All knobs default to the fault-free fleet: ``FaultSpec().tables(T,
    R)`` yields trivial tables (zero delay, everyone alive, no drops),
    under which the fault runtime is bit-for-bit the fault-free one.

    * ``min_delay``/``max_delay`` — payload staleness τ drawn uniformly
      from ``{min_delay..max_delay}`` per computed payload: computed at
      t, applied to the master at t+τ.
    * ``drop`` — probability a computed payload is lost in flight
      (never applied; the uplink error memory was already updated at
      compute time, so the loss is absorbed by error feedback).
    * ``crash`` — deterministic outage windows
      ``((worker, crash_step, recover_step), ...)``: worker is dead for
      steps ``crash_step <= t < recover_step``.  On recovery the worker
      re-initializes from the current master and its error memory is
      lost (zeroed).
    * ``crash_rate``/``mean_outage`` — additionally, each alive worker
      crashes i.i.d. per step with probability ``crash_rate`` for a
      geometric outage of mean ``mean_outage`` steps.
    * ``seed`` — the dedicated fault PRNG seed (``--fault-seed``).
    """

    max_delay: int = 0
    min_delay: int = 0
    drop: float = 0.0
    crash: tuple = ()           # ((worker, crash_step, recover_step), ...)
    crash_rate: float = 0.0
    mean_outage: float = 8.0
    seed: int = 0

    def __post_init__(self):
        if not (0 <= self.min_delay <= self.max_delay):
            raise ValueError(
                f"need 0 <= min_delay <= max_delay, got "
                f"[{self.min_delay}, {self.max_delay}]")
        if not (0.0 <= self.drop <= 1.0):
            raise ValueError(f"drop must be in [0, 1], got {self.drop}")
        if not (0.0 <= self.crash_rate <= 1.0):
            raise ValueError(
                f"crash_rate must be in [0, 1], got {self.crash_rate}")
        if self.mean_outage < 1.0:
            raise ValueError(
                f"mean_outage must be >= 1, got {self.mean_outage}")
        for w in self.crash:
            if len(w) != 3:
                raise ValueError(
                    f"crash window must be (worker, crash, recover), "
                    f"got {w!r}")
            r, c, rec = (int(x) for x in w)
            if r < 0 or c < 0 or rec <= c:
                raise ValueError(
                    f"bad crash window {w!r}: need worker >= 0 and "
                    f"0 <= crash_step < recover_step")

    @property
    def depth(self) -> int:
        """Static queue depth (independent of T/R, so round programs
        are reusable across runs of the same spec)."""
        return int(self.max_delay) + 1

    # ---- table expansion -------------------------------------------------

    def tables(self, T: int, R: int) -> FaultTables:
        """Expand into per-step ``[T, R]`` tables (see FaultTables)."""
        if T < 1 or R < 1:
            raise ValueError(f"need T >= 1 and R >= 1, got T={T}, R={R}")
        rng = np.random.RandomState(self.seed)
        if self.max_delay > self.min_delay:
            delay = rng.randint(self.min_delay, self.max_delay + 1,
                                size=(T, R)).astype(np.int32)
        else:
            delay = np.full((T, R), self.min_delay, np.int32)
        drop = (rng.rand(T, R) < self.drop if self.drop > 0.0
                else np.zeros((T, R), bool))
        alive = np.ones((T, R), bool)
        if self.crash_rate > 0.0:
            # per-worker markov outages: crash i.i.d. per alive step,
            # outage length 1 + geometric(1/mean_outage)
            p_crash = rng.rand(T, R)
            p_len = rng.rand(T, R)
            for r in range(R):
                t = 0
                while t < T:
                    if p_crash[t, r] < self.crash_rate:
                        u = max(p_len[t, r], 1e-12)
                        length = 1 + int(np.floor(
                            np.log(u) / np.log(1.0 - 1.0 /
                                               max(self.mean_outage, 1.0))
                        )) if self.mean_outage > 1.0 else 1
                        alive[t:t + length, r] = False
                        t += length
                    else:
                        t += 1
        for w, c, rec in ((int(a), int(b), int(d)) for a, b, d in self.crash):
            if w < R:
                alive[min(c, T):min(rec, T), w] = False
        recover = np.zeros((T, R), bool)
        recover[1:] = alive[1:] & ~alive[:-1]
        return FaultTables(delay=delay, alive=alive, recover=recover,
                           drop=drop)

    # ---- spec string surface --------------------------------------------

    def to_string(self) -> str:
        """Canonical ``k=v,...`` spec string (round-trips via
        :func:`parse_faults`)."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v == f.default:
                continue
            if f.name == "crash":
                parts.append("crash=" + "+".join(
                    f"{int(r)}@{int(c)}-{int(rec)}" for r, c, rec in v))
            else:
                parts.append(f"{f.name}={v}")
        return ",".join(parts)


#: named fault presets (``--faults preset:<name>``)
FAULT_PRESETS = {
    # the fault-free harness: trivial tables, pins the bit-exactness of
    # the fault runtime against the fault-free one (satellite S1)
    "none": FaultSpec(),
    # staleness only: every payload 0-3 steps late
    "delayed": FaultSpec(max_delay=3, seed=1),
    # staleness + in-flight loss
    "lossy": FaultSpec(max_delay=2, drop=0.1, seed=2),
    # random crash/recover churn on top of delays
    "crashy": FaultSpec(max_delay=2, crash_rate=0.02, mean_outage=6.0,
                        seed=3),
    # the CI fault-smoke profile: one deterministic crash/recover window
    # plus random delays and drops — every fault class exercised
    "chaos": FaultSpec(max_delay=3, drop=0.05,
                       crash=((1, 2, 5),), crash_rate=0.01,
                       mean_outage=4.0, seed=5),
}


def parse_faults(spec) -> FaultSpec:
    """A FaultSpec from a spec string, preset name, or FaultSpec.

    Accepts ``"preset:<name>"`` (see :data:`FAULT_PRESETS`), a
    ``k=v,...`` string (``"max_delay=3,drop=0.1,seed=2"``, with crash
    windows as ``crash=r@c-rec+r2@c2-rec2``), or an existing
    :class:`FaultSpec` (returned as-is).
    """
    if isinstance(spec, FaultSpec):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"fault spec must be a FaultSpec or str, "
                        f"got {type(spec).__name__}")
    s = spec.strip()
    if s.startswith("preset:"):
        name = s[len("preset:"):]
        try:
            return FAULT_PRESETS[name]
        except KeyError:
            raise KeyError(
                f"unknown fault preset {name!r}; available: "
                f"{sorted(FAULT_PRESETS)}") from None
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(FaultSpec)}
    for item in filter(None, (p.strip() for p in s.split(","))):
        if "=" not in item:
            raise ValueError(f"bad fault item {item!r}: expected k=v")
        k, v = (x.strip() for x in item.split("=", 1))
        if k not in fields:
            raise KeyError(f"unknown fault field {k!r}; available: "
                           f"{sorted(fields)}")
        if k == "crash":
            windows = []
            for win in filter(None, v.split("+")):
                r, _, span = win.partition("@")
                c, _, rec = span.partition("-")
                windows.append((int(r), int(c), int(rec)))
            kwargs[k] = tuple(windows)
        elif k in ("max_delay", "min_delay", "seed"):
            kwargs[k] = int(v)
        else:
            kwargs[k] = float(v)
    return FaultSpec(**kwargs)


#: staleness weighting modes for arriving payloads (``--staleness-weight``)
STALENESS_WEIGHTS = ("uniform", "damped")


def validate_staleness_weight(mode: str) -> str:
    if mode not in STALENESS_WEIGHTS:
        raise ValueError(
            f"unknown staleness weight {mode!r}; expected one of "
            f"{STALENESS_WEIGHTS}")
    return mode


def fault_replay(mask, tables: FaultTables):
    """Host-side replay of the fault schedule's *event structure*.

    Returns ``(computed, arrivals, events)``:

    * ``computed [T, R]`` — worker r computes a payload at t
      (scheduled sync AND alive);
    * ``arrivals [T, R]`` — int32 count of payloads *from* worker r
      applied to the master at t (computed at some t' <= t with
      t' + delay == t, not dropped; two payloads from one worker can
      land on the same step; payloads whose arrival lands past T-1
      stay in flight);
    * ``events [T]`` — steps where master/ledger state can change or a
      scheduled sync fires: any scheduled sync row (even with every
      worker crashed — the empty round stays a History round) or any
      arrival.  The round program must close rounds exactly at these
      steps (``rounds.compile_fault_rounds``).
    """
    m = np.asarray(mask, bool)
    if m.ndim == 1:
        m = np.broadcast_to(m[:, None], (m.shape[0], tables.alive.shape[1]))
    T, R = m.shape
    computed = m & tables.alive[:T]
    arrivals = np.zeros((T, R), np.int32)
    src = computed & ~tables.drop[:T]
    for t, r in zip(*np.nonzero(src)):
        a = t + int(tables.delay[t, r])
        if a < T:
            arrivals[a, r] += 1
    events = m.any(axis=1) | (arrivals > 0).any(axis=1)
    return computed, arrivals, events
