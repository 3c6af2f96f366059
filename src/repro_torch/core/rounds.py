"""Schedule compiler of the round runtime: a numpy copy of
``repro.core.rounds``.

A *round* is a maximal run of steps none of which syncs, closed by the
first step where any worker's sync mask fires (or by the end of the
schedule).  ``engine.make_superstep`` runs each round as one program (a
CUDA graph on the card): L - 1 local steps, then the step with the sync
phase at the tail.  This module is the host half: it segments any sync
schedule -- shared ``[T]`` masks (Algorithm 1), per-worker ``[T, R]``
masks (Algorithm 2), staggered, random -- into :class:`RoundPlan`\\ s,
and :func:`expand_rounds` inverts the segmentation exactly.

``RoundPlan(start, length, mask)``: ``start`` the round's first global
step (0-based), ``length`` its steps (>= 1; all but the last are
pure-local), ``mask`` the tail step's sync row (bool[R], or the scalar a
``[T]`` mask carried; all-False for a trailing partial round, whose tail
is a local step too).

In ``repro`` rounds of equal length share one XLA executable (the tail
mask is data there).  The port's sync phase compresses only the syncing
workers, so a round program is keyed by its length AND its tail mask:
a fixed-H schedule captures at most twice (H and the trailing partial
length), an async one once per distinct (length, mask) pair.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class RoundPlan(NamedTuple):
    start: int          # global step index of the round's first step
    length: int         # steps in the round (head locals + tail)
    mask: np.ndarray    # tail-step sync row, bool[R] (or scalar bool)

    @property
    def syncs(self) -> bool:
        """Does any worker sync at this round's tail step?"""
        return bool(np.any(self.mask))

    @property
    def stop(self) -> int:
        """One past the round's last global step index."""
        return self.start + self.length


def _as_rows(mask) -> tuple[np.ndarray, bool]:
    """Normalize a [T] or [T, R] mask to [T, R'] rows + whether the
    caller's rows were scalar (shared/Algorithm-1 form)."""
    m = np.asarray(mask, dtype=bool)
    if m.ndim == 1:
        return m[:, None], True
    if m.ndim != 2:
        raise ValueError(
            f"sync mask must be [T] or [T, R], got shape {m.shape}")
    return m, False


def compile_rounds(mask) -> list[RoundPlan]:
    """Segment a sync schedule into round plans.

    ``mask`` is bool ``[T]`` (shared I_T) or ``[T, R]`` (per-worker
    I_T^{(r)}).  A round closes at every step where *any* worker syncs
    — the engine's sync phase runs whenever ``any(s)`` — so by
    construction every non-tail row of every plan is all-False.  Steps
    after the schedule's last sync form one trailing partial round
    whose tail mask is all-False.
    """
    rows, scalar = _as_rows(mask)
    T = rows.shape[0]
    plans: list[RoundPlan] = []
    start = 0
    any_sync = rows.any(axis=1)
    for t in range(T):
        if any_sync[t]:
            tail = rows[t, 0] if scalar else rows[t].copy()
            plans.append(RoundPlan(start, t - start + 1, np.asarray(tail)))
            start = t + 1
    if start < T:  # trailing partial round: never syncs
        tail = (np.zeros((), bool) if scalar
                else np.zeros(rows.shape[1], bool))
        plans.append(RoundPlan(start, T - start, tail))
    return plans


def expand_rounds(plans: Sequence[RoundPlan], R: int | None = None
                  ) -> np.ndarray:
    """Inverse of :func:`compile_rounds`: rebuild the full [T] / [T, R]
    mask the plans were compiled from (the property the tests pin).

    ``R`` overrides the worker count when the plans carry scalar tail
    masks but the caller wants the broadcast [T, R] form.
    """
    if not plans:
        shape = (0,) if R is None else (0, R)
        return np.zeros(shape, bool)
    T = plans[-1].stop
    tail0 = np.asarray(plans[0].mask)
    if tail0.ndim == 0 and R is None:
        out = np.zeros(T, bool)
    else:
        Rr = tail0.shape[0] if tail0.ndim else R
        out = np.zeros((T, Rr), bool)
    pos = 0
    for p in plans:
        if p.start != pos:
            raise ValueError(
                f"plans are not contiguous: expected start {pos}, "
                f"got {p.start}")
        if p.length < 1:
            raise ValueError(f"round of length {p.length} at step {p.start}")
        out[p.stop - 1] = np.asarray(p.mask)
        pos = p.stop
    return out


def fault_replay(mask, tables):
    """Host-side replay of a fault schedule's event structure (a copy of
    ``repro.core.scenarios.fault_replay``): ``(computed [T, R],
    arrivals [T, R] int32, events [T])`` -- who computes a payload at t,
    how many payloads from worker r land at t, and the steps where a
    scheduled sync fires or a payload lands."""
    m = np.asarray(mask, bool)
    if m.ndim == 1:
        m = np.broadcast_to(m[:, None], (m.shape[0], tables.alive.shape[1]))
    T, R = m.shape
    computed = m & np.asarray(tables.alive)[:T]
    arrivals = np.zeros((T, R), np.int32)
    src = computed & ~np.asarray(tables.drop)[:T]
    for t, r in zip(*np.nonzero(src)):
        a = t + int(tables.delay[t, r])
        if a < T:
            arrivals[a, r] += 1
    events = m.any(axis=1) | (arrivals > 0).any(axis=1)
    return computed, arrivals, events



def compile_fault_rounds(mask, tables, extra_events=None) -> list[RoundPlan]:
    """Segment a sync schedule *under faults* into round plans.

    With a fault spec active, master and
    ledger state can change at steps beyond the scheduled syncs: a
    payload computed at t lands at t+τ, so its *arrival* step is an
    event even when no worker syncs there.  Rounds must close at every
    event step — any scheduled sync row (even one where every worker is
    crashed: the empty round still gets its History entry) or any
    payload arrival — so the round program's heads stay pure-local and
    the trainer's per-round ledger snapshots stay exact.

    ``mask`` is the bool ``[T]``/``[T, R]`` sync schedule and ``tables``
    the expanded fault tables (``delay``, ``alive``, ``drop``, [T, R]
    each, as ``repro.core.scenarios.FaultTables`` holds them).  The
    returned plans carry the *original* tail sync rows (the engine's
    fault superstep takes the full per-step fault rows separately);
    trailing no-event steps form the usual partial round.  With trivial
    tables the segmentation is exactly :func:`compile_rounds`.

    ``extra_events``: additional step indices to close rounds at —
    arrival steps of payloads already in flight when this schedule
    window starts (a crash-consistent resume mid-trajectory restores a
    non-empty queue whose arrivals the window's own replay can't see).
    """
    rows, scalar = _as_rows(mask)
    _, _, events = fault_replay(rows, tables)
    if extra_events is not None:
        events = events.copy()
        for e in extra_events:
            if 0 <= int(e) < events.shape[0]:
                events[int(e)] = True
    T = rows.shape[0]
    plans: list[RoundPlan] = []
    start = 0
    for t in range(T):
        if events[t]:
            tail = rows[t, 0] if scalar else rows[t].copy()
            plans.append(RoundPlan(start, t - start + 1, np.asarray(tail)))
            start = t + 1
    if start < T:
        tail = (np.zeros((), bool) if scalar
                else np.zeros(rows.shape[1], bool))
        plans.append(RoundPlan(start, T - start, tail))
    return plans


def round_lengths(plans: Sequence[RoundPlan]) -> list[int]:
    """Distinct round lengths, in first-appearance order — one capture of
    the superstep per entry and tail mask."""
    seen: list[int] = []
    for p in plans:
        if p.length not in seen:
            seen.append(p.length)
    return seen


def window_rounds(plans: Sequence[RoundPlan], max_window: int = 8,
                  boundary_steps: Sequence[int] = ()
                  ) -> list[list[RoundPlan]]:
    """Group consecutive round plans into dispatch windows for the
    overlapped round driver (``engine.run_rounds_overlap``): each window
    runs as ONE multi-round program (one CUDA graph on the card), so the
    host pays one launch per window instead of one per round.

    Window rules, which keep the overlapped trajectories bit for bit the
    serialized driver's:

    * only consecutive plans of equal ``length`` share a window (the
      stacked batch blocks and tail masks must be rectangular);
    * a plan containing any step in ``boundary_steps`` (0-based, in the
      plans' own index space) is a singleton window: the caller reads
      the state there (eval, checkpoint), so no window runs past it;
    * runs chunk greedily into power-of-two sizes <= ``max_window``, so
      a run of W equal rounds needs O(log W) window programs, not O(W).

    Returns a list of windows (each a non-empty list of contiguous
    plans); concatenating them reproduces ``plans`` exactly.
    """
    if max_window < 1:
        raise ValueError(f"max_window must be >= 1, got {max_window}")
    bounds = sorted(set(int(b) for b in boundary_steps))

    def has_boundary(p: RoundPlan) -> bool:
        return any(p.start <= b < p.stop for b in bounds)

    windows: list[list[RoundPlan]] = []
    run: list[RoundPlan] = []

    def flush():
        nonlocal run
        i = 0
        while i < len(run):
            w = 1
            while w * 2 <= min(max_window, len(run) - i):
                w *= 2
            windows.append(run[i:i + w])
            i += w
        run = []

    for p in plans:
        if has_boundary(p):
            flush()
            windows.append([p])
            continue
        if run and run[-1].length != p.length:
            flush()
        run.append(p)
    flush()
    return windows
