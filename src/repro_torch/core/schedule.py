"""Synchronization schedules: the paper's index sets I_T and gap(I_T).

A copy of ``repro.core.schedule`` (numpy only), so the port imports
nothing of ``repro``; both packages give identical masks.

Synchronous (Algorithm 1): a single I_T shared by all workers.
Asynchronous (Algorithm 2): per-worker I_T^{(r)} with gap(I_T^{(r)}) <= H;
the paper's experiments draw each worker's next sync offset uniformly
from [1, H] after every sync -- we reproduce exactly that.

Schedules are materialized as boolean masks so they can be consumed
inside jit (via indexing with the step counter) and inspected by tests.
"""

from __future__ import annotations

import numpy as np


def gap(indices) -> int:
    """gap(I_T) = max difference between consecutive sync indices
    (Definition 4).  ``indices`` are 1-based step indices t with t in I_T."""
    idx = sorted(int(i) for i in indices)
    if not idx:
        return 0
    prev = 0
    g = 0
    for t in idx:
        g = max(g, t - prev)
        prev = t
    return g


def fixed_schedule(T: int, H: int) -> np.ndarray:
    """Synchronous: sync at t+1 in {H, 2H, ...} union {T}.

    Returns a bool mask of length T: mask[t] == True iff (t+1) in I_T.
    """
    mask = np.zeros(T, dtype=bool)
    for t in range(T):
        if (t + 1) % H == 0:
            mask[t] = True
    mask[T - 1] = True  # paper requires T in I_T
    return mask


def schedule_from_indices(T: int, indices) -> np.ndarray:
    mask = np.zeros(T, dtype=bool)
    for i in indices:
        if 1 <= i <= T:
            mask[i - 1] = True
    mask[T - 1] = True
    return mask


def async_schedule(T: int, R: int, H: int, seed: int = 0) -> np.ndarray:
    """Asynchronous: per-worker masks, next sync drawn U[1, H] after each
    sync (paper Section 5.2.3).  Returns bool mask [T, R]."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((T, R), dtype=bool)
    for r in range(R):
        t = 0
        while True:
            step = int(rng.randint(1, H + 1))
            t += step
            if t > T:
                break
            mask[t - 1, r] = True
        mask[T - 1, r] = True
    return mask


def worker_gaps(mask: np.ndarray) -> list[int]:
    """gap(I_T^{(r)}) per worker for an async [T, R] mask."""
    T, R = mask.shape
    out = []
    for r in range(R):
        idx = [t + 1 for t in range(T) if mask[t, r]]
        out.append(gap(idx))
    return out
