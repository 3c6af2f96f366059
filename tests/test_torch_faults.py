"""The staleness-first fault runtime (DESIGN.md §9) of the port against
``repro``'s (``core/engine.py``'s ``make_fault_step`` family).

* ``make_fault_step`` against ``repro``'s on the presets none / delayed /
  lossy / crashy / chaos, each under a staleness weighting and an
  aggregation rule (together: both weightings, all three rules), plus a
  compressed downlink with the per-group ledger and a stochastic
  operator whose uniforms replay ``repro``'s key stream (a ``Uniforms``
  feed, as in ``test_torch_convex.py``).  Bits, rounds and the queue's
  host tags are exact; the master, iterates, memories, queue values and
  losses agree to rtol 1e-5 / atol 1e-6 (XLA contracts ``x - lr * g``
  and ``Σg / R`` into fused multiply-adds, PyTorch does not).
* port-only and exact: ``preset:none`` (any fault seed) is
  ``make_step`` bit for bit, and the fault round program is the
  per-step loop bit for bit on ``tests/strategies.py``'s fault grid;
* ``tests/test_faults.py``'s numpy oracle (copied here) replays the
  documented semantics step by step against the port's engine;
* crash / recover, and an all-crashed fleet: nothing is compressed, no
  kernel is launched, the master never moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng, operators as jops
from repro.core import scenarios as jscn
from repro.optim import constant as jconstant, sgd as jsgd
from repro_torch.core import async_qsparse, engine as teng, operators as tops
from repro_torch.core import scenarios as scn, schedule as sched
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.optim import constant, sgd
from repro_torch.tree import tree_leaves, value_and_grad
from strategies import FAULT_GRID

R, D, T, H = 4, 24, 16, 4
LR = 0.05
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def problem():
    """Least squares on a fixed design: index batches [R, 8] a step and
    an Algorithm 2 schedule (``async_schedule``)."""
    rng = np.random.RandomState(0)
    A = rng.randn(64, D).astype(np.float32)
    y = rng.randn(64).astype(np.float32)
    batches = [rng.randint(0, 64, size=(R, 8)) for _ in range(T)]
    mask = sched.async_schedule(T, R, H, seed=3)
    At, yt = torch.from_numpy(A), torch.from_numpy(y)
    grad_t = value_and_grad(
        lambda p, b: 0.5 * ((At[b] @ p["w"] - yt[b]) ** 2).mean())
    Aj, yj = jnp.asarray(A), jnp.asarray(y)

    def grad_j(p, b):
        return jax.value_and_grad(
            lambda pp: 0.5 * jnp.mean((Aj[b] @ pp["w"] - yj[b]) ** 2))(p)

    return grad_t, grad_j, batches, mask


def port_faulty(problem, spec, op, *, rounds=False, rng=None, **kw):
    grad_t, _, batches, mask = problem
    tables = spec.tables(T, R)
    state = teng.init({"w": torch.zeros(D)}, sgd(), R, device="cpu",
                      queue_depth=spec.depth)
    tb = [torch.from_numpy(b) for b in batches]
    make = teng.make_fault_superstep if rounds else teng.make_fault_step
    fn = make(grad_t, sgd(), op, constant(LR), R, queue_depth=spec.depth,
              **kw)
    drive = teng.run_fault_rounds if rounds else teng.run_faults
    state, losses = drive(state, fn, tb, mask, tables, rng)
    return state, losses, fn


def assert_same(a, b) -> None:
    """Every leaf of two states equal (tensors bit for bit, host tags)."""
    for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

#: (preset, staleness weighting, aggregate, global_rounds, extra case)
CASES = [
    ("none", "uniform", "mean_R", False, None),
    ("delayed", "damped", "mean_S", True, None),
    ("lossy", "uniform", "support_weighted", False, None),
    ("crashy", "damped", "mean_R", True, None),
    ("chaos", "uniform", "mean_S", False, None),
    ("chaos", "damped", "support_weighted", True, None),
    ("chaos", "uniform", "mean_R", False, "downlink"),
    ("crashy", "damped", "mean_S", False, "qsgd"),
]


def qsgd_feed(spec, mask, s: int) -> tops.Uniforms:
    """``repro``'s QSGD uniforms for a whole fault run, in the port's
    order: ``run_faults`` splits the key a step, an event step splits
    its subkey over the R workers (``split(sub, R)``) and a worker's key
    over its one leaf; the port draws the computing workers' rows only."""
    tables = spec.tables(T, R)
    rows = teng.fault_rows(mask, tables, R)
    draws = jax.jit(lambda sub: jax.vmap(
        lambda kr: jax.random.uniform(jax.random.split(kr, 1)[0], (D,)))(
            jax.random.split(sub, R)))
    key = jax.random.PRNGKey(42)
    feed = []
    for t in range(T):
        key, sub = jax.random.split(key)
        u = np.asarray(draws(sub))
        feed += [u[r] for r in np.flatnonzero(rows.sync[t] & rows.alive[t])]
    return tops.Uniforms(feed)


@pytest.mark.parametrize("preset,weight,agg,global_rounds,extra", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[4] or 'topk'}"
                              for c in CASES])
def test_fault_step_matches_repro(problem, preset, weight, agg,
                                  global_rounds, extra):
    grad_t, grad_j, batches, mask = problem
    spec = scn.FAULT_PRESETS[preset]
    jspec = jscn.FAULT_PRESETS[preset]
    kw = dict(staleness_weight=weight, aggregate=agg,
              global_rounds=global_rounds)
    if extra == "qsgd":
        op_t, op_j = tops.QSGDQuantizer(s=15), jops.QSGDQuantizer(s=15)
    else:
        op_t, op_j = tops.TopK(k=6), jops.TopK(k=6)
    jkw, ikw_j, ikw_t = dict(kw), {}, {}
    if extra == "downlink":
        ikw_j = dict(downlink=jops.TopK(k=8), leaf_ledger=True)
        ikw_t = dict(downlink=tops.TopK(k=8), leaf_ledger=True)
        jkw.update(ikw_j)
        kw.update(ikw_t)
    state_j = jeng.init({"w": jnp.zeros(D)}, jsgd(), R,
                        queue_depth=jspec.depth, **ikw_j)
    step_j = jeng.make_fault_step(grad_j, jsgd(), op_j, jconstant(LR), R,
                                  queue_depth=jspec.depth, **jkw)
    sj, lj = jeng.run_faults(state_j, step_j, [jnp.asarray(b)
                                               for b in batches],
                             mask, jspec.tables(T, R), jax.random.PRNGKey(42))
    state_t = teng.init({"w": torch.zeros(D)}, sgd(), R, device="cpu",
                        queue_depth=spec.depth, **ikw_t)
    step_t = teng.make_fault_step(grad_t, sgd(), op_t, constant(LR), R,
                                  queue_depth=spec.depth, **kw)
    rng = qsgd_feed(spec, mask, 15) if extra == "qsgd" else None
    st, lt = teng.run_faults(state_t, step_t,
                             [torch.from_numpy(b) for b in batches], mask,
                             spec.tables(T, R), rng)
    if rng is not None:
        assert rng.remaining() == 0
    np.testing.assert_allclose(lt, lj, **TOL)
    for f in ("master", "local", "master_view", "memory", "inflight"):
        np.testing.assert_allclose(getattr(st, f)["w"].numpy(),
                                   np.asarray(getattr(sj, f)["w"]), **TOL,
                                   err_msg=f)
    np.testing.assert_array_equal(st.arrive_at, np.asarray(sj.arrive_at))
    np.testing.assert_array_equal(st.inflight_tau,
                                  np.asarray(sj.inflight_tau))
    assert st.rounds == int(sj.rounds) and st.step == int(sj.step) == T
    if extra == "qsgd":   # value-dependent bits: norms, an ulp apart
        np.testing.assert_allclose(float(st.bits), float(sj.bits), rtol=1e-6)
    else:
        assert float(st.bits) == float(sj.bits) > 0
    assert float(st.bits_down) == float(sj.bits_down)
    if extra == "downlink":
        np.testing.assert_allclose(st.down_memory["w"].numpy(),
                                   np.asarray(sj.down_memory["w"]), **TOL)
        assert st.leaf_bits.tolist() == np.asarray(sj.leaf_bits).tolist()
        assert st.leaf_bits_down.tolist() == \
            np.asarray(sj.leaf_bits_down).tolist()


# ---------------------------------------------------------------------------
# port-only, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", [tops.TopK(k=6),
                                tops.QuantizedSparsifier(k=6, s=15)],
                         ids=["topk", "qtopk"])
def test_trivial_faults_bit_exact(problem, op):
    """``FaultSpec()`` (any seed) is ``make_step``, bit for bit: states,
    ledgers, losses and the generator's draws; the queue holds nothing."""
    grad_t, _, batches, mask = problem
    base = teng.make_step(grad_t, sgd(), op, constant(LR), R)
    sb, lb = teng.run(teng.init({"w": torch.zeros(D)}, sgd(), R,
                                device="cpu"),
                      base, [torch.from_numpy(b) for b in batches], mask,
                      torch.Generator().manual_seed(4))
    sf, lf, _ = port_faulty(problem, scn.FaultSpec(seed=7), op,
                            rng=torch.Generator().manual_seed(4))
    assert lb == lf
    assert_same(sb, sf[:len(sb)])
    assert not sf.inflight["w"].any() and (sf.arrive_at == -1).all()


@pytest.mark.parametrize("spec", FAULT_GRID,
                         ids=[f"spec{i}" for i in range(len(FAULT_GRID))])
def test_fault_round_matches_per_step(problem, spec):
    """The fault round program (each round one program; on the card a
    CUDA graph per repeating shape) is the per-step loop bit for bit."""
    op = tops.TopK(k=6)
    s1, l1, _ = port_faulty(problem, spec, op, aggregate="mean_S",
                            staleness_weight="damped")
    s2, l2, sup = port_faulty(problem, spec, op, rounds=True,
                              aggregate="mean_S", staleness_weight="damped")
    assert l1 == l2
    assert_same(s1, s2)
    assert sup.shapes >= 1 and sup.captures == 0


@pytest.mark.parametrize("spec", FAULT_GRID,
                         ids=[f"spec{i}" for i in range(len(FAULT_GRID))])
def test_engine_matches_numpy_oracle(problem, spec):
    """``tests/test_faults.py``'s oracle: with Identity compression the
    error memory stays zero, so a numpy replay of the §9 semantics
    (compute at t, enqueue, apply at t + τ, broadcast on arrival) gives
    the master trajectory."""
    grad_t, _, batches, mask = problem
    tables = spec.tables(T, R)
    lr = np.float32(LR)
    Dq = spec.depth
    master = np.zeros(D, np.float32)
    local = np.zeros((R, D), np.float32)
    view = np.zeros((R, D), np.float32)
    q = np.zeros((R, Dq, D), np.float32)
    arrive = np.full((R, Dq), -1, np.int64)
    for t in range(T):
        for r in range(R):
            if tables.recover[t, r]:
                local[r] = master
                view[r] = master
        alive = tables.alive[t]
        half = local.copy()
        for r in range(R):
            if alive[r]:
                _, g = grad_t({"w": torch.from_numpy(local[r])},
                              torch.from_numpy(batches[t][r]))
                half[r] = local[r] - lr * g["w"].numpy()
        compute = mask[t] & alive
        if not (compute.any() or (arrive == t).any()):
            local = half
            continue
        slot = t % Dq
        for r in range(R):
            if compute[r] and not tables.drop[t, r]:
                q[r, slot] = view[r] - half[r]    # memory ≡ 0 (Identity)
                arrive[r, slot] = t + int(tables.delay[t, r])
        arr = arrive == t
        master = master - (q * arr[..., None]).sum(axis=(0, 1)) / R
        q[arr] = 0.0
        arrive[arr] = -1
        received = arr.any(axis=1) & alive
        local = half
        for r in range(R):
            if received[r]:
                view[r] = master
                local[r] = master
    state, _, _ = port_faulty(problem, spec, tops.Identity())
    np.testing.assert_allclose(state.master["w"].numpy(), master, **TOL)
    np.testing.assert_allclose(state.local["w"].numpy(), local, **TOL)
    assert not state.memory["w"].any()
    np.testing.assert_array_equal(state.arrive_at, arrive)


def test_crash_freezes_and_recover_reinitializes(problem):
    grad_t, _, batches, mask_ = problem
    crash_t, rec_t, w = 5, 11, 1
    spec = scn.FaultSpec(crash=((w, crash_t, rec_t),))
    mask = np.asarray(mask_, bool).copy()
    mask[rec_t, :] = False            # the recover step takes no sync
    rows = teng.fault_rows(mask, spec.tables(T, R), R)
    state = teng.init({"w": torch.zeros(D)}, sgd(), R, device="cpu",
                      queue_depth=spec.depth)
    step = teng.make_fault_step(grad_t, sgd(), tops.TopK(k=6),
                                constant(LR), R, queue_depth=spec.depth)
    snap = None
    for t in range(rec_t + 1):
        if t == crash_t:
            snap = [x["w"][w].clone() for x in (
                state.local, state.memory, state.master_view)]
        state, _ = step(state, torch.from_numpy(batches[t]),
                        teng.index_rows(rows, t))
        if crash_t <= t < rec_t:
            for x, s in zip((state.local, state.memory, state.master_view),
                            snap):
                assert torch.equal(x["w"][w], s)
    assert not state.memory["w"][w].any()
    before = state.master["w"]
    assert torch.equal(state.master_view["w"][w], before)
    _, g = grad_t({"w": before}, torch.from_numpy(batches[rec_t][w]))
    torch.testing.assert_close(state.local["w"][w], before - LR * g["w"],
                               rtol=1e-6, atol=1e-7)


def test_all_crashed_round_is_noop(problem):
    """A fleet dead for the whole schedule computes no payload: its
    syncs compress no row, so no kernel is launched; the master never
    moves, both ledgers stay zero, no round counts."""
    spec = scn.FaultSpec(crash=tuple((r, 0, T + 1) for r in range(R)))
    from repro_torch.kernels.dispatch import DispatchConfig
    kernel = DispatchConfig(mode="kernel")
    for rounds in (False, True):
        before = sum(LAUNCHES.values())
        state, losses, _ = port_faulty(problem, spec, tops.TopK(k=6),
                                       rounds=rounds, dispatch=kernel)
        assert sum(LAUNCHES.values()) == before
        assert not state.master["w"].any() and not state.local["w"].any()
        assert float(state.bits) == float(state.bits_down) == 0.0
        assert state.rounds == 0
        assert len(losses) == T and np.isfinite(losses).all()
    # the same operator and dispatch do launch on a live fleet
    before = LAUNCHES["topk_compress"]
    port_faulty(problem, scn.FAULT_PRESETS["chaos"], tops.TopK(k=6),
                dispatch=kernel)
    assert LAUNCHES["topk_compress"] > before


def test_async_wrapper_runs_the_fault_runtime(problem):
    """``async_qsparse.make_fault_step`` / ``run_faults`` are the
    engine's (``global_rounds`` False), in the wrapper's state type."""
    grad_t, _, batches, mask = problem
    spec = scn.FAULT_PRESETS["delayed"]
    tb = [torch.from_numpy(b) for b in batches]
    st = async_qsparse.init({"w": torch.zeros(D)}, sgd(), R, device="cpu",
                            queue_depth=spec.depth)
    fn = async_qsparse.make_fault_step(grad_t, sgd(), tops.TopK(k=6),
                                       constant(LR), R,
                                       queue_depth=spec.depth)
    a, la = async_qsparse.run_faults(st, fn, tb, mask, spec.tables(T, R))
    b, lb, _ = port_faulty(problem, spec, tops.TopK(k=6))
    assert type(a).__name__ == "AsyncQsparseState" and la == lb
    assert_same(a, b)
    assert a.rounds == int((mask & spec.tables(T, R).alive).sum())


@pytest.mark.parametrize("runtime", ["step", "round"])
def test_adam_fault_step_matches_repro(problem, runtime):
    """Adam keeps a step count for each worker, as ``repro``'s state
    vmapped over R does: worker 1 crashes (its count stays) and recovers
    (a fresh Adam state, count 0), against ``repro``'s
    ``make_fault_step(..., adam(), ...)``.  The round runtime equals the
    per-step loop bit for bit (a round that recovers runs directly; the
    others replay the counts' deltas).  The operator is the scaled sign:
    Adam's first step after the recovery moves every coordinate by about
    the learning rate, near-ties a Top_k would break by rounding."""
    from repro.optim import adam as jadam
    from repro_torch.optim import adam
    grad_t, grad_j, batches, mask = problem
    spec = scn.FaultSpec(crash=((1, 2, 6),))
    jspec = jscn.FaultSpec(crash=((1, 2, 6),))
    tables = spec.tables(T, R)
    assert not tables.alive.all() and tables.recover.any()
    state_j = jeng.init({"w": jnp.zeros(D)}, jadam(), R,
                        queue_depth=jspec.depth)
    step_j = jeng.make_fault_step(grad_j, jadam(), jops.Sign(),
                                  jconstant(LR), R, queue_depth=jspec.depth)
    sj, lj = jeng.run_faults(state_j, step_j, [jnp.asarray(b)
                                               for b in batches],
                             mask, jspec.tables(T, R), jax.random.PRNGKey(0))

    def port(rounds: bool):
        state = teng.init({"w": torch.zeros(D)}, adam(), R, device="cpu",
                          queue_depth=spec.depth)
        make = teng.make_fault_superstep if rounds else teng.make_fault_step
        fn = make(grad_t, adam(), tops.Sign(), constant(LR), R,
                  queue_depth=spec.depth)
        drive = teng.run_fault_rounds if rounds else teng.run_faults
        return drive(state, fn, [torch.from_numpy(b) for b in batches],
                     mask, tables)

    st, lt = port(runtime == "round")
    np.testing.assert_array_equal(st.inner["count"],
                                  np.asarray(sj.inner["count"]))
    assert st.inner["count"].tolist() != [T] * R
    np.testing.assert_allclose(lt, lj, **TOL)
    for f in ("master", "local", "memory", "inflight"):
        np.testing.assert_allclose(getattr(st, f)["w"].numpy(),
                                   np.asarray(getattr(sj, f)["w"]), **TOL,
                                   err_msg=f)
    for f in ("m", "v"):
        np.testing.assert_allclose(st.inner[f]["w"].numpy(),
                                   np.asarray(sj.inner[f]["w"]), **TOL,
                                   err_msg=f)
    assert float(st.bits) == float(sj.bits) > 0
    assert st.rounds == int(sj.rounds)
    if runtime == "round":
        ss, ls = port(False)
        assert ls == lt
        assert_same(st, ss)


def test_kernels_on_no_live_rows():
    """The compression wrappers return at once on zero rows (a fleet with
    every worker dead), counting no launch, on either route."""
    from repro_torch.kernels import qsgd, topk_compress as tk
    before = dict(LAUNCHES)
    acc = torch.empty((0, 256))
    sel, mem, cnt = tk.topk_compress(acc, 8)
    assert sel.shape == mem.shape == (0, 256) and cnt.shape == (0,)
    idx, val, mem, cnt = tk.topk_compact(acc, 8, 16)
    assert idx.shape == val.shape == (0, 16) and mem.shape == (0, 256)
    assert qsgd.qsgd_quantize(acc, acc, 15).shape == (0, 256)
    assert dict(LAUNCHES) == before
