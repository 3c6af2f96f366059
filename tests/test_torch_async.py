"""Algorithm 2 in the port (``repro_torch.core.async_qsparse``): the
three algorithm tests of ``tests/test_async.py`` on the port, and parity
with ``repro.core.async_qsparse.run`` on ``async_schedule`` masks.

Parity runs both wrappers over the same numpy inputs with deterministic
operators through the kernel path (Pallas in interpret mode against the
port's plain kernel versions), exact broadcast and compressed downlink,
the per-group ledger on.  Ledgers must be equal (bits, bits_down, rounds
= worker sync events, both group vectors); state tensors agree to rtol
1e-5 / atol 1e-6 (XLA's fused multiply-adds, ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_qsparse as jaq, operators as jops
from repro.core import schedule as jsched
from repro.kernels.dispatch import DispatchConfig as JDispatch
from repro.optim import constant as jconstant, sgd as jsgd
from repro_torch.core import async_qsparse, engine as teng
from repro_torch.core import operators as ops, qsparse, schedule
from repro_torch.kernels.dispatch import DispatchConfig as TDispatch
from repro_torch.optim import constant, inverse_time, sgd
from repro_torch.tree import tree_leaves, tree_map

R, D = 4, 40


def grad_fn(params, data):
    c, noise = data
    g = params["w"] - c + 0.01 * noise
    return 0.5 * ((params["w"] - c) ** 2).sum(), {"w": g}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(1)
    cs = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))

    def batches(T, seed=2):
        r = np.random.default_rng(seed)
        return [(cs, torch.from_numpy(
            r.standard_normal((R, D)).astype(np.float32))) for _ in range(T)]

    return cs, batches


def test_async_all_sync_equals_sync(problem):
    """When every worker syncs every step, Algorithm 2 == Algorithm 1."""
    cs, batches = problem
    op, inner, lr = ops.TopK(k=8), sgd(), constant(0.05)
    params = {"w": torch.zeros(D)}
    s1 = qsparse.init(params, inner, R, device="cpu")
    f1 = qsparse.make_step(grad_fn, inner, op, lr, R)
    s2 = async_qsparse.init(params, inner, R, device="cpu")
    f2 = async_qsparse.make_step(grad_fn, inner, op, lr, R)
    all_on = np.ones((R,), bool)
    for b in batches(30):
        s1, _ = f1(s1, b, True)
        s2, _ = f2(s2, b, all_on)
    np.testing.assert_allclose(s1.master["w"].numpy(), s2.master["w"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float(s1.bits) == float(s2.bits)
    assert s2.rounds == R * s1.rounds       # worker sync events


def test_async_converges(problem):
    cs, batches = problem
    T, H = 1200, 4
    op = ops.QuantizedSparsifier(k=8, s=15)
    inner = sgd()
    state = async_qsparse.init({"w": torch.zeros(D)}, inner, R, device="cpu")
    step = async_qsparse.make_step(grad_fn, inner, op,
                                   inverse_time(30.0, 200.0), R)
    mask = schedule.async_schedule(T, R, H, seed=0)
    state, _ = async_qsparse.run(state, step, batches(T), mask,
                                 torch.Generator().manual_seed(4))
    err = float(torch.linalg.norm(state.master["w"] - cs.mean(dim=0)))
    assert err < 0.6, err


def test_async_nonsync_workers_keep_state(problem):
    cs, batches = problem
    inner = sgd()
    state = async_qsparse.init({"w": torch.zeros(D)}, inner, R, device="cpu")
    step = async_qsparse.make_step(grad_fn, inner, ops.TopK(k=8),
                                   constant(0.05), R)
    flags = np.array([True] + [False] * (R - 1))
    state, _ = step(state, batches(1)[0], flags)
    # worker 0 synced: its view is the new master; the others still x0
    np.testing.assert_array_equal(state.master_view["w"][0].numpy(),
                                  state.master["w"].numpy())
    np.testing.assert_array_equal(state.master_view["w"][1].numpy(),
                                  np.zeros(D, np.float32))
    assert float((state.memory["w"][1] ** 2).sum()) == 0.0
    assert float((state.memory["w"][0] ** 2).sum()) > 0.0
    assert state.rounds == 1


# ---------------------------------------------------------------------------
# parity with repro.core.async_qsparse
# ---------------------------------------------------------------------------

T_PAR, H_PAR, RP = 8, 3, 3
SHAPES = {"w": (16, 256), "b": (40,), "blk": {"c": (3, 3, 4, 8)}}


def parity_problem(seed=0):
    rng = np.random.default_rng(seed)

    def tree(fn):
        return {"w": fn(SHAPES["w"]), "b": fn(SHAPES["b"]),
                "blk": {"c": fn(SHAPES["blk"]["c"])}}

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    batches = [tree(lambda s: (3 * rng.standard_normal((RP,) + s)).astype(
        np.float32)) for _ in range(T_PAR)]
    return params, batches


def grad_j(params, data):
    g = jax.tree_util.tree_map(lambda p, d: p - d, params, data)
    return 0.5 * sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)), g


def grad_t(params, data):
    g = tree_map(lambda p, d: p - d, params, data)
    return 0.5 * sum((x * x).sum() for x in tree_leaves(g)), g


@pytest.mark.parametrize("name,kw,down,seed", [
    ("topk", {"k": 0.05}, False, 4),
    ("row_signtopk", {"k": 0.1, "row_len": 128, "m": 2}, False, 5),
    ("topk", {"k": 0.05}, True, 6),
    ("row_topk", {"k": 0.1, "row_len": 128}, True, 7),
])
def test_run_matches_repro(name, kw, down, seed):
    op_j, op_t = jops.make_operator(name, **kw), ops.make_operator(name, **kw)
    down_j, down_t = ((jops.TopK(k=0.02), ops.TopK(k=0.02)) if down
                      else (None, None))
    mask = schedule.async_schedule(T_PAR, RP, H_PAR, seed=seed)
    np.testing.assert_array_equal(
        mask, jsched.async_schedule(T_PAR, RP, H_PAR, seed=seed))
    assert not mask.all(axis=1).all()       # some steps sync a subset only
    params, batches = parity_problem(seed)
    st_j = jaq.init(jax.tree_util.tree_map(jnp.asarray, params), jsgd(), RP,
                    downlink=down_j, leaf_ledger=True)
    step_j = jaq.make_step(grad_j, jsgd(), op_j, jconstant(0.05), RP,
                           dispatch=JDispatch(mode="kernel"), downlink=down_j,
                           leaf_ledger=True)
    st_j, losses_j = jaq.run(st_j, step_j,
                             [jax.tree_util.tree_map(jnp.asarray, b)
                              for b in batches], mask, jax.random.PRNGKey(0))
    st_t = async_qsparse.init(tree_map(torch.from_numpy, params), sgd(), RP,
                              downlink=down_t, leaf_ledger=True,
                              device="cpu")
    step_t = async_qsparse.make_step(grad_t, sgd(), op_t, constant(0.05), RP,
                                     dispatch=TDispatch(mode="kernel"),
                                     downlink=down_t, leaf_ledger=True)
    st_t, losses_t = async_qsparse.run(
        st_t, step_t, [tree_map(torch.from_numpy, b) for b in batches], mask)
    assert type(st_t).__name__ == "AsyncQsparseState"
    assert float(st_t.bits) == float(st_j.bits) > 0
    assert float(st_t.bits_down) == float(st_j.bits_down) > 0
    assert st_t.rounds == int(st_j.rounds) == int(mask.sum())
    assert teng.leaf_group_names(st_t.master) == ("b", "blk", "w")
    assert st_t.leaf_bits.tolist() == np.asarray(st_j.leaf_bits).tolist()
    assert st_t.leaf_bits_down.tolist() == \
        np.asarray(st_j.leaf_bits_down).tolist()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    fields = ["master", "master_view", "local", "memory"] + (
        ["down_memory"] if down else [])
    for f in fields:
        for a, e in zip(tree_leaves(getattr(st_t, f)),
                        jax.tree_util.tree_leaves(getattr(st_j, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6, err_msg=f)


def test_unported_runtimes_raise():
    # the round runtime is ported: it runs, bit for bit the step runtime
    mask = schedule.async_schedule(T_PAR, RP, H_PAR, seed=2)
    params, batches = parity_problem(2)
    outs = []
    for make, drive in ((async_qsparse.make_step, async_qsparse.run),
                        (async_qsparse.make_superstep,
                         async_qsparse.run_rounds)):
        fn = make(grad_t, sgd(), ops.QSGDQuantizer(s=4), constant(0.05), RP,
                  leaf_ledger=True)
        outs.append(drive(
            async_qsparse.init(tree_map(torch.from_numpy, params), sgd(), RP,
                               leaf_ledger=True, device="cpu"),
            fn, [tree_map(torch.from_numpy, b) for b in batches], mask,
            torch.Generator().manual_seed(1)))
    (a, la), (b, lb) = outs
    assert type(b).__name__ == "AsyncQsparseState" and la == lb
    assert a.rounds == b.rounds == int(mask.sum())
    for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    for fn in (async_qsparse.make_fault_step, async_qsparse.run_faults):
        with pytest.raises(NotImplementedError, match="item 10"):
            fn()
    assert async_qsparse.AsyncQsparseState._fields == \
        teng.EngineState._fields


def test_run_rounds_matches_repro():
    """The round runtime against ``repro``'s ``run_rounds`` on an async
    mask, to :func:`test_run_matches_repro`'s tolerances."""
    mask = schedule.async_schedule(T_PAR, RP, H_PAR, seed=5)
    params, batches = parity_problem(5)
    sup_j = jaq.make_superstep(grad_j, jsgd(), jops.TopK(k=0.05),
                               jconstant(0.05), RP, leaf_ledger=True)
    st_j, losses_j = jaq.run_rounds(
        jaq.init(jax.tree_util.tree_map(jnp.asarray, params), jsgd(), RP,
                 leaf_ledger=True), sup_j,
        [jax.tree_util.tree_map(jnp.asarray, b) for b in batches], mask,
        jax.random.PRNGKey(0))
    sup_t = async_qsparse.make_superstep(grad_t, sgd(), ops.TopK(k=0.05),
                                         constant(0.05), RP,
                                         leaf_ledger=True)
    st_t, losses_t = async_qsparse.run_rounds(
        async_qsparse.init(tree_map(torch.from_numpy, params), sgd(), RP,
                           leaf_ledger=True, device="cpu"), sup_t,
        [tree_map(torch.from_numpy, b) for b in batches], mask)
    assert float(st_t.bits) == float(st_j.bits) > 0
    assert float(st_t.bits_down) == float(st_j.bits_down) > 0
    assert st_t.rounds == int(st_j.rounds) == int(mask.sum())
    assert st_t.leaf_bits.tolist() == np.asarray(st_j.leaf_bits).tolist()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for f in ("master", "master_view", "local", "memory"):
        for a, e in zip(tree_leaves(getattr(st_t, f)),
                        jax.tree_util.tree_leaves(getattr(st_j, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
