"""Algorithm 1 in the port (``repro_torch.core.qsparse``): the
algorithmic checks of ``tests/test_qsparse.py`` on the port, and parity
with ``repro.core.qsparse`` on the same numpy inputs.

The seven algorithmic checks run the port alone (vanilla-SGD and
local-SGD equivalence, convergence to a neighbourhood, the memory bounds
of Lemmas 4 and 5, the bits ledger, the virtual-sequence identity of
Lemma 6), with the reference test's problem and bounds, on numpy data.

The parity checks drive both wrappers' ``run`` over the same inputs with
deterministic operators through the kernel path (``mode="kernel"``:
Pallas in interpret mode against the port's plain kernel versions):
with and without a compressed downlink, with the per-group ledger on.
Ledgers (bits, bits_down, rounds and both group vectors) must be equal;
state tensors, ``memory_sq_norms`` and ``local_deviation_sq`` agree to
rtol 1e-5 / atol 1e-6: XLA contracts the master's ``Σ g / R`` and the
optimizer's ``p - lr * d`` into fused multiply-adds where eager PyTorch
rounds each operation, an ulp a step (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops, qsparse as jq
from repro.kernels.dispatch import DispatchConfig as JDispatch
from repro.optim import constant as jconstant, sgd as jsgd
from repro_torch.core import bits as bitlib
from repro_torch.core import engine as teng
from repro_torch.core import operators as ops, qsparse, schedule
from repro_torch.kernels.dispatch import DispatchConfig as TDispatch
from repro_torch.optim import constant, inverse_time, sgd
from repro_torch.tree import tree_leaves, tree_map

R, D = 4, 50


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


def run_alg1(batches, op, T, H, lr):
    params = {"w": torch.zeros(D)}
    inner = sgd()
    state = qsparse.init(params, inner, R, device="cpu")
    step = qsparse.make_step(grad_fn, inner, op, lr, R)
    mask = schedule.fixed_schedule(T, H)
    return qsparse.run(state, step, batches, mask,
                       torch.Generator().manual_seed(3))


def test_identity_h1_equals_vanilla_sgd(problem):
    """gamma=1, H=1 reproduces distributed vanilla SGD."""
    cs, batches = problem
    T, eta = 40, 0.05
    bs = batches(T)
    state, _ = run_alg1(bs, ops.Identity(), T, 1, constant(eta))
    w = torch.zeros(D)
    for c, noise in bs:
        w = w - eta * (w[None] - c + 0.01 * noise).mean(dim=0)
    np.testing.assert_allclose(state.master["w"].numpy(), w.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert state.master_view is None       # the exact broadcast keeps none


def test_identity_local_sgd_equals_manual(problem):
    """gamma=1, H>1 is local SGD with parameter averaging at sync."""
    cs, batches = problem
    T, H, eta = 12, 3, 0.05
    bs = batches(T)
    state, _ = run_alg1(bs, ops.Identity(), T, H, constant(eta))
    ws = torch.zeros((R, D))
    for t, (c, noise) in enumerate(bs):
        ws = ws - eta * (ws - c + 0.01 * noise)
        if (t + 1) % H == 0 or t == T - 1:
            ws = ws.mean(dim=0, keepdim=True).expand(R, D)
    np.testing.assert_allclose(state.master["w"].numpy(), ws[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_compressed_converges_to_neighborhood(problem):
    cs, batches = problem
    opt_pt = cs.mean(dim=0)
    T, H = 1200, 4
    lr = inverse_time(30.0, 200.0)
    state, _ = run_alg1(batches(T), ops.TopK(k=10), T, H, lr)
    err = float(torch.linalg.norm(state.master["w"] - opt_pt))
    assert err < 0.35, err
    state0, _ = run_alg1(batches(T), ops.Identity(), T, H, lr)
    err0 = float(torch.linalg.norm(state0.master["w"] - opt_pt))
    assert err0 < err


def test_memory_lemma5_bound(problem):
    """Lemma 5: E||m||^2 <= 4 eta^2 (1-gamma^2)/gamma^2 H^2 G^2."""
    cs, batches = problem
    T, H, eta = 200, 4, 0.02
    op = ops.TopK(k=10)
    gamma = op.gamma(D)
    state, _ = run_alg1(batches(T), op, T, H, constant(eta))
    mem = float(qsparse.memory_sq_norms(state).mean())
    G2 = float((cs ** 2).sum(dim=1).max()) * 4 + 1.0
    bound = 4 * eta ** 2 * (1 - gamma ** 2) / gamma ** 2 * H ** 2 * G2
    assert mem <= bound, (mem, bound)


def test_memory_contracts_with_decaying_lr(problem):
    """Lemma 4: memory ~ O(eta_t^2) for eta_t = xi/(a+t)."""
    cs, batches = problem
    mems = []
    for T in (200, 800):
        state, _ = run_alg1(batches(T), ops.TopK(k=10), T, 4,
                            inverse_time(20.0, 400.0))
        mems.append(float(qsparse.memory_sq_norms(state).mean()))
    assert mems[1] < mems[0] * 0.6, mems


def test_bits_ledger_matches_schedule(problem):
    cs, batches = problem
    T, H = 40, 4
    state, _ = run_alg1(batches(T), ops.TopK(k=10), T, H, constant(0.05))
    assert state.rounds == len([t for t in range(T)
                                if (t + 1) % H == 0 or t == T - 1])
    assert float(state.bits) == state.rounds * R * bitlib.bits_topk(D, 10)


def test_lemma6_virtual_sequence_identity(problem):
    """Lemma 6: x̂_t − x̃_t == (1/R) Σ_r m_t^{(r)}, with the virtual
    sequence x̃ replayed alongside Algorithm 1."""
    cs, batches = problem
    T, H, eta = 12, 3, 0.05
    bs = batches(T)
    params = {"w": torch.zeros(D)}
    inner = sgd()
    state = qsparse.init(params, inner, R, device="cpu")
    step = qsparse.make_step(grad_fn, inner, ops.TopK(k=5), constant(eta),
                             R)
    mask = schedule.fixed_schedule(T, H)
    virtual = torch.zeros((R, D))
    for t, (c, noise) in enumerate(bs):
        virtual = virtual - eta * (state.local["w"] - c + 0.01 * noise)
        state, _ = step(state, (c, noise), bool(mask[t]))
        np.testing.assert_allclose(
            (state.local["w"].mean(0) - virtual.mean(0)).numpy(),
            state.memory["w"].mean(0).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.local["w"][0].numpy(),
                               state.master["w"].numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# parity with repro.core.qsparse
# ---------------------------------------------------------------------------

T_PAR, H_PAR, RP = 6, 2, 3
SHAPES = {"w": (16, 256), "b": (40,), "blk": {"c": (3, 3, 4, 8),
                                              "d": (8, 128)}}


def _tree(fn, shapes):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def parity_problem(seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32),
                   SHAPES)
    batches = [_tree(lambda s: (3 * rng.standard_normal((RP,) + s)).astype(
        np.float32), SHAPES) for _ in range(T_PAR)]
    return params, batches


def grad_j(params, data):
    g = jax.tree_util.tree_map(lambda p, d: p - d, params, data)
    return 0.5 * sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)), g


def grad_t(params, data):
    g = tree_map(lambda p, d: p - d, params, data)
    return 0.5 * sum((x * x).sum() for x in tree_leaves(g)), g


def _port_tree(tree):
    return tree_map(torch.from_numpy, tree)


OPS = [("topk", {"k": 0.05}), ("row_topk", {"k": 0.1, "row_len": 128}),
       ("row_signtopk", {"k": 0.1, "row_len": 128, "m": 2})]


@pytest.mark.parametrize("op_i,down,leaf_ledger", [
    (op_i, down, True) for op_i in range(len(OPS)) for down in (False, True)
] + [(1, True, False)])
def test_run_matches_repro(op_i, down, leaf_ledger):
    name, kw = OPS[op_i]
    op_j, op_t = jops.make_operator(name, **kw), ops.make_operator(name, **kw)
    # the downlink keeps fewer coordinates than the uplinks change, so
    # its count is k (see tests/test_torch_engine.py)
    down_j, down_t = ((jops.TopK(k=0.02), ops.TopK(k=0.02)) if down
                      else (None, None))
    params, batches = parity_problem(op_i)
    mask = schedule.fixed_schedule(T_PAR, H_PAR)
    st_j = jq.init(jax.tree_util.tree_map(jnp.asarray, params), jsgd(), RP,
                   downlink=down_j, leaf_ledger=leaf_ledger)
    step_j = jq.make_step(grad_j, jsgd(), op_j, jconstant(0.05), RP,
                          dispatch=JDispatch(mode="kernel"), downlink=down_j,
                          leaf_ledger=leaf_ledger)
    st_j, losses_j = jq.run(st_j, step_j,
                            [jax.tree_util.tree_map(jnp.asarray, b)
                             for b in batches], mask, jax.random.PRNGKey(0))
    st_t = qsparse.init(_port_tree(params), sgd(), RP, downlink=down_t,
                        leaf_ledger=leaf_ledger, device="cpu")
    step_t = qsparse.make_step(grad_t, sgd(), op_t, constant(0.05), RP,
                               dispatch=TDispatch(mode="kernel"),
                               downlink=down_t, leaf_ledger=leaf_ledger)
    st_t, losses_t = qsparse.run(st_t, step_t,
                                 [_port_tree(b) for b in batches], mask)
    assert type(st_t).__name__ == "QsparseState"
    assert float(st_t.bits) == float(st_j.bits) > 0
    assert float(st_t.bits_down) == float(st_j.bits_down) > 0
    assert st_t.rounds == int(st_j.rounds) == int(mask.sum())
    assert st_t.step == int(st_j.step) == T_PAR
    assert (st_t.master_view is None) == (st_j.master_view is None) == \
        (not down)
    if leaf_ledger:
        assert teng.leaf_group_names(st_t.master) == ("b", "blk", "w")
        for a, e in ((st_t.leaf_bits, st_j.leaf_bits),
                     (st_t.leaf_bits_down, st_j.leaf_bits_down)):
            assert a.tolist() == np.asarray(e).tolist()
        # the groups add up to the totals (integers below 2^24: exact)
        assert float(st_t.leaf_bits.sum()) == float(st_t.bits)
        assert float(st_t.leaf_bits_down.sum()) == float(st_t.bits_down)
    else:
        assert st_t.leaf_bits is None and st_j.leaf_bits is None
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    trees = ["master", "local", "memory"] + (["master_view", "down_memory"]
                                             if down else [])
    for f in trees:
        for a, e in zip(tree_leaves(getattr(st_t, f)),
                        jax.tree_util.tree_leaves(getattr(st_j, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
    np.testing.assert_allclose(qsparse.memory_sq_norms(st_t).numpy(),
                               np.asarray(jq.memory_sq_norms(st_j)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(qsparse.local_deviation_sq(st_t)),
                               float(jq.local_deviation_sq(st_j)), rtol=1e-5,
                               atol=1e-6)


def test_state_checks_and_unported_runtimes():
    params, batches = parity_problem(5)
    st = qsparse.init(_port_tree(params), sgd(), RP, device="cpu")
    led = qsparse.make_step(grad_t, sgd(), ops.TopK(k=0.1), constant(0.05),
                            RP, leaf_ledger=True)
    with pytest.raises(ValueError, match="leaf_ledger"):
        led(st, _port_tree(batches[0]), True)
    down = qsparse.make_step(grad_t, sgd(), ops.TopK(k=0.1), constant(0.05),
                             RP, downlink=ops.TopK(k=0.1))
    with pytest.raises(ValueError, match="downlink"):
        down(st, _port_tree(batches[0]), True)
    # the round runtime (serial and overlapped) is the step runtime, bit
    # for bit
    kw = dict(leaf_ledger=True, downlink=ops.TopK(k=0.1))
    mask = schedule.fixed_schedule(6, 2)
    outs = []
    for make, drive in (
            (qsparse.make_step, qsparse.run),
            (qsparse.make_superstep, qsparse.run_rounds),
            (qsparse.make_superstep, lambda *a: teng.run_rounds_overlap(
                *a, window=2))):
        fn = make(grad_t, sgd(), ops.TopK(k=0.1), inverse_time(1.0, 5.0),
                  RP, **kw)
        outs.append(drive(qsparse.init(_port_tree(params), sgd(), RP,
                                       device="cpu", **kw),
                          fn, [_port_tree(b) for b in batches[:6]], mask))
    (a, la) = outs[0]
    for b, lb in outs[1:]:
        assert type(b).__name__ == "QsparseState" and la == lb
        assert a.step == b.step == 6 and a.rounds == b.rounds == 3
        for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)
    # a local step leaves the master, the ledgers and the memory alone
    step = qsparse.make_step(grad_t, sgd(), ops.TopK(k=0.1), constant(0.05),
                             RP)
    st2, _ = step(st, _port_tree(batches[0]), False)
    assert float(st2.bits) == 0 and st2.rounds == 0 and st2.step == 1
    assert st2.master is st.master
    assert float(qsparse.memory_sq_norms(st2).sum()) == 0.0
    assert float(qsparse.local_deviation_sq(st2)) > 0.0


@pytest.mark.parametrize("down", [False, True])
def test_run_rounds_matches_repro(down):
    """The round runtime against ``repro``'s ``run_rounds``, to the
    tolerances of :func:`test_run_matches_repro` (ledgers exact)."""
    op_j, op_t = jops.TopK(k=0.05), ops.TopK(k=0.05)
    down_j, down_t = ((jops.TopK(k=0.02), ops.TopK(k=0.02)) if down
                      else (None, None))
    params, batches = parity_problem(3)
    mask = schedule.fixed_schedule(T_PAR, H_PAR)
    sup_j = jq.make_superstep(grad_j, jsgd(), op_j, jconstant(0.05), RP,
                              downlink=down_j, leaf_ledger=True)
    st_j, losses_j = jq.run_rounds(
        jq.init(jax.tree_util.tree_map(jnp.asarray, params), jsgd(), RP,
                downlink=down_j, leaf_ledger=True), sup_j,
        [jax.tree_util.tree_map(jnp.asarray, b) for b in batches], mask,
        jax.random.PRNGKey(0))
    sup_t = qsparse.make_superstep(grad_t, sgd(), op_t, constant(0.05), RP,
                                   downlink=down_t, leaf_ledger=True)
    st_t, losses_t = qsparse.run_rounds(
        qsparse.init(_port_tree(params), sgd(), RP, downlink=down_t,
                     leaf_ledger=True, device="cpu"), sup_t,
        [_port_tree(b) for b in batches], mask)
    assert float(st_t.bits) == float(st_j.bits) > 0
    assert float(st_t.bits_down) == float(st_j.bits_down) > 0
    assert st_t.rounds == int(st_j.rounds) and st_t.step == int(st_j.step)
    assert st_t.leaf_bits.tolist() == np.asarray(st_j.leaf_bits).tolist()
    assert st_t.leaf_bits_down.tolist() == \
        np.asarray(st_j.leaf_bits_down).tolist()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for f in ["master", "local", "memory"] + (["master_view", "down_memory"]
                                              if down else []):
        for a, e in zip(tree_leaves(getattr(st_t, f)),
                        jax.tree_util.tree_leaves(getattr(st_j, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
