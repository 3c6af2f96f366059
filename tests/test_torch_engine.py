"""The port's engine step against ``repro``'s, step by step.

An elementwise quadratic objective (grad = params - data) gives both
packages identical gradients, so the trajectories differ only where the
engines do.  Covered: a fixed mask and an ``async_schedule`` mask, the
three ``aggregate`` modes, an exact and a compressed downlink, with
deterministic operators through the kernel path (``mode="kernel"``:
Pallas in interpret mode against the port's plain kernel versions).

Each step is checked twice.  The port's step applied to ``repro``'s
state of the step before must give ``repro``'s ledgers (bits,
bits_down, rounds) exactly — the inputs are tie-free, so both pick the
same survivors — and ``repro``'s next state (master, views, local
iterates, memories, momentum, loss) to rtol 1e-6 / atol 1e-6.  And the
port's free-running trajectory must reproduce the ledgers exactly too.
The compressed downlink keeps fewer coordinates (Top_k, k = 2%) than
the uplinks change (5-10% each), so its count is k: a downlink that
kept every non-zero of the master delta would also count the
coordinates where ``view + (master - view)`` did not round back to
``master``, and its ledger would follow the states' last bits.  Not bit for bit, for one
reason: ``repro``'s step is compiled by XLA (``jit``; ``lax.cond``
compiles its branches even when called eagerly), which turns the
master's ``Σ_r g / R`` into a multiply by 1/R and contracts it, and the
optimizer's ``p - lr * mu``, into fused multiply-adds, where eager
PyTorch rounds each operation on its own.  One step differs by an ulp
or so; over many steps momentum compounds those ulps, hence the
one-step comparison.  The sum over workers is taken in the same order
(the port sums the syncing workers, ``repro`` all R with zeros for the
others, which changes no bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import operators as jops
from repro.core import schedule as jsched
from repro.kernels.dispatch import DispatchConfig as JDispatch
from repro.optim import constant as jconstant, momentum_sgd as jmomentum
from repro_torch.core import engine as teng
from repro_torch.core.channel import wire_ledger
from repro_torch.core import operators as tops
from repro_torch.core import schedule as tsched
from repro_torch.kernels.dispatch import DispatchConfig as TDispatch
from repro_torch.optim import constant as tconstant, momentum_sgd as tmomentum
from repro_torch.tree import tree_leaves

R, T = 3, 6
SHAPES = {"w": (16, 256), "b": (40,), "c": (3, 3, 4, 8)}


def grad_j(params, data):
    g = jax.tree_util.tree_map(lambda p, d: p - d, params, data)
    return 0.5 * sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)), g


def grad_t(params, data):
    g = {k: params[k] - data[k] for k in params}
    return 0.5 * sum((x * x).sum() for x in tree_leaves(g)), g


def problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    batches = [{k: (3 * rng.standard_normal((R,) + s)).astype(np.float32)
                for k, s in SHAPES.items()} for _ in range(T)]
    return params, batches


def masks():
    fixed = np.broadcast_to(tsched.fixed_schedule(T, 2)[:, None],
                            (T, R)).copy()
    asyn = tsched.async_schedule(T, R, 3, seed=4)
    np.testing.assert_array_equal(asyn, jsched.async_schedule(T, R, 3,
                                                              seed=4))
    assert not asyn.all(axis=1).all()       # some steps sync a subset only
    return {"fixed": fixed, "async": asyn}


def to_port_state(st_j) -> teng.EngineState:
    """repro's EngineState as the port's (CPU tensors)."""
    conv = lambda tree: (None if tree is None else jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree))
    return teng.EngineState(
        master=conv(st_j.master), master_view=conv(st_j.master_view),
        local=conv(st_j.local), memory=conv(st_j.memory),
        inner=conv(st_j.inner), step=int(st_j.step),
        bits=torch.tensor(float(st_j.bits)), rounds=int(st_j.rounds),
        down_memory=conv(st_j.down_memory),
        bits_down=torch.tensor(float(st_j.bits_down)))


def state_leaves(st, downlink: bool):
    trees = [st.master, st.master_view, st.local, st.memory, st.inner]
    if downlink:
        trees.append(st.down_memory)
    return [np.asarray(l) for t in trees for l in jax.tree_util.tree_leaves(t)]


def state_leaves_t(st, downlink: bool):
    trees = [st.master, st.master_view, st.local, st.memory, st.inner]
    if downlink:
        trees.append(st.down_memory)
    return [l.numpy() for t in trees for l in tree_leaves(t)]


OPS = [("topk", {"k": 0.05}), ("row_topk", {"k": 0.1, "row_len": 128}),
       ("row_signtopk", {"k": 0.1, "row_len": 128, "m": 2}),
       ("signtopk", {"k": 0.05, "m": 1})]


CASES = ([(op_i, m, "mean_R", None) for op_i in range(len(OPS))
          for m in ("fixed", "async")]
         + [(op_i, "async", agg, None) for op_i in (0, 2)
            for agg in ("mean_S", "support_weighted")]
         + [(0, "fixed", "mean_S", None)]
         + [(op_i, m, "mean_R", "topk") for op_i, m in ((0, "fixed"),
                                                       (2, "async"))])


@pytest.mark.parametrize("op_i,mask_name,aggregate,down", CASES)
def test_make_step_matches_repro(op_i, mask_name, aggregate, down):
    name, kw = OPS[op_i]
    op_j, op_t = jops.make_operator(name, **kw), tops.make_operator(name, **kw)
    down_j = down_t = None
    if down:
        down_j, down_t = jops.TopK(k=0.02), tops.TopK(k=0.02)
    mask = masks()[mask_name]
    glob = mask_name == "fixed"
    params, batches = problem(op_i)
    st_j = jeng.init(jax.tree_util.tree_map(jnp.asarray, params),
                     jmomentum(0.9), R, downlink=down_j)
    step_j = jax.jit(jeng.make_step(
        grad_j, jmomentum(0.9), op_j, jconstant(0.05), R,
        dispatch=JDispatch(mode="kernel"), global_rounds=glob,
        downlink=down_j, aggregate=aggregate))
    free = teng.init(params, tmomentum(0.9), R, downlink=down_t,
                     device="cpu")
    step_t = teng.make_step(
        grad_t, tmomentum(0.9), op_t, tconstant(0.05), R,
        dispatch=TDispatch(mode="kernel"), global_rounds=glob,
        downlink=down_t, aggregate=aggregate)
    key = jax.random.PRNGKey(0)
    for t in range(T):
        b = batches[t]
        bt = {k: torch.from_numpy(v) for k, v in b.items()}
        one, loss_t = step_t(to_port_state(st_j), bt, mask[t], None)
        free, _ = step_t(free, bt, mask[t], None)
        st_j, loss_j = step_j(st_j, jax.tree_util.tree_map(jnp.asarray, b),
                              jnp.asarray(mask[t]), key)
        for st in (one, free):
            assert float(st.bits) == float(st_j.bits), t
            assert float(st.bits_down) == float(st_j.bits_down), t
            assert st.rounds == int(st_j.rounds) and st.step == t + 1
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
        for a, e in zip(state_leaves_t(one, bool(down)),
                        state_leaves(st_j, bool(down))):
            np.testing.assert_allclose(a, e, rtol=1e-6, atol=1e-6)
    assert float(free.bits) > 0


def test_engine_run_and_state_checks():
    params, batches = problem(9)
    st = teng.init(params, tmomentum(0.9), R, device="cpu")
    step = teng.make_step(grad_t, tmomentum(0.9), tops.TopK(k=0.1),
                          tconstant(0.05), R)
    mask = tsched.fixed_schedule(T, 3)
    st2, losses = teng.run(st, step, batches, mask)
    assert len(losses) == T and st2.rounds == int(mask.sum()) * R
    led = wire_ledger(st2)
    assert float(led.up) > 0 and float(led.down) > 0
    assert float(led.total) == float(st2.bits + st2.bits_down)
    assert float(st.bits) == 0 and st.step == 0   # the old state stays valid
    assert all(l.device.type == "cpu" for l in tree_leaves(st2.master))
    down_step = teng.make_step(grad_t, tmomentum(0.9), tops.TopK(k=0.1),
                               tconstant(0.05), R, downlink=tops.TopK(k=0.1))
    with pytest.raises(ValueError):
        down_step(st, {k: torch.from_numpy(v) for k, v in batches[0].items()},
                  True)
    with pytest.raises(ValueError):
        teng.make_step(grad_t, tmomentum(0.9), tops.TopK(k=0.1),
                       tconstant(0.05), R, aggregate="median")


def test_init_on_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    params, _ = problem(0)
    with pytest.raises(RuntimeError):
        teng.init(params, tmomentum(0.9), R)
