"""The port's round runtime on the CPU: ``core/rounds.py`` against
``repro.core.rounds``, and ``engine.make_superstep`` / ``run_rounds``
against the port's own per-step ``run``.

The schedule compiler is a numpy copy, so its plans, windows, lengths
and errors must equal ``repro``'s on every mask family of
``test_rounds.py`` / ``test_overlap.py`` (fixed, async, staggered, the
scenario grid, random masks, fault tables).

The round runtime runs the same step body as the per-step runtime, the
learning rates and Adam's bias corrections fed from static buffers
instead of host values; on the CPU there is no graph, so the round body
runs eagerly and must equal ``run`` bit for bit on every state tensor,
every host counter and every ledger.  Against ``repro``'s own
``run_rounds`` it is held to the tolerances of ``test_torch_engine.py``
(``repro``'s step is XLA-compiled, which contracts a few operations into
fused multiply-adds; ledgers exact on tie-free inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import operators as jops
from repro.core import rounds as jrnd
from repro.core import scenarios as jscn
from repro.optim import sgd as jsgd
from repro_torch.core import engine as teng
from repro_torch.core import operators as tops
from repro_torch.core import policy as tpol
from repro_torch.core import rounds as trnd
from repro_torch.core import schedule as tsched
from repro_torch.optim import adam, constant, inverse_time, momentum_sgd, sgd
from repro_torch.tree import tree_leaves
from tests.strategies import mask_grid

R = 4


# ---------------------------------------------------------------------------
# the schedule compiler
# ---------------------------------------------------------------------------


def _staggered(T, Rr, H):
    mask = np.zeros((T, Rr), bool)
    for r in range(Rr):
        for t in range(T):
            if (t + 1) % H == r % H:
                mask[t, r] = True
    return mask


def _masks():
    rng = np.random.default_rng(5)
    out = list(mask_grid(T=24, R=R, H=3))
    out += [("fixed_1d", tsched.fixed_schedule(23, 4)),
            ("staggered", _staggered(20, 3, 4)),
            ("staggered_dense", _staggered(12, 5, 3)),
            ("random", rng.random((30, 3)) < 0.2),
            ("all_false", np.zeros((9, 2), bool)),
            ("trailing", np.array([0, 0, 1, 0, 0, 0, 0], bool))]
    return out


def _same_plans(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p.start, p.length) == (q.start, q.length)
        np.testing.assert_array_equal(np.asarray(p.mask), np.asarray(q.mask))


@pytest.mark.parametrize("name,mask", _masks())
def test_plans_match_repro(name, mask):
    mine, theirs = trnd.compile_rounds(mask), jrnd.compile_rounds(mask)
    _same_plans(mine, theirs)
    np.testing.assert_array_equal(trnd.expand_rounds(mine), mask)
    np.testing.assert_array_equal(trnd.expand_rounds(mine),
                                  jrnd.expand_rounds(theirs))
    assert trnd.round_lengths(mine) == jrnd.round_lengths(theirs)
    T = np.asarray(mask).shape[0]
    for w in (1, 2, 4, 8):
        for bounds in ((), (T // 3, T - 1)):
            a = trnd.window_rounds(mine, max_window=w, boundary_steps=bounds)
            b = jrnd.window_rounds(theirs, max_window=w,
                                   boundary_steps=bounds)
            assert [len(x) for x in a] == [len(x) for x in b]
            _same_plans([p for x in a for p in x], mine)


@pytest.mark.parametrize("spec", ["preset:none", "max_delay=3,seed=2",
                                  "max_delay=2,drop=0.2,crash_rate=0.1,"
                                  "seed=7"])
def test_fault_rounds_match_repro(spec):
    T, Rr = 20, 3
    mask = tsched.async_schedule(T, Rr, 4, seed=1)
    tables = jscn.parse_faults(spec).tables(T, Rr)
    for a, b in zip(trnd.fault_replay(mask, tables),
                    jscn.fault_replay(mask, tables)):
        np.testing.assert_array_equal(a, b)
    for extra in (None, [5, 11]):
        _same_plans(trnd.compile_fault_rounds(mask, tables, extra),
                    jrnd.compile_fault_rounds(mask, tables, extra))


def test_compiler_errors_match_repro():
    assert trnd.compile_rounds(np.zeros((0, 3), bool)) == []
    assert trnd.expand_rounds([], R=3).shape == (0, 3)
    assert trnd.expand_rounds([]).shape == (0,)
    gap = [trnd.RoundPlan(0, 2, np.ones(2, bool)),
           trnd.RoundPlan(3, 1, np.ones(2, bool))]
    empty = [trnd.RoundPlan(0, 0, np.ones(2, bool))]
    for mod, bad in ((trnd, gap), (jrnd, gap), (trnd, empty), (jrnd, empty)):
        with pytest.raises(ValueError):
            mod.expand_rounds(bad)
    for mod in (trnd, jrnd):
        with pytest.raises(ValueError):
            mod.compile_rounds(np.zeros((2, 3, 4), bool))
        with pytest.raises(ValueError):
            mod.window_rounds([], max_window=0)


# ---------------------------------------------------------------------------
# round runtime == per-step runtime, bit for bit
# ---------------------------------------------------------------------------

SHAPES = {"w": (6, 40), "v": {"a": (24,), "b": (3, 5)}}


def _tree(fn):
    return {"w": fn(SHAPES["w"]),
            "v": {k: fn(s) for k, s in SHAPES["v"].items()}}


def problem(T, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    batches = [_tree(lambda s: (2 * rng.standard_normal((R,) + s)).astype(
        np.float32)) for _ in range(T)]
    return params, batches


def grad_t(params, data):
    g = {"w": params["w"] - data["w"],
         "v": {k: params["v"][k] - data["v"][k] for k in params["v"]}}
    return 0.5 * sum((x * x).sum() for x in tree_leaves(g)), g


def assert_same(a, b, la, lb):
    assert la == lb
    xa, xb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    assert len(xa) == len(xb)
    for x, y in zip(xa, xb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:   # host ints, and the int arrays of a count a worker
            np.testing.assert_array_equal(x, y)


def _fixed(T, H):
    return np.broadcast_to(tsched.fixed_schedule(T, H)[:, None],
                           (T, R)).copy()


def _trailing(T, H):
    m = _fixed(T, H)
    m[-2:] = False
    return m


CASES = {
    "sync": dict(mask=lambda: _fixed(11, 3), op=tops.TopK(k=0.1)),
    "async": dict(mask=lambda: tsched.async_schedule(13, R, 4, seed=3),
                  op=tops.TopK(k=0.1)),
    "downlink": dict(mask=lambda: tsched.async_schedule(13, R, 3, seed=1),
                     op=tops.TopK(k=0.1), downlink=tops.TopK(k=0.2)),
    "hetero_leaf_ledger": dict(
        mask=lambda: _fixed(11, 4), leaf_ledger=True,
        op="v->qsgd:s=15;.*->topk:k=0.1"),
    "trailing_partial": dict(mask=lambda: _trailing(13, 4),
                             op=tops.QSGDQuantizer(s=4)),
    "short_stream": dict(mask=lambda: _fixed(12, 4), op=tops.TopK(k=0.1),
                         cut=6),
    "adam_inverse_time": dict(mask=lambda: _fixed(10, 3),
                              op=tops.QSGDQuantizer(s=4), opt=adam(),
                              lr=inverse_time(1.0, 4.0)),
    "mean_S": dict(mask=lambda: tsched.async_schedule(12, R, 3, seed=6),
                   op=tops.TopK(k=0.1), aggregate="mean_S"),
    "support_weighted": dict(mask=lambda: _fixed(9, 3), op=tops.TopK(k=0.1),
                             aggregate="support_weighted",
                             downlink=tops.QSGDQuantizer(s=4)),
}


class _Feed(tops.Uniforms):
    """A ``Uniforms`` feed that makes each draw from a numpy stream, in
    draw order, at the size the draw asks for."""

    def __init__(self, seed: int):
        super().__init__([])
        self.np_rng = np.random.default_rng(seed)

    def draw(self, shape, device):
        return torch.from_numpy(self.np_rng.random(
            tuple(shape), np.float32)).to(device)


def _pair(case, drive, rng_kind="gen", max_programs=None):
    c = CASES[case]
    mask = c["mask"]()
    params, batches = problem(mask.shape[0], seed=len(case))
    batches = batches[:c.get("cut", len(batches))]
    opt = c.get("opt", momentum_sgd(0.9))
    lr = c.get("lr", constant(0.05))
    op = c["op"]
    if isinstance(op, str):
        op = tpol.resolve(op, params)
    kw = dict(global_rounds=case == "sync", downlink=c.get("downlink"),
              leaf_ledger=c.get("leaf_ledger", False),
              aggregate=c.get("aggregate", "mean_R"))
    init = lambda: teng.init(params, opt, R, downlink=kw["downlink"],  # noqa
                             leaf_ledger=kw["leaf_ledger"], device="cpu")
    if rng_kind == "gen":
        rngs = [torch.Generator().manual_seed(9) for _ in range(2)]
    else:
        rngs = [_Feed(2) for _ in range(2)]
    a, la = teng.run(init(), teng.make_step(grad_t, opt, op, lr, R, **kw),
                     batches, mask, rngs[0])
    sup = teng.make_superstep(grad_t, opt, op, lr, R, **kw)
    if max_programs is not None:
        sup.runner.max_programs = max_programs
    b, lb = drive(init(), sup, batches, mask, rngs[1])
    return a, la, b, lb, sup


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_rounds_equals_run(case):
    a, la, b, lb, sup = _pair(case, teng.run_rounds)
    assert_same(a, b, la, lb)
    assert sup.runner.captures == 0 and not sup.runner.graphed
    if case == "short_stream":
        assert a.step == b.step == 6


@pytest.mark.parametrize("case", ["sync", "async", "trailing_partial"])
@pytest.mark.parametrize("bound", [None, 0, 1])
def test_programs_only_for_repeated_shapes(case, bound):
    """A round shape's first run goes through the step directly, keeping
    nothing; a shape that repeats gets a program, at most
    ``max_programs`` (8 by default) of them, and the shapes past that
    keep running directly.  Either way the trajectory is run's."""
    a, la, b, lb, sup = _pair(case, teng.run_rounds, max_programs=bound)
    assert_same(a, b, la, lb)
    counts: dict = {}
    for p in trnd.compile_rounds(CASES[case]["mask"]()):
        key = (p.length, np.asarray(p.mask).tobytes())
        counts[key] = counts.get(key, 0) + 1
    repeated = sum(n >= 2 for n in counts.values())
    assert len(sup.runner.seen) == len(counts)
    assert len(sup.runner.programs) == min(
        repeated, 8 if bound is None else bound)


def test_uniforms_feed_runs_eagerly_on_the_cpu():
    a, la, b, lb, _ = _pair("trailing_partial", teng.run_rounds,
                            rng_kind="uniforms")
    assert_same(a, b, la, lb)


def test_state_is_donated_to_the_buffers():
    """The returned state aliases the runner's buffers; passing it back
    copies nothing, passing another state copies it in; two round
    shapes alternate over the same buffers."""
    params, batches = problem(10)
    opt = momentum_sgd(0.9)
    sup = teng.make_superstep(grad_t, opt, tops.TopK(k=0.1), constant(0.05),
                              R)
    st = teng.init(params, opt, R, device="cpu")
    fresh = teng.init(params, opt, R, device="cpu")
    seen = []
    w_ptr = None
    for L, b0 in ((2, 0), (3, 2), (2, 5), (3, 7)):
        st, losses = sup(st, teng.stack_block(batches[b0:b0 + L]), True)
        assert losses.shape == (L,)
        seen.append([x.data_ptr() for x in tree_leaves(tuple(st))
                     if isinstance(x, torch.Tensor)])
        w_ptr = st.master["w"].data_ptr()
    assert all(s == seen[0] for s in seen)
    assert len(sup.runner.programs) == 2 and st.step == 10
    again, _ = sup(fresh, teng.stack_block(batches[:2]), True)
    assert again.step == 2 and again.master["w"].data_ptr() == w_ptr
    want, _ = teng.run(teng.init(params, opt, R, device="cpu"),
                       teng.make_step(grad_t, opt, tops.TopK(k=0.1),
                                      constant(0.05), R),
                       batches[:2], np.array([False, True]))
    assert_same(want, again, [], [])


def test_block_and_state_mismatch():
    params, batches = problem(4)
    sup = teng.make_superstep(grad_t, sgd(), tops.QSGDQuantizer(s=4),
                              constant(0.05), R)
    st = teng.init(params, sgd(), R, device="cpu")
    g = torch.Generator().manual_seed(0)
    st, _ = sup(st, teng.stack_block(batches[:2]), True, g)
    # off the card no graph holds a generator: each call draws from its own
    st, _ = sup(st, teng.stack_block(batches[2:4]), True,
                torch.Generator().manual_seed(0))
    # a block of another dtype is another round shape: run directly the
    # first time, its own program when it repeats
    other = teng.stack_block(batches[2:4])
    other["w"] = other["w"].astype(np.float64)
    st, _ = sup(st, other, True, g)
    assert len(sup.runner.programs) == 1
    st, _ = sup(st, other, True, g)
    assert len(sup.runner.programs) == 2
    # a state of another dtype is not the one the buffers were made for
    st64 = st._replace(master={**st.master,
                               "w": st.master["w"].to(torch.float64)})
    with pytest.raises(ValueError, match="tensors differ"):
        sup(st64, teng.stack_block(batches[:2]), True, g)


# ---------------------------------------------------------------------------
# against repro's round runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_name", ["fixed", "async"])
def test_run_rounds_matches_repro(mask_name):
    T = 10
    mask = (_fixed(T, 3) if mask_name == "fixed"
            else tsched.async_schedule(T, R, 3, seed=2))
    params, batches = problem(T, seed=3)
    t_sup = teng.make_superstep(grad_t, sgd(), tops.TopK(k=0.1),
                                constant(0.05), R, leaf_ledger=True)
    st_t, l_t = teng.run_rounds(
        teng.init(params, sgd(), R, leaf_ledger=True, device="cpu"), t_sup,
        batches, mask)

    def grad_j(p, d):
        g = jax.tree_util.tree_map(lambda a, b: a - b, p, d)
        return 0.5 * sum(jnp.sum(x * x)
                         for x in jax.tree_util.tree_leaves(g)), g

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j_sup = jeng.make_superstep(grad_j, jsgd(), jops.TopK(k=0.1),
                                lambda t: jnp.float32(0.05), R,
                                leaf_ledger=True)
    st_j, l_j = jeng.run_rounds(
        jeng.init(jp, jsgd(), R, leaf_ledger=True), j_sup,
        [jax.tree_util.tree_map(jnp.asarray, b) for b in batches], mask,
        jax.random.PRNGKey(0))
    assert float(st_t.bits) == float(st_j.bits)
    assert float(st_t.bits_down) == float(st_j.bits_down)
    assert st_t.rounds == int(st_j.rounds) and st_t.step == int(st_j.step)
    np.testing.assert_array_equal(st_t.leaf_bits.numpy(),
                                  np.asarray(st_j.leaf_bits))
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    for f in ("master", "local", "memory", "master_view"):
        for a, e in zip(tree_leaves(getattr(st_t, f)),
                        jax.tree_util.tree_leaves(getattr(st_j, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
