"""The port's operator → kernel dispatch against ``repro``'s.

``mode="kernel"`` on the CPU runs each kernel's plain version through
the same eligibility rules, megabuffer packing and launch counters as
the card would, so the port is held here to ``repro`` with
``DispatchConfig(mode="kernel")`` (Pallas in interpret mode): outputs,
fused memories, wire bits and ``LAUNCHES`` deltas per call.  Top_k
inputs are tie-free, so ``repro``'s ``lax.top_k`` reference and the
threshold kernel select the same survivors.  Values agree exactly
except where a norm is summed (SignTop_k, QSGD): rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro.kernels import dispatch as jdsp
from repro.kernels.launch_stats import LAUNCHES as JLAUNCHES
from repro_torch.core import operators as tops
from repro_torch.kernels import dispatch as tdsp
from repro_torch.kernels.launch_stats import LAUNCHES as TLAUNCHES


def tie_free(seed, shape, lo=0.05, hi=4.0):
    rng = np.random.default_rng(seed)
    d = int(np.prod(shape))
    mags = np.linspace(lo, hi, d, dtype=np.float32)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mags * signs)[rng.permutation(d)].reshape(shape)


def both(name, **kw):
    return jops.make_operator(name, **kw), tops.make_operator(name, **kw)


OPS = [("topk", {"k": 0.01}), ("row_topk", {"k": 0.05, "row_len": 512}),
       ("row_topk", {"k": 0.1, "row_len": 100}),
       ("signtopk", {"k": 0.01, "m": 2}), ("signtopk", {"k": 0.01, "m": 1}),
       ("row_signtopk", {"k": 0.05, "row_len": 256, "m": 2}),
       ("row_signtopk", {"k": 0.05, "row_len": 256, "m": 1}),
       ("qsgd", {"s": 15}), ("randk", {"k": 0.1}), ("identity", {})]
SHAPES = [(50,), (96, 1024), (1 << 16,), (1 << 17,), (3, 3, 64, 64),
          (1 << 20,), (200, 300)]


@pytest.mark.parametrize("mode", ["kernel", "reference", "auto"])
def test_would_dispatch_matches_repro(mode):
    jcfg = jdsp.DispatchConfig(mode=mode)
    tcfg = tdsp.DispatchConfig(mode=mode)
    for name, kw in OPS:
        op_j, op_t = both(name, **kw)
        for shape in SHAPES:
            want = jdsp.would_dispatch(op_j, shape, cfg=jcfg)
            assert tdsp.would_dispatch(op_t, shape, cfg=tcfg,
                                       device="cpu") == want, (name, shape)
            assert tdsp.would_dispatch(op_t, shape, torch.int32, tcfg,
                                       "cpu") is False
            rule = tdsp.select_rule(op_t, shape, cfg=tcfg, device="cpu")
            jrule = jdsp.select_rule(op_j, shape, cfg=jcfg)
            assert (rule and rule.name) == (jrule and jrule.name)


def test_auto_means_cuda_device():
    """``auto`` dispatches for CUDA tensors with repro's eligibility
    (min_size included) and never for CPU tensors."""
    auto = tdsp.DispatchConfig()
    kernel = tdsp.DispatchConfig(mode="kernel")
    for name, kw in OPS:
        _, op_t = both(name, **kw)
        for shape in SHAPES:
            on_card = tdsp.would_dispatch(op_t, shape, cfg=auto,
                                          device="cuda")
            forced = tdsp.would_dispatch(op_t, shape, cfg=kernel,
                                         device="cpu")
            big = int(np.prod(shape)) >= auto.min_size
            assert on_card == (forced and big), (name, shape)
            assert not tdsp.would_dispatch(op_t, shape, cfg=auto,
                                           device="cpu")
    assert tdsp.rows_eligible(4096, auto, leaf_size=1 << 20, device="cuda")
    assert not tdsp.rows_eligible(4096, auto, leaf_size=100, device="cuda")
    assert not tdsp.rows_eligible(4096, auto, device="cpu")
    assert tdsp.rows_eligible(4096, kernel, device="cpu")
    assert not tdsp.rows_eligible(100, kernel, device="cpu")


MAX_ROW = 1 << 14   # dispatch's max_row, cut from 512Ki to keep this fast


def mixed_tree(seed=0):
    """Leaves of every route: a row of exactly ``MAX_ROW`` (the longest
    dispatch admits), buckets shared by two leaves, a leaf too long for
    a kernel row, and small leaves."""
    return {
        "conv": tie_free(seed, (3, 3, 16, 32)),
        "dense": tie_free(seed + 1, (12, 1024)),
        "dense2": tie_free(seed + 2, (12, 1024)),
        "long": tie_free(seed + 3, (MAX_ROW,)),
        "small": tie_free(seed + 4, (50,)),
        "bias": tie_free(seed + 5, (32,)),
        "huge": tie_free(seed + 6, (MAX_ROW + 200,)),
    }


def op_trees():
    """(name, repro op-tree, port op-tree) over mixed_tree's leaves."""
    out = []
    for name, kw in [("topk", {"k": 0.01}),
                     ("row_topk", {"k": 0.05, "row_len": 512}),
                     ("signtopk", {"k": 0.01, "m": 2}),
                     ("row_signtopk", {"k": 0.05, "row_len": 256, "m": 2}),
                     ("qsgd", {"s": 15})]:
        op_j, op_t = both(name, **kw)
        out.append((name, op_j, op_t))
    keys = sorted(mixed_tree())
    mix = [("topk", {"k": 0.02}), ("row_signtopk", {"k": 0.05,
                                                     "row_len": 256}),
           ("qsgd", {"s": 7}), ("row_topk", {"k": 0.05, "row_len": 512}),
           ("signtopk", {"k": 0.1, "m": 1}), ("identity", {}),
           ("topk", {"k": 0.02})]
    pairs = [both(n, **kw) for n, kw in mix]
    out.append(("mixed", {k: p[0] for k, p in zip(keys, pairs)},
                {k: p[1] for k, p in zip(keys, pairs)}))
    return out


def feed_for(op_tree_j, key, tree) -> tops.Uniforms:
    """The uniforms repro's dispatch draws per leaf (keys split per leaf,
    QSGD's ``uniform(key_i, (d,))``), in flatten order."""
    leaves = jax.tree_util.tree_leaves(tree)
    ops = jops.ops_for_leaves(op_tree_j, len(leaves))
    keys = jax.random.split(key, len(leaves))
    return tops.Uniforms([np.asarray(jax.random.uniform(kk, (x.size,)))
                          for op, kk, x in zip(ops, keys, leaves)
                          if type(op) is jops.QSGDQuantizer])


def assert_close_leaf(t, j, name):
    if name in ("topk", "row_topk"):
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case,pack", [(c, True) for c in range(6)]
                         + [(0, False), (4, False), (5, False)])
def test_channel_compress_tree_matches_repro(case, pack):
    name, op_j, op_t = op_trees()[case]
    tree = mixed_tree(case)
    key = jax.random.PRNGKey(case)
    jcfg = jdsp.DispatchConfig(mode="kernel", pack=pack, max_row=MAX_ROW)
    tcfg = tdsp.DispatchConfig(mode="kernel", pack=pack, max_row=MAX_ROW)
    j0, t0 = dict(JLAUNCHES), dict(TLAUNCHES)
    q_j, m_j, b_j, lb_j = jdsp.channel_compress_tree(
        op_j, key, jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        want_leaf_bits=True)
    feed = feed_for(op_j, key, tree)
    q_t, m_t, b_t, lb_t = tdsp.channel_compress_tree(
        op_t, feed, {k: torch.from_numpy(v) for k, v in tree.items()}, tcfg,
        want_leaf_bits=True)
    assert feed.remaining() == 0
    # repro has no flash_attention counter: it must not move here either
    assert {k: TLAUNCHES[k] - t0[k] for k in t0} == \
        {k: JLAUNCHES.get(k, 0) - j0.get(k, 0) for k in t0}
    assert [float(b) for b in lb_t] == [float(b) for b in lb_j]
    assert float(b_t) == float(b_j)
    for k in tree:
        assert_close_leaf(q_t[k].numpy(), np.asarray(q_j[k]), name)
        assert_close_leaf(m_t[k].numpy(), np.asarray(m_j[k]), name)
        # the memory is acc - q, fused in the kernel or taken after it
        np.testing.assert_array_equal(m_t[k].numpy(),
                                      tree[k] - q_t[k].numpy())


@pytest.mark.parametrize("case", [1, 4, 5])
def test_compress_tree_matches_repro(case):
    name, op_j, op_t = op_trees()[case]
    tree = mixed_tree(10 + case)
    key = jax.random.PRNGKey(case + 1)
    j0, t0 = dict(JLAUNCHES), dict(TLAUNCHES)
    out_j, bits_j = jdsp.compress_tree(
        op_j, key, jax.tree_util.tree_map(jnp.asarray, tree),
        jdsp.DispatchConfig(mode="kernel", max_row=MAX_ROW))
    out_t, bits_t = tdsp.compress_tree(
        op_t, feed_for(op_j, key, tree),
        {k: torch.from_numpy(v) for k, v in tree.items()},
        tdsp.DispatchConfig(mode="kernel", max_row=MAX_ROW))
    # repro has no flash_attention counter: it must not move here either
    assert {k: TLAUNCHES[k] - t0[k] for k in t0} == \
        {k: JLAUNCHES.get(k, 0) - j0.get(k, 0) for k in t0}
    assert float(bits_t) == float(bits_j)
    for k in tree:
        assert_close_leaf(out_t[k].numpy(), np.asarray(out_j[k]), name)


def test_topk_rows_matches_repro():
    rows = tie_free(8, (6, 256))
    want = jdsp.topk_rows(jnp.asarray(rows), 9, sign=True,
                          cfg=jdsp.DispatchConfig(mode="kernel"))
    got = tdsp.topk_rows(torch.from_numpy(rows), 9, sign=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for t, j in zip(got[:2], want[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def test_compress_leaf_matches_repro():
    x = tie_free(3, (64, 512))
    op_j, op_t = both("row_topk", k=0.05, row_len=512)
    out_j, bits_j, used_j = jdsp.compress_leaf(
        op_j, None, jnp.asarray(x), jdsp.DispatchConfig(mode="kernel"))
    out_t, bits_t, used_t = tdsp.compress_leaf(
        op_t, None, torch.from_numpy(x), tdsp.DispatchConfig(mode="kernel"))
    assert used_t and used_j
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert float(bits_t) == float(bits_j)
    _, _, used = tdsp.compress_leaf(op_t, None, torch.from_numpy(x))
    assert not used                        # auto on the CPU


def test_auto_on_cpu_never_launches():
    tree = {k: torch.from_numpy(v) for k, v in mixed_tree(4).items()}
    before = dict(TLAUNCHES)
    for _, _, op_t in op_trees():
        feed = torch.Generator().manual_seed(0)
        tdsp.compress_tree(op_t, feed, tree, tdsp.DispatchConfig())
        tdsp.channel_compress_tree(op_t, feed, tree, tdsp.DispatchConfig())
    assert dict(TLAUNCHES) == before


@pytest.mark.parametrize("case", [0, 2, 3, 4, 5])
def test_batched_workers_share_launches(case):
    """``batched=True`` compresses each worker as the unbatched call
    would, with one launch per bucket for all workers together."""
    name, _, op_t = op_trees()[case]
    trees = [mixed_tree(20 + b) for b in range(3)]
    acc = {k: torch.stack([torch.from_numpy(t[k]) for t in trees])
           for k in trees[0]}
    cfg = tdsp.DispatchConfig(mode="kernel", max_row=MAX_ROW)
    g = torch.Generator().manual_seed(0)
    t0 = dict(TLAUNCHES)
    q, m, bits, lb = tdsp.channel_compress_tree(op_t, g, acc, cfg,
                                                want_leaf_bits=True,
                                                batched=True)
    batched = {k: TLAUNCHES[k] - t0[k] for k in t0}
    assert bits.shape == (3,) and all(b.shape == (3,) for b in lb)
    for b, tree in enumerate(trees):
        t1 = dict(TLAUNCHES)
        q1, m1, bits1 = tdsp.channel_compress_tree(
            op_t, g, {k: torch.from_numpy(v) for k, v in tree.items()}, cfg)
        assert {k: TLAUNCHES[k] - t1[k] for k in t1} == batched
        if name not in ("qsgd", "mixed"):  # qsgd draws other uniforms
            assert float(bits1) == float(bits[b])
            for k in tree:   # SignTop_k norms: summed per launch shape
                assert_close_leaf(q1[k].numpy(), q[k][b].numpy(), name)
                assert_close_leaf(m1[k].numpy(), m[k][b].numpy(), name)
