"""The port's compression operators against ``repro``'s.

Every registered operator runs in both packages on the same numpy input.
Stochastic operators get the same randomness: the test draws the
uniforms with ``jax.random`` exactly where ``repro``'s operator draws
them (same key, same shape, same order) and feeds them to the port as a
``Uniforms`` feed.  Outputs agree to rtol 1e-6 (norms and scales are
float sums in another order; everything else is exact); wire bits agree
exactly.  Without injected randomness, the port's operators are held to
Definition 3 and QSGD to unbiasedness, as ``tests/test_operators.py``
holds ``repro``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro_torch.core import operators as tops


def tie_free(seed, d, lo=0.05, hi=4.0):
    rng = np.random.default_rng(seed)
    mags = np.linspace(lo, hi, d, dtype=np.float32)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mags * signs)[rng.permutation(d)]


def draws(name: str, op, key, d: int) -> list:
    """The uniforms ``repro``'s operator ``name`` draws from ``key`` on a
    flat input of d elements, in draw order."""
    u = lambda kk, n: np.asarray(jax.random.uniform(kk, (n,)))
    if name in ("qsgd", "klevel", "signrandk"):
        return [u(key, d)]
    if name == "randk":
        return [u(key, d)] if jops.resolve_k(op.k, d) < d else []
    if name in ("qtopk", "qrandk"):
        k = jops.resolve_k(op.k, d)
        k_key, q_key = jax.random.split(key)
        sub = [u(k_key, d)] if name == "qrandk" and k < d else []
        return sub + [u(q_key, k)]
    return []


CASES = [
    ("identity", {}),
    ("topk", {"k": 0.05}),
    ("topk", {"k": 7}),
    ("randk", {"k": 0.1}),
    ("row_topk", {"k": 0.1, "row_len": 64}),
    ("row_topk", {"k": 3, "row_len": 100}),
    ("qsgd", {"s": 15}),
    ("qsgd", {"s": 1}),
    ("klevel", {"s": 7}),
    ("sign", {}),
    ("qtopk", {"k": 0.1, "s": 15}),
    ("qtopk", {"k": 0.1, "s": 4, "scaled": True, "quantizer": "klevel"}),
    ("qrandk", {"k": 0.2, "s": 15, "scaled": True}),
    ("signtopk", {"k": 0.05, "m": 1}),
    ("signtopk", {"k": 0.05, "m": 2}),
    ("signrandk", {"k": 0.1, "m": 2}),
    ("row_signtopk", {"k": 0.05, "row_len": 128, "m": 2}),
    ("row_signtopk", {"k": 4, "row_len": 96, "m": 1}),
]


@pytest.mark.parametrize("shape", [(300,), (12, 25)])
@pytest.mark.parametrize("name,kw", CASES)
def test_operator_matches_repro(name, kw, shape):
    d = int(np.prod(shape))
    x = tie_free(d + len(name), d).reshape(shape)
    op_j = jops.make_operator(name, **kw)
    op_t = tops.make_operator(name, **kw)
    key = jax.random.PRNGKey(11)
    out_j, bits_j = op_j(key, jnp.asarray(x))
    feed = tops.Uniforms(draws(name, op_j, key, d))
    out_t, bits_t = op_t(feed, torch.from_numpy(x))
    assert feed.remaining() == 0
    assert out_t.shape == shape and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-7)
    assert bits_t.dtype == torch.float32
    assert float(bits_t) == float(bits_j)
    assert op_t.gamma(d) == op_j.gamma(d)


def test_registry_matches_repro():
    assert sorted(tops.OP_REGISTRY) == sorted(jops.OP_REGISTRY)
    for name, entry in jops.OP_REGISTRY.items():
        mine = tops.OP_REGISTRY[name]
        assert mine.cls.__name__ == entry.cls.__name__
        assert mine.fixed == entry.fixed
        assert mine.fields() == entry.fields()
        assert tops.spec_name_of(tops.make_operator(name)) == \
            jops.spec_name_of(jops.make_operator(name))
    with pytest.raises(KeyError):
        tops.make_operator("nope")
    with pytest.raises(TypeError):
        tops.make_operator("qtopk", sparsifier="rand")
    with pytest.raises(TypeError):
        tops.make_operator("topk", s=3)
    with pytest.raises(ValueError):
        tops.register_op("topk")(tops.TopK)


@pytest.mark.parametrize("k,d", [(0.01, 1000), (0.5, 3), (7, 5), (3.0, 100),
                                 (0.999, 10), (1, 1)])
def test_resolve_k_matches_repro(k, d):
    assert tops.resolve_k(k, d) == jops.resolve_k(k, d)


def test_compress_tree_and_gamma_match_repro():
    tree = {"b": tie_free(1, 64).reshape(8, 8), "a": [tie_free(2, 200),
                                                      tie_free(3, 40)]}
    op_tree = {"b": jops.TopK(k=5), "a": [jops.RowTopK(k=2, row_len=50),
                                          jops.Sign()]}
    op_tree_t = {"b": tops.TopK(k=5), "a": [tops.RowTopK(k=2, row_len=50),
                                            tops.Sign()]}
    out_j, bits_j = jops.compress_tree(
        op_tree, None, jax.tree_util.tree_map(jnp.asarray, tree))
    out_t, bits_t = tops.compress_tree(
        op_tree_t, None, {"b": torch.from_numpy(tree["b"]),
                          "a": [torch.from_numpy(v) for v in tree["a"]]})
    np.testing.assert_array_equal(out_t["b"].numpy(), np.asarray(out_j["b"]))
    for t, j in zip(out_t["a"], out_j["a"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    assert float(bits_t) == float(bits_j)
    assert tops.tree_gamma(op_tree_t, out_t) == jops.tree_gamma(op_tree,
                                                                out_j)
    with pytest.raises(ValueError):
        tops.ops_for_leaves([tops.TopK()], 3)


def check_def3(op, x, trials, slack):
    """E ||x - C(x)||^2 <= (1 - gamma) ||x||^2 over generator draws."""
    g = torch.Generator().manual_seed(0)
    errs = [float(((x - op(g, x)[0]) ** 2).sum()) for _ in range(trials)]
    rhs = (1.0 - op.gamma(x.numel())) * float((x ** 2).sum())
    assert np.mean(errs) <= rhs * slack + 1e-4, (type(op).__name__,)


@pytest.mark.parametrize("op,trials,slack", [
    (tops.TopK(k=0.1), 1, 1.02),
    (tops.RandK(k=0.2), 30, 1.25),
    (tops.RowTopK(k=0.1, row_len=100), 1, 1.02),
    (tops.RowSignTopK(k=0.1, row_len=100, m=2), 1, 1.02),
    (tops.QSGDQuantizer(s=64), 30, 1.3),
    (tops.QuantizedSparsifier(k=20, s=32), 25, 1.2),
    (tops.QuantizedSparsifier(k=20, s=32, scaled=True), 25, 1.2),
    (tops.SignSparsifier(k=10, m=1), 1, 1.02),
    (tops.SignSparsifier(k=10, m=2), 1, 1.02),
    (tops.Sign(), 1, 1.02),
])
def test_definition3_bound(op, trials, slack):
    x = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    check_def3(op, x, trials, slack)


def test_qsgd_unbiased_without_injected_uniforms():
    x = torch.randn(100, generator=torch.Generator().manual_seed(6))
    op = tops.QSGDQuantizer(s=16)
    g = torch.Generator().manual_seed(7)
    mean = torch.stack([op(g, x)[0] for _ in range(200)]).mean(0)
    np.testing.assert_allclose(mean.numpy(), x.numpy(),
                               atol=4 * float(x.abs().max()) / np.sqrt(200))


def test_stochastic_ops_need_rng():
    with pytest.raises(ValueError):
        tops.QSGDQuantizer()(None, torch.ones(8))
    with pytest.raises(ValueError):
        tops.QSGDQuantizer()(tops.Uniforms([np.zeros(3, np.float32)]),
                             torch.ones(8))


@pytest.mark.parametrize("n", [2, 7, 17])
def test_ledger_sum_rounds_like_repro(n):
    """Above 2^24 bits float32 rounds: the port folds leaf bits left to
    right, which is how repro's jnp.sum(jnp.stack(...)) adds them on the
    CPU for up to 17 leaves."""
    from repro_torch.core.bits import ledger_sum
    rng = np.random.default_rng(n)
    for _ in range(50):
        v = (rng.integers(1, 1 << 22, n) * 7).astype(np.float32)
        v[rng.integers(0, n)] = 2.0 ** 24 + 2 * rng.integers(0, 999)
        want = float(jnp.sum(jnp.stack([jnp.asarray(x) for x in v])))
        assert float(ledger_sum(torch.from_numpy(v).unbind(0))) == want


def test_bits_helpers_match_repro():
    from repro.core import bits as jbits
    from repro_torch.core import bits as tbits
    for d in (1, 2, 100, 4096, 65537, 1 << 19):
        for nnz in (0, 1, 41, 5243, 1 << 18):
            assert float(tbits.bits_qsgd(d, 15, torch.tensor(nnz))) == \
                float(jbits.bits_qsgd(d, 15, nnz))
            assert float(tbits.bits_topk_counted(d, torch.tensor(nnz))) == \
                float(jbits.bits_topk_counted(d, nnz))
            assert float(tbits.bits_signtopk_counted(d, nnz)) == \
                float(jbits.bits_signtopk_counted(d, nnz))
            assert float(tbits.bits_qtopk(d, 7, 3, nnz)) == \
                float(jbits.bits_qtopk(d, 7, 3, nnz))
            assert float(tbits.bits_qrandk(d, 7, 3, nnz)) == \
                float(jbits.bits_qrandk(d, 7, 3, nnz))
        for f in ("bits_topk", "bits_randk", "bits_signtopk"):
            assert getattr(tbits, f)(d, 5) == getattr(jbits, f)(d, 5)
        assert tbits.bits_sign(d) == jbits.bits_sign(d)
        assert tbits.bits_klevel(d, 15) == jbits.bits_klevel(d, 15)


def tied(seed, shape):
    """Few distinct magnitudes: Top_k must choose among exact ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("topk", {"k": 0.05}), ("row_topk", {"k": 0.1, "row_len": 60}),
    ("qtopk", {"k": 0.1, "s": 15}), ("signtopk", {"k": 0.05, "m": 1}),
    ("row_signtopk", {"k": 0.1, "row_len": 60, "m": 2}),
])
def test_top_k_breaks_ties_like_repro(name, kw):
    """``jax.lax.top_k`` keeps the lower index among equal magnitudes;
    ``torch.topk`` follows no stated order (it picked other coordinates
    here), which changed trajectories wherever a gradient has exact
    ties.  The port's Top_k family keeps ``repro``'s choice."""
    x = tied(3, (12, 60))
    d = x.size
    op_j = jops.make_operator(name, **kw)
    op_t = tops.make_operator(name, **kw)
    key = jax.random.PRNGKey(5)
    out_j, bits_j = op_j(key, jnp.asarray(x))
    out_t, bits_t = op_t(tops.Uniforms(draws(name, op_j, key, d)),
                         torch.from_numpy(x))
    np.testing.assert_array_equal(out_t.numpy() != 0, np.asarray(out_j) != 0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6)
    assert float(bits_t) == float(bits_j)
    idx = tops.top_k_indices(torch.from_numpy(np.abs(x)), 9)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), 9)[1]))


@pytest.mark.parametrize("shape,k", [((12, 60), 9), ((60,), 1), ((5, 33), 33),
                                     ((7, 128), 1), ((2, 3, 50), 17)])
@pytest.mark.parametrize("ties", [True, False])
def test_top_k_indices_matches_lax_top_k(shape, k, ties):
    """``top_k_indices`` against ``jax.lax.top_k``'s indices, in order, on
    magnitudes (the Top_k family) and on negated magnitudes
    (``_rand_subset`` ranks negated uniforms): rows with many entries
    tied at the k-th value, zeros among them, tie-free rows, k = 1 and
    k = n, and a leading batch of two axes."""
    x = np.abs(tied(k, shape) if ties else
               np.random.default_rng(k).standard_normal(shape)
               .astype(np.float32))
    for v in (x, -x):
        idx = tops.top_k_indices(torch.from_numpy(v), k)
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(v), k)[1]))
