"""The long-row ``topk_compress``'s arithmetic and geometry, on the CPU.

Rows longer than ``SHORT_ROW`` floats run on the card as a cluster of
blocks per row that takes several bisection levels a pass.  Here
``ref.topk_threshold_levels_ref``, a plain PyTorch model of that search
(per-chunk integer counts summed, then the levels walked, elements in
[lo, hi) only), is held bit for bit to the serial plain version
``ref.topk_compress_ref`` and to ``repro``'s ``topk_compress`` in
interpret mode: the threshold float, the counts, the survivor masks and
the plain Top_k values and memory exactly; SignTop_k values within rtol
1e-6 (the norm is a float sum in another order: ``ref.tree_sq_ref``'s,
which is the kernel's at either cluster size, ``tests/
test_torch_autotune.py``).  Rows have ties, exact
zeros and -0.0, subnormals, magnitudes past FLT_MAX / 2 (where lo + hi
may overflow), k = 1 and k = n.  ``cluster_geometry`` is pinned: every
element in exactly one block.  The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, ``gpu`` marker).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.kernels import ref
from repro_torch.kernels.topk_compress import (
    CLUSTER_SIZES, SHORT_ROW, cluster_geometry)

LEVELS = (1, 3, 4, 5)
CLUSTERS = (1, 8, 16)
ROW_KINDS = ("normal", "ties", "zeros", "subnormal", "huge", "flat",
             "spike")


def make_row(rng, kind: str, n: int) -> np.ndarray:
    """One row of a kind: Gaussian; few distinct magnitudes (ties); all
    zeros, some of them -0.0; subnormal magnitudes; magnitudes up to
    FLT_MAX; one magnitude throughout (hi is never lowered while k < n);
    one spike among zeros."""
    if kind == "normal":
        x = rng.standard_normal(n)
    elif kind == "ties":
        x = rng.choice([-1.5, -0.5, 0.0, 0.5, 1.5, 2.0], n)
    elif kind == "zeros":
        x = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    elif kind == "subnormal":
        x = rng.standard_normal(n) * 1e-40
        x[rng.random(n) < 0.2] = -0.0
    elif kind == "huge":
        x = rng.uniform(-3.4e38, 3.4e38, n)
    elif kind == "flat":
        x = np.where(rng.random(n) < 0.5, -2.0, 2.0)
    else:
        x = np.zeros(n)
        x[rng.integers(n)] = 7.0
    return x.astype(np.float32)


@st.composite
def topk_cases(draw, kinds=ROW_KINDS):
    n = draw(st.sampled_from([4, 37, 128, 300]))
    kinds = draw(st.lists(st.sampled_from(kinds), min_size=1, max_size=3))
    k = draw(st.one_of(st.just(1), st.just(n), st.integers(1, n)))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31 - 1)))
    return np.stack([make_row(rng, kind, n) for kind in kinds]), k


def serial_threshold(x: np.ndarray, k: int, iters: int = 24) -> np.ndarray:
    """repro's _bisect_threshold, one float32 operation at a time."""
    a = np.abs(x)
    hi = a.max(axis=1)
    lo = np.zeros_like(hi)
    half = np.float32(0.5)
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(iters):
            mid = half * (lo + hi)
            more = (a >= mid[:, None]).sum(axis=1) > k
            lo = np.where(more, mid, lo)
            hi = np.where(more, hi, mid)
    return np.where((a >= hi[:, None]).sum(axis=1) >= k, hi, lo)


def assert_same_survivors(got, want, sign: bool):
    sel, mem, cnt = got
    sel_w, mem_w, cnt_w = want
    np.testing.assert_array_equal(cnt, cnt_w)
    np.testing.assert_array_equal(sel != 0, sel_w != 0)
    if sign:
        np.testing.assert_allclose(sel, sel_w, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(sel, sel_w)
        np.testing.assert_array_equal(mem, mem_w)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=topk_cases(), sign=st.booleans())
def test_levels_model_matches_serial_plain_version(case, sign):
    x, k = case
    acc = torch.from_numpy(x)
    want = [a.numpy() for a in ref.topk_compress_ref(acc, k, sign=sign)]
    thr_w = serial_threshold(x, k)
    for levels in LEVELS:
        for clusters in CLUSTERS:
            *got, thr = ref.topk_threshold_levels_ref(
                acc, k, sign=sign, levels=levels, clusters=clusters)
            np.testing.assert_array_equal(thr.numpy(), thr_w)
            assert_same_survivors([a.numpy() for a in got], want, sign)


@pytest.mark.parametrize("iters", [0, 1, 5, 24])
@pytest.mark.parametrize("levels", LEVELS)
def test_levels_model_any_round_count(iters, levels):
    """A last pass with fewer levels than the rest (24 = 4 x 6, but 5 or
    23 rounds leave a remainder), and no round at all."""
    rng = np.random.default_rng(iters * 10 + levels)
    x = np.stack([make_row(rng, kind, 300) for kind in ROW_KINDS])
    acc = torch.from_numpy(x)
    *got, thr = ref.topk_threshold_levels_ref(acc, 17, iters=iters,
                                              levels=levels, clusters=8)
    np.testing.assert_array_equal(thr.numpy(), serial_threshold(x, 17, iters))
    assert_same_survivors([a.numpy() for a in got],
                          [a.numpy() for a in ref.topk_compress_ref(
                              acc, 17, iters=iters)], False)


@pytest.fixture
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import topk_compress
    return jnp, topk_compress


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(case=topk_cases(tuple(k for k in ROW_KINDS if k != "subnormal")),
       sign=st.booleans())
def test_levels_model_matches_repro_kernel(jx, case, sign):
    """Against ``repro``'s Pallas kernel in interpret mode and its
    threshold, at the kernel's levels a pass and both cluster sizes.
    Not on subnormal rows: XLA's CPU backend flushes them to zero, while
    the port keeps IEEE subnormals as PyTorch and the card (built without
    -ftz) do; the test above holds them to the port's plain version."""
    jnp, jtopk = jx
    x, k = case
    xj = jnp.asarray(x)
    want = [np.asarray(a) for a in jtopk.topk_compress(xj, k, sign=sign,
                                                       interpret=True)]
    thr_w = np.asarray(jtopk._bisect_threshold(jnp.abs(xj), k, 24))[:, 0]
    for clusters in CLUSTER_SIZES:
        *got, thr = ref.topk_threshold_levels_ref(
            torch.from_numpy(x), k, sign=sign, levels=4, clusters=clusters)
        np.testing.assert_array_equal(thr.numpy(), thr_w)
        assert_same_survivors([a.numpy() for a in got], want, sign)


#: the four long shapes chip_smoke.py times: the capacities an H100
#: reports for them (clusters of 8 / 16 blocks held at once, each block
#: with its chunk: tools/bench_flash_kernels.py --kernels topk_paged
#: prints them) and the geometry each takes
MAIN_SHAPES = {(16, 524288): ((30, 14), (8, 65536)),
               (8, 524288): ((30, 14), (16, 32768)),
               (56, 65536): ((62, 28), (8, 8192)),
               (8, 65536): ((62, 28), (16, 4096))}


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_cluster_geometry_at_the_main_shapes(shape):
    caps, want = MAIN_SHAPES[shape]
    assert tuple(cluster_geometry(*shape, *caps)) == want
    # where 16 does not schedule: 8
    assert tuple(cluster_geometry(*shape, caps[0], 0)) == (8, shape[1] // 8)


def test_cluster_geometry_fewest_waves_times_chunk():
    """Waves over the rows times the chunk: two waves of 16-block
    clusters (2 x 32768) tie one of 8 (65536) and take 8; three waves of
    16 beat two of 8."""
    assert cluster_geometry(16, 524288, 30, 14).cs == 8
    assert cluster_geometry(16, 524288, 15, 7).cs == 16
    assert cluster_geometry(8, 524288, 30, 14).cs == 16
    with pytest.raises(RuntimeError):
        cluster_geometry(8, 524288, 0, 0)


@pytest.mark.parametrize("caps", [(30, 14), (62, 28), (15, 0), (1, 1),
                                  (1000, 1000)])
@pytest.mark.parametrize("rows", [1, 8, 9, 16, 56, 1000])
@pytest.mark.parametrize("n", [SHORT_ROW + 1, 12416, 13001, 65536, 100000,
                               262144, 262148, 524288, 1 << 21])
def test_cluster_geometry_covers_every_element_once(n, rows, caps):
    cs, chunk = cluster_geometry(rows, n, *caps)
    assert cs in CLUSTER_SIZES and (cs == 8 or caps[1] > 0)
    assert chunk % 4 == 0                   # 16-byte aligned chunks
    owner = np.full(n, -1)
    for r in range(cs):
        lo, hi = r * chunk, min(n, (r + 1) * chunk)
        assert lo < hi                      # no block without elements
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = r
    assert (owner >= 0).all()
