"""The short-row ``topk_compress``'s threshold, on the CPU.

Rows of up to ``SHORT_ROW`` floats run on the card with the row in
registers: the serial bisection's rounds need only a(1), a(k) and a(k+1)
(the largest, k-th and (k+1)-th largest |x|), so the kernel selects those
exactly (a radix select on the bits of |x|) and replays the rounds.  Here
``ref.topk_threshold_select_ref``, a plain model of that (the kernel's
radix walk, then the replay in float32), is held bit for bit to the serial
plain version ``ref.topk_compress_ref`` and to ``repro``'s
``topk_compress`` in interpret mode: the threshold float, the counts, the
survivor masks and the plain Top_k values and memory exactly; SignTop_k
values within rtol 1e-6 (the norm is a float sum in another order).  Rows
have ties, exact zeros and -0.0, subnormals, magnitudes up to FLT_MAX, k =
1 and k = n, ``iters`` 0, 1, 5 and 24.  NaN is left out of every count,
as the CUDA loop's ``fmaxf`` and comparisons leave it.  The ``gpu`` cases
run the kernel on edge rows.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.kernels import ref
from repro_torch.kernels.topk_compress import SHORT_ROW, topk_compress

ROW_KINDS = ("normal", "ties", "zeros", "subnormal", "huge", "flat",
             "spike")
ITERS = (0, 1, 5, 24)


def make_row(rng, kind: str, n: int) -> np.ndarray:
    """One row of a kind: Gaussian; few distinct magnitudes (ties); all
    zeros, some of them -0.0; subnormal magnitudes; magnitudes up to
    FLT_MAX; one magnitude throughout; one spike among zeros; Gaussian
    with NaN in a fifth of the slots."""
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
    elif kind == "spike":
        x = np.zeros(n)
        x[rng.integers(n)] = 7.0
    else:
        x = rng.standard_normal(n)
        x[rng.random(n) < 0.2] = np.nan
    return x.astype(np.float32)


@st.composite
def topk_cases(draw, kinds=ROW_KINDS):
    n = draw(st.sampled_from([1, 3, 4, 37, 128, 300]))
    kinds = draw(st.lists(st.sampled_from(kinds), min_size=1, max_size=3))
    k = draw(st.one_of(st.just(1), st.just(n), st.integers(1, n)))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31 - 1)))
    return np.stack([make_row(rng, kind, n) for kind in kinds]), k


def serial_threshold(x: np.ndarray, k: int, iters: int = 24) -> np.ndarray:
    """The CUDA loop (common.cuh bisect_threshold), one float32 operation
    at a time: hi = fmaxf over |x| from 0 (NaN skipped), counts of
    |x| >= t (NaN never counts)."""
    a = np.abs(x)
    hi = np.fmax.reduce(a, axis=1, initial=np.float32(0.0))
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


NO_NAN = tuple(k for k in ROW_KINDS if k != "nan")


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=topk_cases(), sign=st.booleans(), iters=st.sampled_from(ITERS))
def test_select_model_matches_serial_plain_version(case, sign, iters):
    x, k = case
    acc = torch.from_numpy(x)
    *got, thr = ref.topk_threshold_select_ref(acc, k, iters=iters, sign=sign)
    np.testing.assert_array_equal(thr.numpy(), serial_threshold(x, k, iters))
    assert_same_survivors(
        [a.numpy() for a in got],
        [a.numpy() for a in ref.topk_compress_ref(acc, k, iters=iters,
                                                  sign=sign)], sign)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_select_model_any_round_count(kind, iters):
    """Every kind of row at k = 1, 17 and n, 0-24 rounds."""
    rng = np.random.default_rng(iters * 10 + len(kind))
    x = np.stack([make_row(rng, kind, 300) for _ in range(3)])
    acc = torch.from_numpy(x)
    for k in (1, 17, 300):
        *got, thr = ref.topk_threshold_select_ref(acc, k, iters=iters)
        np.testing.assert_array_equal(thr.numpy(),
                                      serial_threshold(x, k, iters))
        assert_same_survivors([a.numpy() for a in got],
                              [a.numpy() for a in ref.topk_compress_ref(
                                  acc, k, iters=iters)], False)


@pytest.mark.parametrize("kind", ["nan", "zeros"])
def test_select_model_leaves_nan_out(kind):
    """NaN never counts and never survives (the CUDA loop's semantics;
    PyTorch's amax, which the plain version uses, would carry it)."""
    rng = np.random.default_rng(3)
    x = np.stack([make_row(rng, kind, 200) for _ in range(4)])
    x[1] = np.nan                            # a row of NaN only
    x[2, :150] = np.nan                      # fewer keys than k
    for k in (1, 60, 200):
        sel, mem, cnt, thr = ref.topk_threshold_select_ref(
            torch.from_numpy(x), k)
        np.testing.assert_array_equal(thr.numpy(), serial_threshold(x, k))
        keep = (np.abs(x) >= thr.numpy()[:, None]) & (np.abs(x) > 0)
        np.testing.assert_array_equal(sel.numpy() != 0, keep)
        np.testing.assert_array_equal(cnt.numpy(), keep.sum(axis=1))
        assert not np.isnan(sel.numpy()).any()


@settings(max_examples=80, deadline=None)
@given(case=topk_cases(), k_off=st.integers(0, 3))
def test_radix_select_is_the_order_statistic(case, k_off):
    """The kernel's radix walk lands on the k-th largest key, counted with
    multiplicity (absent past the last), in at most four passes."""
    x, k = case
    keys = ref.abs_keys(torch.from_numpy(x))
    k = min(k + k_off, x.shape[1] + 1)
    for row in keys:
        live = torch.sort(row[row >= 0], descending=True).values
        got, passes = ref.radix_select(row, k)
        assert got == (int(live[k - 1]) if k <= len(live) else -1)
        assert 1 <= passes <= 4


@pytest.fixture
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import topk_compress
    return jnp, topk_compress


@settings(max_examples=16, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(case=topk_cases(tuple(k for k in NO_NAN if k != "subnormal")),
       sign=st.booleans(), iters=st.sampled_from(ITERS))
def test_select_model_matches_repro_kernel(jx, case, sign, iters):
    """Against ``repro``'s Pallas kernel in interpret mode and its
    threshold.  Not on subnormal rows (XLA's CPU backend flushes them to
    zero; the test above holds them to the port's plain version) nor NaN
    (``jnp.max`` carries it)."""
    jnp, jtopk = jx
    x, k = case
    xj = jnp.asarray(x)
    want = [np.asarray(a) for a in jtopk.topk_compress(
        xj, k, iters=iters, sign=sign, interpret=True)]
    thr_w = np.asarray(jtopk._bisect_threshold(jnp.abs(xj), k, iters))[:, 0]
    *got, thr = ref.topk_threshold_select_ref(torch.from_numpy(x), k,
                                              iters=iters, sign=sign)
    np.testing.assert_array_equal(thr.numpy(), thr_w)
    assert_same_survivors([a.numpy() for a in got], want, sign)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def card_rows(kind: str, rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "tied":                       # every |x| equal
        return np.where(rng.random((rows, n)) < 0.5, -1.5, 1.5).astype(
            np.float32)
    return np.stack([make_row(rng, kind if kind != "mixed"
                              else ROW_KINDS[r % len(ROW_KINDS)], n)
                     for r in range(rows)])


#: row lengths at every route's edges: a warp a row up to 2048 floats
#: (1, 3, gemma3-1b's 1152), blocks of 4, 8 and 12 warps beyond
#: (ResNet-50's 4096), the longest short row
CARD_N = [1, 3, 1152, 2048, 2049, 4096, 4097, 8192, 8193, SHORT_ROW]


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("kind", ["normal", "zeros", "tied", "mixed",
                                  "nan"])
@pytest.mark.parametrize("n", CARD_N)
def test_topk_short_rows_on_card(cuda, n, kind, sign):
    """Counts and survivor masks exactly equal to the select model's (and
    to the plain version's where no NaN is in the row); plain values and
    memory bit for bit; SignTop_k within rtol 1e-6.  k = 1, ~1 % and n;
    the rows also at an offset of one float (the element path)."""
    x = torch.from_numpy(card_rows(kind, 9, n, n + len(kind))).to(cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    flat[1:] = x.flatten()
    shifted = flat[1:].view(x.shape)
    for k in sorted({1, max(1, n // 100), n}):
        want = ref.topk_threshold_select_ref(x, k, sign=sign)[:3]
        for got in (topk_compress(x, k, sign=sign),
                    topk_compress(shifted, k, sign=sign)):
            torch.cuda.synchronize()
            assert_same_survivors([a.cpu().numpy() for a in got],
                                  [a.cpu().numpy() for a in want], sign)
        if kind != "nan":
            assert_same_survivors(
                [a.cpu().numpy() for a in topk_compress(x, k, sign=sign)],
                [a.cpu().numpy() for a in ref.topk_compress_ref(
                    x, k, sign=sign)], sign)


@pytest.mark.gpu
@pytest.mark.parametrize("iters", ITERS)
def test_topk_short_rows_round_counts_on_card(cuda, iters):
    """The replay at 0, 1, 5 and 24 rounds: the plain version's survivors
    at gemma3-1b's row length and ResNet-50's."""
    for n, k in ((1152, 12), (4096, 41)):
        x = torch.from_numpy(card_rows("mixed", 64, n, iters)).to(cuda)
        assert_same_survivors(
            [a.cpu().numpy() for a in topk_compress(x, k, iters=iters)],
            [a.cpu().numpy() for a in ref.topk_compress_ref(
                x, k, iters=iters)], False)


@pytest.mark.parametrize("value", [1.5, -3e19, 9.313394e37, -3.4028235e38])
def test_one_float_row_sign_norm_is_its_magnitude(jx, value):
    """SignTop_k of a row of one float keeps that float exactly, as
    ``repro``'s compiled kernel does (the square would overflow past
    1.8e19), in every plain version the kernels are held to."""
    jnp, jtopk = jx
    x = np.array([[value]], np.float32)
    want = np.asarray(jtopk.topk_compress(jnp.asarray(x), 1, sign=True,
                                          interpret=True)[0])
    np.testing.assert_array_equal(want, x)
    acc = torch.from_numpy(x)
    for sel in (ref.topk_compress_ref(acc, 1, sign=True)[0],
                ref.topk_threshold_select_ref(acc, 1, sign=True)[0],
                ref.topk_compact_ref(acc, 1, 1, sign=True)[1],
                ref.topk_compact_rows_ref(acc, 1, 1, sign=True)[1]):
        np.testing.assert_array_equal(sel.numpy(), x)
