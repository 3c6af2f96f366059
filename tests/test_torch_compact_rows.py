"""The short-row ``topk_compact`` kernel's arithmetic and route, on the CPU.

Rows of up to ``SHORT_ROW`` floats run on the card with the row in
registers, a warp a row up to 2048 floats (or a block of warps a row):
``topk_compress``'s threshold, then each survivor's slot from four
ballots per float4 column and a running carry, the slots staged in
shared memory.  Here ``ref.topk_compact_rows_ref``, a plain model of that
(the (j, lane, q) order, the per-j ballots and carry, the kcap cut, the
SignTop_k norm over the emitted values in the kernel's float order), is
held to the plain version ``ref.topk_compact_ref`` and to ``repro``'s
``topk_compact`` in interpret mode and its oracle.  Tolerances: idx, the
counts, the sentinels, plain Top_k values and the memory off the
emitted slots are exact; SignTop_k values within rtol 1e-6 (the norm is
a float sum in another order than the plain version's), and the memory
at an emitted slot (acc - val) within that value's error.  Rows have
ties, exact zeros and -0.0, subnormals, rows whose every element
survives and overflows kcap, and lengths that are not multiples of 128.
``compact_geometry``, the route chosen from the shape before a launch,
is pinned.  The ``gpu`` cases hold the kernel to the model (SignTop_k
values too, bit for bit: the model sums in the kernel's order) and to
the plain version, on every route.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels import ref
from repro_torch.kernels import topk_compress as tk
from repro_torch.kernels.topk_compress import (
    COMPACT_STAGE, SHORT_ROW, WARP_ROW, compact_area, compact_geometry,
    topk_compact)

ROW_KINDS = ("normal", "ties", "zeros", "subnormal", "flat", "spike",
             "dense")


def make_row(rng, kind: str, n: int) -> np.ndarray:
    """One row of a kind: Gaussian; few distinct magnitudes (ties); all
    zeros, some -0.0; subnormal magnitudes; one magnitude throughout
    (every element survives); one spike among zeros; one large value,
    then equal magnitudes (all survive, past kcap)."""
    if kind == "normal":
        x = rng.standard_normal(n)
    elif kind == "ties":
        x = rng.choice([-1.5, -0.5, 0.0, 0.5, 1.5, 2.0], n)
    elif kind == "zeros":
        x = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    elif kind == "subnormal":
        x = rng.standard_normal(n) * 1e-40
        x[rng.random(n) < 0.2] = -0.0
    elif kind == "flat":
        x = np.where(rng.random(n) < 0.5, -2.0, 2.0)
    elif kind == "spike":
        x = np.zeros(n)
        x[rng.integers(n)] = 7.0
    else:
        x = np.where(rng.random(n) < 0.5, -1.5, 1.5)
        x[: max(1, n // 100)] = 9.0
    return x.astype(np.float32)


@st.composite
def compact_cases(draw, kinds=ROW_KINDS, lengths=(1, 3, 37, 128, 300, 1151,
                                                  1152)):
    n = draw(st.sampled_from(lengths))
    kinds = draw(st.lists(st.sampled_from(kinds), min_size=1, max_size=3))
    k = draw(st.one_of(st.just(1), st.just(n), st.integers(1, n)))
    # the dispatch's capacity where it fits the row, else a smaller one
    # (every all-survivor row then overflows it)
    kcap = draw(st.one_of(st.just(min(dsp.capacity(k, n), n)),
                          st.integers(1, n)))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31 - 1)))
    return np.stack([make_row(rng, kind, n) for kind in kinds]), k, kcap


def assert_compact_equal(got, want, sign: bool, n: int, kcap: int):
    """idx, counts, sentinels and the memory off the emitted slots
    exactly; values exactly (plain) or within rtol 1e-6 (SignTop_k), the
    memory at emitted slots within that value's error."""
    idx, val, mem, cnt = (np.asarray(a) for a in got)
    idx_w, val_w, mem_w, cnt_w = (np.asarray(a) for a in want)
    assert idx.dtype == np.int32 and cnt.dtype == np.int32
    np.testing.assert_array_equal(cnt, cnt_w)
    np.testing.assert_array_equal(idx, idx_w)
    empty = np.arange(kcap)[None, :] >= cnt[:, None]
    assert (idx[empty] == n).all() and (val[empty] == 0).all()
    assert (np.diff(np.where(empty, n, idx), axis=1) >= 0).all()
    mem, mem_w = mem.reshape(idx.shape[0], -1), mem_w.reshape(idx.shape[0], -1)
    if not sign:
        np.testing.assert_array_equal(val, val_w)
        np.testing.assert_array_equal(mem, mem_w)
        return
    np.testing.assert_allclose(val, val_w, rtol=1e-6, atol=0)
    emitted = np.zeros(mem.shape, dtype=bool)
    rows = np.repeat(np.arange(idx.shape[0]), kcap).reshape(idx.shape)
    emitted[rows[~empty], idx[~empty]] = True
    np.testing.assert_array_equal(mem[~emitted], mem_w[~emitted])
    np.testing.assert_allclose(
        mem[emitted], mem_w[emitted], rtol=1e-6,
        atol=1e-6 * float(np.abs(val_w).max(initial=0.0)))


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=compact_cases(), sign=st.booleans(),
       iters=st.sampled_from((0, 5, 24)))
def test_rows_model_matches_plain_version(case, sign, iters):
    x, k, kcap = case
    acc = torch.from_numpy(x)
    got = ref.topk_compact_rows_ref(acc, k, kcap, iters=iters, sign=sign)
    want = ref.topk_compact_ref(acc, k, kcap, iters=iters, sign=sign)
    assert_compact_equal([a.numpy() for a in got],
                         [a.numpy() for a in want], sign, x.shape[1], kcap)


@pytest.mark.parametrize("warps", [1, 4, 8, 12])
@pytest.mark.parametrize("sign", [False, True])
def test_rows_model_any_warps_a_row(warps, sign):
    """The slots are the index order whatever the warps a row: the lower
    warps' totals cross into each j's slots (the block-of-warps route
    takes 4-12 a row)."""
    rng = np.random.default_rng(warps)
    n = 3000
    x = np.stack([make_row(rng, kind, n) for kind in ROW_KINDS])
    for k, kcap in ((30, 128), (n, 200), (1, 1)):
        acc = torch.from_numpy(x)
        assert_compact_equal(
            [a.numpy() for a in ref.topk_compact_rows_ref(
                acc, k, kcap, sign=sign, warps=warps)],
            [a.numpy() for a in ref.topk_compact_ref(acc, k, kcap,
                                                     sign=sign)],
            sign, n, kcap)


def test_rows_model_heavy_ties_keep_the_rest_in_memory():
    """All-survivor rows fill kcap; the survivors past it keep their value
    in the memory; the SignTop_k scale is over the emitted ones only."""
    rng = np.random.default_rng(5)
    n, k, kcap = 1152, 12, 128
    x = np.where(rng.random((3, n)) < 0.5, -1.5, 1.5).astype(np.float32)
    x[1, :7] = 9.0
    x[2, ::3] = 0.0
    for sign in (False, True):
        idx, val, mem, cnt = (a.numpy() for a in ref.topk_compact_rows_ref(
            torch.from_numpy(x), k, kcap, sign=sign))
        assert (cnt == kcap).all()
        emitted = np.zeros_like(x, dtype=bool)
        np.put_along_axis(emitted, idx.astype(np.int64), True, axis=1)
        np.testing.assert_array_equal(mem[~emitted], x[~emitted])
        if sign:
            # the emitted values' norm over their count, per row
            sel = np.where(emitted, x, 0.0)
            scale = np.sqrt((sel.astype(np.float64) ** 2).sum(1)) / kcap
            np.testing.assert_allclose(
                np.abs(val), np.repeat(scale[:, None], kcap, axis=1),
                rtol=1e-6)


@pytest.fixture
def jx():
    """``repro``'s compact kernel and oracle (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(case=compact_cases(tuple(k for k in ROW_KINDS if k != "subnormal"),
                          (128, 384, 1152)),
       sign=st.booleans())
def test_rows_model_matches_repro(jx, case, sign):
    """Against ``repro``'s Pallas kernel in interpret mode and its oracle.
    Not on subnormal rows (XLA's CPU backend flushes them to zero; the
    tests above hold them to the port's plain version)."""
    x, k, kcap = case
    kcap = dsp.capacity(k, x.shape[1])
    xj = jx.jnp.asarray(x)
    got = [a.numpy() for a in ref.topk_compact_rows_ref(
        torch.from_numpy(x), k, kcap, sign=sign)]
    for want in (jx.ops.topk_compact(xj, k, kcap, sign=sign, interpret=True),
                 jx.ref.topk_compact_ref(xj, k, kcap, sign=sign)):
        assert_compact_equal(got, want, sign, x.shape[1], kcap)


# ---------------------------------------------------------------------------
# the route, chosen from the shape before the launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,kcap,want", [
    (1152, 128, ("warp", 8, 8 * 3072)),      # gemma3-1b's rows: the main path
    (1, 1, ("warp", 8, 8 * 3072)),
    (300, 37, ("warp", 8, 8 * 3072)),
    (2048, 1792, ("warp", 8, 8 * 14336)),    # eight rows' slots still fit
    (2048, 1920, ("warp", 4, 4 * 15360)),    # eight would not: four
    (2048, 2048, ("warp", 4, 4 * 16384)),
    (2049, 128, ("block", 1, 3072)),         # 4-12 warps a row
    (4096, 128, ("block", 1, 3072)),
    (12288, 12288, ("block", 1, 98304)),
    (12289, 128, ("scan", 1, 0)),            # past SHORT_ROW
    (524288, 2048, ("scan", 1, 0))])
def test_compact_geometry_pinned(n, kcap, want):
    assert tuple(compact_geometry(n, kcap)) == want


@pytest.mark.parametrize("n", [1, 128, 1151, 1152, 2047, 2048, 2049, 4096,
                               SHORT_ROW, SHORT_ROW + 1])
def test_compact_geometry_fits_shared_memory(n):
    """Every kcap the wrapper takes (1 .. n) has a route; a warp route's
    rows' slots fit COMPACT_STAGE (the kernel refuses past 227 KB), and
    their space holds the three histograms."""
    for kcap in sorted({1, 4, 127, 128, 1024, 2048, n} & set(range(1,
                                                                   n + 1))):
        geo = compact_geometry(n, kcap)
        assert geo.rows in (1, 2, 4, 8)
        if n <= WARP_ROW:
            assert geo.kernel == "warp"
            assert geo.rows * compact_area(kcap) <= COMPACT_STAGE
        elif n <= SHORT_ROW:
            assert geo.kernel == "block" and geo.rows == 1
        else:
            assert geo.kernel == "scan"
        if geo.kernel != "scan":
            assert compact_area(kcap) >= max(3 * 1024, 8 * kcap)
            assert geo.smem == geo.rows * compact_area(kcap) <= 232448


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def card_rows(rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([make_row(rng, ROW_KINDS[r % len(ROW_KINDS)], n)
                     for r in range(rows)])


def _on_card(x, k, kcap, sign):
    """The kernel against the model (bit for bit, SignTop_k values too)
    and against the plain version."""
    got = [a.cpu().numpy() for a in topk_compact(x, k, kcap, sign=sign)]
    torch.cuda.synchronize()
    model = [a.cpu().numpy() for a in ref.topk_compact_rows_ref(
        x, k, kcap, sign=sign)]
    for a, b in zip(got, model):
        np.testing.assert_array_equal(a, b)
    assert_compact_equal(got, [a.cpu().numpy() for a in ref.topk_compact_ref(
        x, k, kcap, sign=sign)], sign, x.shape[1], kcap)


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("n,k,kcap", [
    (1152, 12, 128), (1152, 1152, 1152), (1152, 12, 37), (1151, 12, 128),
    (1, 1, 1), (37, 3, 20), (300, 5, 128), (2048, 2048, 2048),
    (2048, 20, 1920), (2049, 20, 128), (4096, 41, 128), (8192, 82, 128),
    (12288, 123, 12288), (12289, 123, 128)])
def test_compact_rows_kernel_on_card(cuda, n, k, kcap, sign):
    """Every route (warp rows at 8 and 4 a block, 4-12 warps a row, the
    scan kernel past SHORT_ROW: held to the plain version only), kcap not
    a multiple of 4, a row not one of 4, and the rows at an offset of one
    float (scalar loads and stores)."""
    x = torch.from_numpy(card_rows(23, n, n + k)).to(cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    flat[1:] = x.flatten()
    for acc in (x, flat[1:].view(x.shape)):
        if n > SHORT_ROW:
            got = [a.cpu().numpy() for a in topk_compact(acc, k, kcap,
                                                         sign=sign)]
            assert_compact_equal(got, [a.cpu().numpy() for a in
                                       ref.topk_compact_ref(acc, k, kcap,
                                                            sign=sign)],
                                 sign, n, kcap)
        else:
            _on_card(acc, k, kcap, sign)


@pytest.mark.gpu
@pytest.mark.parametrize("rows_a_block", [1, 2, 4, 8])
def test_compact_rows_kernel_any_rows_a_block(cuda, monkeypatch,
                                              rows_a_block):
    """The warp kernel with 1, 2, 4 or 8 rows a block (the route takes 8
    at the main path's kcap), rows not a multiple of it."""
    monkeypatch.setattr(tk, "compact_geometry", lambda n, kcap: tk.
                        CompactGeometry("warp", rows_a_block,
                                        rows_a_block * compact_area(kcap)))
    x = torch.from_numpy(card_rows(29, 1152, rows_a_block)).to(cuda)
    for sign in (False, True):
        _on_card(x, 12, 128, sign)
