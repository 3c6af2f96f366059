"""The compact Top_k (``topk_compact``) against ``repro``'s.

On the CPU the wrapper runs its plain version (``ref.topk_compact_ref``);
both are held against ``repro``'s ``topk_compact_ref`` and its Pallas
kernel in interpret mode (``ops.topk_compact``), on the same numpy
inputs, and so are the dispatch entries built on them.

Tolerances: the survivor slots ``idx``, the counts, the sentinels and
the memory are exact (the threshold is found with exact compares and
integer counts, and survivors past ``kcap`` fall back into the memory
unchanged); plain Top_k values are exact too.  SignTop_k values carry
the emitted survivors' norm, a float sum whose order differs between
the frameworks: within 1e-6 relative, and the memory at an emitted
coordinate (acc - val) within that value's error; elsewhere it is
exact.  The CUDA kernel itself runs only
on the card (``gpu`` marker).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core.operators import RowSignTopK, RowTopK, SignSparsifier, \
    TopK
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels import ref
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.topk_compress import topk_compact


def tie_free(rng, shape, lo=0.05, hi=4.0):
    """float32 values with strictly distinct magnitudes, shuffled."""
    d = int(np.prod(shape))
    mags = np.linspace(lo, hi, d, dtype=np.float32)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mags * signs)[rng.permutation(d)].reshape(shape)


def compact_input(seed, rows, n):
    """Tie-free rows, plus (from row 1 on) a zero-padded half row and a
    row of equal magnitudes: every element survives and, past kcap,
    stays in the memory."""
    rng = np.random.default_rng(seed)
    x = tie_free(rng, (rows, n))
    if rows > 1:
        x[1, n // 2:] = 0.0
    if rows > 2:
        x[2] = np.where(rng.random(n) < 0.5, -1.5, 1.5)
    return x


@pytest.fixture
def jx():
    """``repro``'s compact kernel, oracle and dispatch (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import operators as jops
    from repro.kernels import dispatch as jdsp
    from repro.kernels import ops as jkops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jnp=jnp, ops=jkops, ref=jref, dsp=jdsp,
                                 jops=jops)


def assert_compact_equal(t_out, j_out, sign: bool, n: int, kcap: int):
    idx_t, val_t, mem_t, cnt_t = (np.asarray(a) for a in t_out)
    idx_j, val_j, mem_j, cnt_j = (np.asarray(a) for a in j_out)
    assert idx_t.dtype == np.int32 and cnt_t.dtype == np.int32
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(idx_t, idx_j)
    slot = np.arange(kcap)[None, :]
    empty = slot >= cnt_t[:, None]
    assert (idx_t[empty] == n).all() and (val_t[empty] == 0).all()
    assert (np.diff(np.where(empty, n, idx_t), axis=1) >= 0).all()
    if not sign:
        np.testing.assert_array_equal(val_t, val_j)
        np.testing.assert_array_equal(mem_t, mem_j)
        return
    np.testing.assert_allclose(val_t, val_j, rtol=1e-6, atol=0)
    # memory = acc - val: exact where nothing was emitted, and where a
    # value was, off by that value's rounding (absolute)
    mem_t, mem_j = mem_t.reshape(idx_t.shape[0], -1), \
        mem_j.reshape(idx_t.shape[0], -1)
    emitted = np.zeros(mem_t.shape, dtype=bool)
    rows = np.repeat(np.arange(idx_t.shape[0]), kcap).reshape(idx_t.shape)
    emitted[rows[~empty], idx_t[~empty]] = True
    np.testing.assert_array_equal(mem_t[~emitted], mem_j[~emitted])
    np.testing.assert_allclose(
        mem_t[emitted], mem_j[emitted], rtol=1e-6,
        atol=1e-6 * float(np.abs(val_j).max(initial=0.0)))


# (rows, n, k): k at 1 and at n, rows of 128 / 1152 / 4096
CASES = [(4, 128, 1), (3, 128, 128), (3, 1152, 12), (3, 1152, 1152),
         (3, 4096, 41), (2, 4096, 4096)]


@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("rows,n,k", CASES)
def test_compact_plain_and_wrapper_match_repro(jx, rows, n, k, sign):
    x = compact_input(rows * n + k, rows, n)
    kcap = dsp.capacity(k, n)
    xj = jx.jnp.asarray(x)
    kern_j = jx.ops.topk_compact(xj, k, kcap, sign=sign, interpret=True)
    oracle_j = jx.ref.topk_compact_ref(xj, k, kcap, sign=sign)
    plain = ref.topk_compact_ref(torch.from_numpy(x), k, kcap, sign=sign)
    wrapped = topk_compact(torch.from_numpy(x), k, kcap, sign=sign)
    for t_out in (plain, wrapped):
        for j_out in (kern_j, oracle_j):
            assert_compact_equal([a.numpy() for a in t_out], j_out, sign, n,
                                 kcap)


@pytest.mark.parametrize("sign", [False, True])
def test_heavy_ties_overflow_kcap(jx, sign):
    """Rows of equal magnitudes keep every element: the first kcap are
    emitted, the rest stay in the memory, and the SignTop_k scale is
    taken over the emitted ones only."""
    n, k, kcap = 1152, 12, 128
    rng = np.random.default_rng(5)
    x = np.where(rng.random((3, n)) < 0.5, -1.5, 1.5).astype(np.float32)
    x[1, :7] = 9.0                          # 7 larger, then the tied rest
    x[2, ::3] = 0.0                         # zeros never survive
    out = topk_compact(torch.from_numpy(x), k, kcap, sign=sign)
    assert (out[3] == kcap).all()
    assert_compact_equal([a.numpy() for a in out],
                         jx.ops.topk_compact(jx.jnp.asarray(x), k, kcap,
                                             sign=sign, interpret=True),
                         sign, n, kcap)
    mem, idx = out[2].numpy(), out[0].numpy()
    emitted = np.zeros_like(x, dtype=bool)
    np.put_along_axis(emitted, idx.astype(np.int64), True, axis=1)
    np.testing.assert_array_equal(mem[~emitted], x[~emitted])


def test_compact_agrees_with_dense_form():
    """Decoding the compact slots gives topk_compress's dense survivors,
    the same memory and the same counts (no ties past kcap here)."""
    x = torch.from_numpy(compact_input(3, 4, 1152)[[0, 1, 3]])
    for sign in (False, True):
        idx, val, mem, cnt = ref.topk_compact_ref(x, 12, 128, sign=sign)
        sel, mem_d, cnt_d = ref.topk_compress_ref(x, 12, sign=sign)
        assert torch.equal(cnt, cnt_d) and torch.equal(mem, mem_d)
        assert torch.equal(dsp.decode_rows(idx, val, 1152), sel)


def test_wrapper_counts_launches_and_checks_inputs():
    x = torch.from_numpy(compact_input(0, 4, 256))
    before = LAUNCHES["topk_compact"]
    topk_compact(x, 5, 128)
    assert LAUNCHES["topk_compact"] == before + 1
    with pytest.raises(TypeError):
        topk_compact(x.double(), 5, 128)
    with pytest.raises(ValueError):
        topk_compact(x[:, ::2], 5, 128)             # not contiguous
    with pytest.raises(ValueError):
        topk_compact(x, 0, 128)
    with pytest.raises(ValueError):
        topk_compact(x, 5, 0)
    assert LAUNCHES["topk_compact"] == before + 1


# ---------------------------------------------------------------------------
# dispatch: compact_rows, compact_compress, would_compact, decode_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_compact_rows_matches_repro(jx, mode):
    x = compact_input(11, 6, 1152)
    kcap = dsp.capacity(12, 1152)
    before = LAUNCHES["topk_compact"]
    out = dsp.compact_rows(torch.from_numpy(x), 12, kcap,
                           cfg=dsp.DispatchConfig(mode=mode))
    assert LAUNCHES["topk_compact"] == before + (mode == "kernel")
    want = jx.dsp.compact_rows(jx.jnp.asarray(x), 12, kcap,
                               cfg=jx.dsp.DispatchConfig(mode=mode))
    assert_compact_equal([a.numpy() for a in out], want, False, 1152, kcap)
    assert not dsp.compact_rows_eligible(1152, 4096,
                                         dsp.DispatchConfig(mode="kernel"))
    assert not dsp.compact_rows_eligible(1000, 128,
                                         dsp.DispatchConfig(mode="kernel"))


def _ops(jops):
    """Each Top_k-family operator in both packages."""
    return [
        (TopK(k=0.02), jops.TopK(k=0.02)),
        (SignSparsifier(k=0.02, m=2), jops.SignSparsifier(k=0.02, m=2)),
        (RowTopK(k=0.05, row_len=256), jops.RowTopK(k=0.05, row_len=256)),
        (RowSignTopK(k=0.05, row_len=256, m=2),
         jops.RowSignTopK(k=0.05, row_len=256, m=2)),
    ]


@pytest.mark.parametrize("which", range(4))
def test_compact_compress_round_trip_matches_repro(jx, which):
    op_t, op_j = _ops(jx.jops)[which]
    x = tie_free(np.random.default_rng(which), (12, 200))
    cfg_t = dsp.DispatchConfig(mode="kernel")
    cfg_j = jx.dsp.DispatchConfig(mode="kernel")
    before = LAUNCHES["topk_compact"]
    leaf_t, used_t = dsp.compact_compress(op_t, None, torch.from_numpy(x),
                                          cfg_t)
    leaf_j, used_j = jx.dsp.compact_compress(op_j, None, jx.jnp.asarray(x),
                                             cfg_j)
    assert used_t == used_j is True
    assert LAUNCHES["topk_compact"] == before + 1
    assert (leaf_t.row_len, leaf_t.kcap) == (leaf_j.row_len, leaf_j.kcap)
    assert dsp.would_compact(op_t, x.shape, torch.float32, cfg_t)
    assert float(leaf_t.bits) == float(leaf_j.bits)
    sign = which % 2 == 1

    def counted(leaf):
        idx = np.asarray(leaf.idx)
        mem = np.zeros(idx.shape[0] * leaf.row_len, np.float32)
        mem[:x.size] = np.asarray(leaf.mem).reshape(-1)
        return [idx, np.asarray(leaf.val), mem,
                (idx < leaf.row_len).sum(axis=1).astype(np.int32)]

    assert_compact_equal(counted(leaf_t), counted(leaf_j), sign,
                         leaf_t.row_len, leaf_t.kcap)
    dense_t = dsp.densify_compact(leaf_t, x.shape).numpy()
    dense_j = np.asarray(jx.dsp.densify_compact(leaf_j, x.shape))
    np.testing.assert_allclose(dense_t, dense_j, rtol=1e-6 if sign else 0,
                               atol=0)
    # the round trip: payload + memory is the input, exactly for Top_k
    np.testing.assert_allclose(dense_t + leaf_t.mem.numpy(), x,
                               rtol=0, atol=1e-6 if sign else 0)
    # and it is the dense form's output
    dense_leaf, bits, _ = dsp.compress_leaf(op_t, None, torch.from_numpy(x),
                                            cfg_t)
    np.testing.assert_allclose(dense_t, dense_leaf.numpy(),
                               rtol=1e-6 if sign else 0, atol=0)
    assert float(bits) == float(leaf_t.bits)


def test_decode_rows_matches_repro(jx):
    rng = np.random.default_rng(2)
    n, kcap = 300, 16
    idx = np.full((5, kcap), n, np.int32)
    val = np.zeros((5, kcap), np.float32)
    for r in range(1, 5):
        c = rng.integers(1, kcap + 1)
        idx[r, :c] = np.sort(rng.choice(n, c, replace=False))
        val[r, :c] = rng.standard_normal(c)
    want = np.asarray(jx.dsp.decode_rows(jx.jnp.asarray(idx),
                                         jx.jnp.asarray(val), n))
    got = dsp.decode_rows(torch.from_numpy(idx), torch.from_numpy(val), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_compact_compress_refuses_other_operators():
    from repro_torch.core.operators import QSGDQuantizer
    with pytest.raises(TypeError):
        dsp.compact_compress(QSGDQuantizer(s=15), None, torch.zeros(256))
    assert not dsp.would_compact(QSGDQuantizer(s=15), (256,))


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", [
    (64, 1152, 12), (16, 1152, 1152), (64, 4096, 41), (8, 11008, 110),
    # around the longest row staged in shared memory (12288 floats)
    (4, 12288, 123), (4, 12416, 124)])
@pytest.mark.parametrize("sign", [False, True])
def test_compact_kernel_matches_plain_on_card(cuda, rows, n, k, sign):
    x = torch.from_numpy(compact_input(7, rows, n)).to(cuda)
    kcap = dsp.capacity(k, n)
    got = topk_compact(x, k, kcap, sign=sign)
    want = ref.topk_compact_ref(x, k, kcap, sign=sign)
    torch.cuda.synchronize()
    assert_compact_equal([a.cpu().numpy() for a in got],
                         [a.cpu().numpy() for a in want], sign, n, kcap)
