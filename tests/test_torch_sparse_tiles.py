"""The tiled ``sparse_gemm``'s walk and the factored ``qdq_gemm``, on the
CPU.

At prefill widths ``sparse_gemm`` runs a tiled CUDA kernel: blocks of
``tile_m`` activation rows and ``tile_r`` output rows walk the columns in
chunks, each row with a cursor and a batch of 32 slots.  Here
``ref.sparse_gemm_tiled_ref``, a plain PyTorch model of that walk, is held
to the plain version ``ref.sparse_gemm_ref`` and to ``repro``'s
``sparse_gemm`` in interpret mode on the same numpy inputs, within 1e-5 of
the largest output (float32 sums in another order), and its visit counts
show that every live slot is added exactly once and no sentinel ever:
ragged M and R, runs that straddle chunk edges, runs longer than a batch,
full rows (k = kcap, no sentinel) with kcap not a multiple of 32, empty
rows, idx = n - 1, float32 and bfloat16 x.  ``qdq_gemm`` folds the scale
out of the row's sum; ``ref.qdq_gemm_factored_ref`` is held to the plain
version and to ``repro``'s interpret-mode ``qdq_gemm`` the same way.  The
launch's choice between the two ``sparse_gemm`` kernels is pinned at the
card's geometry (``tiled_route``), and that geometry against the
library's on the card (``gpu`` marker: this file then runs without JAX,
which the parity tests import).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.sparse_gemm import TileGeometry, tiled_route

#: the library's geometry (qs_sparse_gemm_geometry), pinned on the card by
#: test_tile_geometry_on_card
TILE_GEOMETRY = TileGeometry(min_m=48, always_m=256, tile_m=128, tile_r=128,
                             tile_r_wide=256, chunk_f32=128, chunk_bf16=256,
                             smem=198656)
H100_SMS = 132


@pytest.fixture
def jx():
    """``repro``'s sparse GEMMs and oracles (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref, sparse_gemm as jsg
    return types.SimpleNamespace(jnp=jnp, ref=jref, sg=jsg)


def tile_rows(rng, R, n, kcap, chunk):
    """Compact buffers [R, kcap] with rows of every kind the walk meets:
    row 0 empty, row 1 full (k = kcap, no sentinel), row 2 only idx = 0
    and n - 1, row 3 a dense run across the first chunk edge, row 4 a run
    longer than a batch inside one chunk (where the chunk is that wide),
    the rest a random count of ascending random indices."""
    idx = np.full((R, kcap), n, np.int32)
    val = np.zeros((R, kcap), np.float32)
    rows = [np.sort(rng.choice(n, min(kcap, n), replace=False)),
            np.array([0, n - 1]),
            np.arange(max(0, chunk - 3), min(n, chunk + 4))]
    if chunk >= 40 and kcap >= 40:
        rows.append(np.arange(1, 39))
    for r in range(1, R):
        if r - 1 < len(rows):
            cols = rows[r - 1][:kcap]
        else:
            k = rng.randint(1, min(kcap, n) + 1)
            cols = np.sort(rng.choice(n, k, replace=False))
        idx[r, :len(cols)] = cols
        val[r, :len(cols)] = rng.randn(len(cols))
    return idx, val


#: (M, R, n, kcap, tile_m, tile_r, chunk)
TILE_CASES = [
    (37, 13, 100, 40, 16, 8, 16),        # ragged tiles, refills mid-chunk
    (5, 7, 64, 64, 4, 4, 32),            # n a whole number of chunks
    (130, 9, 300, 96, 128, 8, 128),      # the card's tile_m, one row over
    (3, 33, 257, 33, 2, 16, 256),        # kcap 33: full rows past a batch
    (129, 40, 520, 128, 128, 128, 256),  # the card's bf16 geometry
    (64, 300, 131, 48, 128, 256, 128),   # the card's f32 chunk, wide slab
    (8, 5, 45, 45, 8, 4, 45),            # every row in one chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,R,n,kcap,tile_m,tile_r,chunk", TILE_CASES)
def test_tiled_walk_matches_plain_and_repro(jx, M, R, n, kcap, tile_m,
                                            tile_r, chunk, dtype):
    rng = np.random.RandomState(M * 1000 + R + n)
    x = rng.randn(M, n).astype(np.float32)
    idx, val = tile_rows(rng, R, n, kcap, chunk)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y, visits = ref.sparse_gemm_tiled_ref(
        xt, torch.from_numpy(idx), torch.from_numpy(val), n, tile_m, tile_r,
        chunk)
    np.testing.assert_array_equal(visits.numpy(), (idx < n).astype(np.int64))
    y = y.numpy()
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(y).max()))
    want = ref.sparse_gemm_ref(xt, torch.from_numpy(idx),
                               torch.from_numpy(val), n).numpy()
    np.testing.assert_allclose(y, want, **tol)
    xj = jx.jnp.asarray(x).astype(getattr(jx.jnp, dtype))
    ij, vj = jx.jnp.asarray(idx), jx.jnp.asarray(val)
    np.testing.assert_allclose(
        y, np.asarray(jx.sg.sparse_gemm(xj, ij, vj, n, interpret=True)),
        **tol)
    np.testing.assert_allclose(
        y, np.asarray(jx.ref.sparse_gemm_ref(xj, ij, vj, n)), **tol)
    assert not y[:, 0].any()                 # the empty row


def test_tiled_walk_stops_at_the_first_sentinel():
    """No batch after the one that holds a row's first sentinel is read
    (whatever the slots past it hold), and an index outside [0, n) reads
    as the sentinel."""
    n, kcap = 50, 40
    idx = np.full((3, kcap), n, np.int32)
    val = np.ones((3, kcap), np.float32)
    idx[0, :3] = [1, 2, 3]
    idx[0, 32:34] = [7, 8]                   # a batch past the sentinels
    idx[1, :2] = [4, -1]
    idx[2, :2] = [5, n + 7]
    x = torch.arange(2 * n, dtype=torch.float32).reshape(2, n)
    y, visits = ref.sparse_gemm_tiled_ref(x, torch.from_numpy(idx),
                                          torch.from_numpy(val), n, 2, 2, 16)
    assert visits[0].tolist() == [1, 1, 1] + [0] * (kcap - 3)
    assert visits[1].tolist() == [1] + [0] * (kcap - 1)
    assert visits[2].tolist() == [1] + [0] * (kcap - 1)
    np.testing.assert_array_equal(y[:, 0].numpy(), x[:, 1:4].sum(1).numpy())
    np.testing.assert_array_equal(y[:, 1].numpy(), x[:, 4].numpy())


def test_tiled_walk_rejects_descending_indices():
    idx = torch.tensor([[9, 3, 20]], dtype=torch.int32)
    with pytest.raises(AssertionError, match="ascend"):
        ref.sparse_gemm_tiled_ref(torch.ones(2, 20), idx, torch.ones(1, 3),
                                  20, 2, 1, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 13])
@pytest.mark.parametrize("n", [20, 36, 64])
def test_qdq_factored_matches_plain_and_repro(jx, M, n, dtype):
    rng = np.random.RandomState(M * 100 + n)
    R = 11
    x = rng.randn(M, n).astype(np.float32)
    lv = rng.randint(-127, 128, (R, n)).astype(np.int8)
    scale = (rng.rand(R, 1) * 0.01).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = ref.qdq_gemm_factored_ref(xt, torch.from_numpy(lv),
                                  torch.from_numpy(scale)).numpy()
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(y).max()))
    np.testing.assert_allclose(
        y, ref.qdq_gemm_ref(xt, torch.from_numpy(lv),
                            torch.from_numpy(scale)).numpy(), **tol)
    xj = jx.jnp.asarray(x).astype(getattr(jx.jnp, dtype))
    lj, sj = jx.jnp.asarray(lv), jx.jnp.asarray(scale)
    np.testing.assert_allclose(
        y, np.asarray(jx.sg.qdq_gemm(xj, lj, sj, interpret=True)), **tol)
    np.testing.assert_allclose(
        y, np.asarray(jx.ref.qdq_gemm_ref(xj, lj, sj)), **tol)


#: (M, R, n, tiled): the serving paths' shapes on an H100 (132 SMs):
#: decode batches, Yi-6B's 128-token prefill, gemma3-1b's 2048-token one,
#: and M either side of the crossover
ROUTE_CASES = [
    (8, 11008, 4096, False), (4, 6912, 1152, False), (1, 262144, 1152, False),
    (128, 11008, 4096, True), (128, 4096, 11008, False),
    (128, 4096, 4096, False), (128, 512, 4096, False),
    (2048, 6912, 1152, True), (2048, 1152, 6912, True),
    (2048, 1024, 1152, True), (2048, 256, 1152, True),
    (2048, 1152, 1024, True), (1100, 6912, 1152, True),
    (47, 6912, 1152, False), (48, 6912, 1152, True),
    (63, 11008, 4096, True), (200, 1152, 6912, False),
    (256, 1152, 6912, True), (256, 8, 16, True),
]


@pytest.mark.parametrize("M,R,n,tiled", ROUTE_CASES)
def test_tiled_route_at_the_serving_shapes(M, R, n, tiled):
    assert tiled_route(M, R, H100_SMS, TILE_GEOMETRY) is tiled


@pytest.mark.gpu
def test_tile_geometry_on_card():
    """The library's geometry is the one the route tests above are
    pinned with, and a 32-warp block's shared memory fits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from repro_torch.kernels.sparse_gemm import tile_geometry
    geo = tile_geometry()
    assert geo == TILE_GEOMETRY
    assert geo.smem <= 232448               # 227 KB a block on sm_90
