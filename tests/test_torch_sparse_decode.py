"""The decode ``sparse_gemm``'s walk and route, on the CPU.

At decode batches (M <= 8) ``sparse_gemm`` runs a CUDA kernel that stages
x in shared memory once a block and walks batches of output rows 32 slots
a round.  Here ``ref.sparse_gemm_rows_ref``, a plain PyTorch model of that
walk (row ranges per block, batches per warp, rounds of 32 lanes, the
butterfly sum across lanes), is held to the plain version
``ref.sparse_gemm_ref`` and to ``repro``'s ``sparse_gemm`` in interpret
mode on the same numpy inputs, within 1e-5 of the largest output (float32
sums in another order), at M = 1, 2, 3, 4 and 8 in float32 and bfloat16;
its visit counts show every live slot added exactly once and no sentinel
ever, and every row walked by one warp: ragged block ranges and batches,
rows longer than a round, full rows (k = kcap, no sentinel) with kcap
not a multiple of 32, empty rows, idx = n - 1.  The route the launch
takes is pinned at the serving shapes on an H100's geometry
(``sparse_route``); the ``gpu`` cases run the kernel on the card (this
file then runs without JAX, which the parity tests import).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.sparse_gemm import (
    DecodeGeometry, TileGeometry, decode_batch, decode_grid,
    decode_stage_bytes, sparse_route)

#: the library's geometries (qs_sparse_gemm_decode_geometry,
#: qs_sparse_gemm_geometry), pinned on the card by
#: test_decode_geometry_on_card and test_tile_geometry_on_card
DECODE_GEOMETRY = DecodeGeometry(max_m=8, smem=232448, warps=16)
TILE_GEOMETRY = TileGeometry(min_m=48, always_m=256, tile_m=128, tile_r=128,
                             tile_r_wide=256, chunk_f32=128, chunk_bf16=256,
                             smem=198656)
H100_SMS = 132


@pytest.fixture
def jx():
    """``repro``'s sparse GEMM and oracle (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref, sparse_gemm as jsg
    return types.SimpleNamespace(jnp=jnp, ref=jref, sg=jsg)


def decode_rows_of(rng, R, n, kcap):
    """Compact buffers [R, kcap]: row 0 empty, row 1 full (k = kcap, no
    sentinel), row 2 only idx = 0 and n - 1, row 3 a run longer than a
    round (where kcap allows), the rest a random count of ascending
    random indices."""
    idx = np.full((R, kcap), n, np.int32)
    val = np.zeros((R, kcap), np.float32)
    rows = [np.sort(rng.choice(n, min(kcap, n), replace=False)),
            np.array([0, n - 1])]
    if kcap >= 38:
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


#: (R, n, kcap, sms): several blocks with a ragged last batch, blocks
#: capped by the SMs, one block with rows in one batch
DECODE_CASES = [(150, 100, 40, 132), (300, 257, 64, 3), (20, 45, 45, 132)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("R,n,kcap,sms", DECODE_CASES)
def test_decode_walk_matches_plain_and_repro(jx, R, n, kcap, sms, M, dtype):
    rng = np.random.RandomState(M * 1000 + R + n)
    x = rng.randn(M, n).astype(np.float32)
    idx, val = decode_rows_of(rng, R, n, kcap)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    blocks, rows = decode_grid(M, R, sms, DECODE_GEOMETRY)
    y, visits, walks = ref.sparse_gemm_rows_ref(
        xt, torch.from_numpy(idx), torch.from_numpy(val), n, blocks, rows)
    np.testing.assert_array_equal(visits.numpy(), (idx < n).astype(np.int64))
    np.testing.assert_array_equal(walks.numpy(), np.ones(R, np.int64))
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


def test_decode_walk_stops_at_the_first_sentinel():
    """No slot after a row's first sentinel is added, in its round or
    later ones, and an index outside [0, n) reads as the sentinel."""
    n, kcap = 50, 70
    idx = np.full((4, kcap), n, np.int32)
    val = np.ones((4, kcap), np.float32)
    idx[0, :3] = [1, 2, 3]
    idx[0, 5:7] = [7, 8]                     # live slots past a sentinel
    idx[0, 40:42] = [9, 10]                  # and in a later round
    idx[1, :2] = [4, -1]
    idx[2, :2] = [5, n + 7]
    idx[3, :33] = np.arange(33)              # a second round, then stop
    idx[3, 34] = 40
    x = torch.arange(2 * n, dtype=torch.float32).reshape(2, n)
    y, visits, _ = ref.sparse_gemm_rows_ref(
        x, torch.from_numpy(idx), torch.from_numpy(val), n, 2, 2)
    assert visits[0].tolist() == [1, 1, 1] + [0] * (kcap - 3)
    assert visits[1].tolist() == [1] + [0] * (kcap - 1)
    assert visits[2].tolist() == [1] + [0] * (kcap - 1)
    assert visits[3].tolist() == [1] * 33 + [0] * (kcap - 33)
    np.testing.assert_array_equal(y[:, 0].numpy(), x[:, 1:4].sum(1).numpy())
    np.testing.assert_array_equal(y[:, 1].numpy(), x[:, 4].numpy())


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("R", [1, 31, 32, 33, 256, 512, 1152, 4096, 11008])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_decode_grid_covers_every_row_once(M, R, sms):
    blocks, rows = decode_grid(M, R, sms, DECODE_GEOMETRY)
    assert 1 <= blocks <= sms
    # no more blocks than give each warp a batch of rows
    per_round = DECODE_GEOMETRY.warps * decode_batch(M)
    assert blocks == 1 or R > (blocks - 1) * per_round
    owner = np.full(R, -1)
    for b in range(blocks):
        lo, hi = b * rows, min(R, (b + 1) * rows)
        assert lo < hi                      # no block without rows
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = b
    assert (owner >= 0).all()


def test_decode_stage_bytes():
    """A record of 1, 2, 4 or 8 activation rows a column, the columns
    rounded up to whole 16-byte loads: Yi-6B's w2 input at M = 8 in
    bfloat16 is 172 KB; in float32 it is past the 227 KB a block has."""
    assert decode_stage_bytes(8, 11008, 2) == 11008 * 16
    assert decode_stage_bytes(4, 1152, 2) == 1152 * 8
    assert decode_stage_bytes(3, 1152, 2) == 1152 * 8
    assert decode_stage_bytes(1, 45, 2) == 48 * 2
    assert decode_stage_bytes(5, 45, 4) == 48 * 32
    assert decode_stage_bytes(8, 11008, 4) > DECODE_GEOMETRY.smem
    assert decode_stage_bytes(4, 11008, 4) <= DECODE_GEOMETRY.smem


#: (M, R, n, x bytes, route): the serving paths' shapes on an H100 (132
#: SMs): Yi-6B at decode (batch 8: w1 / w3, w2, wq / wo, wk / wv) and
#: gemma3-1b (batch 4: w1 / w3, w2, wq, wo, wk / wv), bfloat16 x; the
#: float32 smoke widths; M either side of the decode kernel's limit and
#: of its staging; prefill widths
ROUTE_CASES = [
    (8, 11008, 4096, 2, "decode"), (8, 4096, 11008, 2, "decode"),
    (8, 4096, 4096, 2, "decode"), (8, 512, 4096, 2, "decode"),
    (4, 6912, 1152, 2, "decode"), (4, 1152, 6912, 2, "decode"),
    (4, 1024, 1152, 2, "decode"), (4, 1152, 1024, 2, "decode"),
    (4, 256, 1152, 2, "decode"), (1, 11008, 4096, 2, "decode"),
    (8, 11008, 4096, 4, "decode"), (4, 4096, 11008, 4, "decode"),
    (8, 4096, 11008, 4, "rows"), (5, 4096, 11008, 4, "rows"),
    (8, 4096, 14528, 2, "decode"), (8, 4096, 14536, 2, "rows"),
    (9, 11008, 4096, 2, "rows"), (47, 6912, 1152, 2, "rows"),
    (48, 6912, 1152, 2, "tiled"), (128, 11008, 4096, 2, "tiled"),
    (2048, 6912, 1152, 2, "tiled"), (2048, 1152, 6912, 2, "tiled"),
]


@pytest.mark.parametrize("M,R,n,x_bytes,route", ROUTE_CASES)
def test_sparse_route_at_the_serving_shapes(M, R, n, x_bytes, route):
    assert sparse_route(M, R, n, x_bytes, H100_SMS, TILE_GEOMETRY,
                        DECODE_GEOMETRY) == route


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_decode_geometry_on_card(card):
    """The library's geometries are the ones the route tests above are
    pinned with."""
    from repro_torch.kernels.sparse_gemm import decode_geometry, tile_geometry
    assert decode_geometry() == DECODE_GEOMETRY
    assert tile_geometry() == TILE_GEOMETRY


def card_buffers(g, R, n, k, kcap, device):
    """k ascending random survivors a row, the sentinel after them; row 0
    empty, row 1 full (k = kcap)."""
    idx = torch.full((R, kcap), n, dtype=torch.int32, device=device)
    keys = torch.rand((R, n), generator=g, device=device)
    idx[:, :k] = torch.sort(torch.topk(keys, k, dim=1).indices,
                            dim=1).values.to(torch.int32)
    val = torch.zeros((R, kcap), device=device)
    val[:, :k] = torch.randn((R, k), generator=g, device=device)
    idx[0], val[0] = n, 0.0
    full = min(kcap, n)
    idx[1, :full] = torch.sort(torch.randperm(
        n, generator=torch.Generator().manual_seed(R))[:full]).values.to(
            device=device, dtype=torch.int32)
    val[1, :full] = 1.0
    return idx, val


#: (R, n, k): the serving shapes (Yi-6B's four matrices, gemma3-1b's
#: five), a ragged R and a row length that is not a multiple of 8
CARD_SHAPES = [(11008, 4096, 41), (4096, 11008, 110), (4096, 4096, 41),
               (512, 4096, 41), (6912, 1152, 12), (1152, 6912, 69),
               (1024, 1152, 12), (1152, 1024, 10), (256, 1152, 12),
               (1001, 1150, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("R,n,k", CARD_SHAPES)
def test_sparse_gemm_decode_on_card(card, R, n, k, M, dtype):
    """The decode kernel within 1e-5 of the largest output of the plain
    version, and the launch takes the kernel ``sparse_route`` names (its
    output that kernel's, bit for bit)."""
    from repro_torch.kernels.flash_attention import sm_count
    from repro_torch.kernels.sparse_gemm import (
        decode_geometry, sparse_gemm, sparse_gemm_route, tile_geometry)
    g = torch.Generator(device=card).manual_seed(M * R + n)
    idx, val = card_buffers(g, R, n, k, 128, card)
    x = torch.randn((M, n), generator=g, device=card).to(dtype)
    want = ref.sparse_gemm_ref(x, idx, val, n)
    route = sparse_route(M, R, n, x.element_size(), sm_count(
        card.index or 0), tile_geometry(), decode_geometry())
    auto = sparse_gemm(x, idx, val, n)
    got = sparse_gemm_route(x, idx, val, n, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(auto, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(auto, got)
    assert not auto[:, 0].any()
    if dtype == torch.bfloat16:
        assert route == "decode"


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8])
def test_sparse_gemm_decode_unaligned_on_card(card, M):
    """x at an offset of one element (not 16-byte aligned) and row lengths
    that are not a multiple of 8: the staging's element path; and a
    forced decode launch past its staging is refused."""
    from repro_torch.kernels.sparse_gemm import sparse_gemm_route
    g = torch.Generator(device=card).manual_seed(M)
    for n in (1152, 1150, 7):
        idx, val = card_buffers(g, 300, n, min(12, n), 128 if n > 128 else n,
                                card)
        flat = torch.randn(M * n + 1, generator=g, device=card).to(
            torch.bfloat16)
        x = flat[1:].view(M, n)
        y = sparse_gemm_route(x, idx, val, n, "decode")
        want = ref.sparse_gemm_ref(x, idx, val, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    x = torch.zeros((9, 64), device=card)
    idx, val = card_buffers(g, 8, 64, 4, 32, card)
    with pytest.raises(RuntimeError):
        sparse_gemm_route(x, idx, val, 64, "decode")
