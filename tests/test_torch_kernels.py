"""The port's kernel wrappers against ``repro``'s Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version
(``repro_torch/kernels/ref.py``); here that is held against ``repro``'s
``topk_compress`` / ``qsgd_quantize`` in interpret mode and against
``repro``'s own ``ref.py`` oracles, on the same numpy inputs.

Tolerances: the Top_k survivor mask, the counts and (for plain Top_k)
the selected values and memory are exact — the threshold is found with
exact compares and integer counts.  SignTop_k values carry ||sel||_2, a
float sum whose order differs between the frameworks: rtol 1e-6.  QSGD
carries the row norm the same way: rtol 1e-6 with the same uniforms.
The CUDA kernels themselves run only on the card (``gpu`` marker); this
file then runs without JAX (``pytest -m gpu tests/test_torch_kernels.py``),
so ``repro`` is imported by the parity tests themselves.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.qsgd import qsgd_quantize
from repro_torch.kernels.topk_compress import topk_compress


def tie_free(rng, shape, lo=0.05, hi=4.0):
    """float32 values with strictly distinct magnitudes, shuffled."""
    d = int(np.prod(shape))
    mags = np.linspace(lo, hi, d, dtype=np.float32)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mags * signs)[rng.permutation(d)].reshape(shape)


def topk_input(seed, rows, n):
    """Tie-free rows plus an all-zero row, a zero-padded tail and a row
    of equal magnitudes (ties), which the threshold rule handles
    deterministically."""
    rng = np.random.default_rng(seed)
    x = tie_free(rng, (rows, n))
    x[0] = 0.0
    x[1, n // 2:] = 0.0
    x[2] = np.where(rng.random(n) < 0.5, -1.5, 1.5)
    return x


@pytest.fixture
def jx():
    """``repro``'s kernels and oracles (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import qsgd, ref as jref, topk_compress
    return types.SimpleNamespace(jnp=jnp, qsgd=qsgd, ref=jref,
                                 topk=topk_compress)


TOPK_CASES = [(4, 128, 1), (5, 1024, 100), (3, 384, 384)]


@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("rows,n,k", TOPK_CASES)
def test_topk_plain_matches_repro(jx, rows, n, k, sign):
    x = topk_input(rows * n + k, rows, n)
    sel_j, mem_j, cnt_j = (np.asarray(a) for a in jx.topk.topk_compress(
        jx.jnp.asarray(x), k, sign=sign, interpret=True))
    sel_o, mem_o, cnt_o = (np.asarray(a) for a in jx.ref.topk_compress_ref(
        jx.jnp.asarray(x), k, sign=sign))
    sel_t, mem_t, cnt_t = (a.numpy() for a in topk_compress(
        torch.from_numpy(x), k, sign=sign))
    assert cnt_t.dtype == np.int32
    for sel_r, cnt_r in ((sel_j, cnt_j), (sel_o, cnt_o)):
        np.testing.assert_array_equal(cnt_t, cnt_r)
        np.testing.assert_array_equal(sel_t != 0, sel_r != 0)
    if sign:
        np.testing.assert_allclose(sel_t, sel_j, rtol=1e-6, atol=0)
        np.testing.assert_allclose(mem_t, mem_j, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(sel_t, sel_j)
        np.testing.assert_array_equal(mem_t, mem_j)
        np.testing.assert_array_equal(mem_t, x - sel_t)
    assert cnt_t[0] == 0                       # exact zeros never survive
    assert (cnt_t[3:] == k).all()              # tie-free rows keep exactly k


@pytest.mark.parametrize("rows,n,s", [(1, 128, 15), (3, 1024, 15),
                                      (7, 640, 1), (2, 256, 255)])
def test_qsgd_plain_matches_repro(jx, rows, n, s):
    rng = np.random.default_rng(rows * n + s)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[0, : n // 2] = 0.0
    if rows > 2:
        x[2] = 0.0                              # a zero bucket gives 0
    u = rng.random((rows, n)).astype(np.float32)
    jnp = jx.jnp
    out_j = np.asarray(jx.qsgd.qsgd_quantize(jnp.asarray(x), jnp.asarray(u),
                                             s, interpret=True))
    out_o = np.asarray(jx.ref.qsgd_bucketed_ref(jnp.asarray(x),
                                                jnp.asarray(u), s))
    out_t = qsgd_quantize(torch.from_numpy(x), torch.from_numpy(u), s).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out_t, out_o, rtol=1e-6, atol=0)
    if rows > 2:
        assert (out_t[2] == 0).all()


def test_wrappers_count_launches_and_check_inputs():
    x = torch.from_numpy(topk_input(0, 4, 256))
    before = dict(LAUNCHES)
    topk_compress(x, 5)
    qsgd_quantize(x, torch.rand(x.shape), 15)
    assert LAUNCHES["topk_compress"] == before["topk_compress"] + 1
    assert LAUNCHES["qsgd"] == before["qsgd"] + 1
    with pytest.raises(TypeError):
        topk_compress(x.double(), 5)
    with pytest.raises(ValueError):
        topk_compress(x[:, ::2], 5)             # not contiguous
    with pytest.raises(ValueError):
        topk_compress(x, 0)
    with pytest.raises(ValueError):
        qsgd_quantize(x, torch.rand(4, 128), 15)
    assert LAUNCHES["topk_compress"] == before["topk_compress"] + 1


def test_kernel_modules_import_without_nvcc():
    """Importing (and running on the CPU) builds nothing: the library is
    built at the first launch on a CUDA tensor only."""
    topk_compress(torch.from_numpy(topk_input(1, 4, 128)), 3)
    assert _build._LIB is None
    assert _build.SIGNATURES.keys() >= {"qs_topk_compress_f32",
                                        "qs_qsgd_quantize_f32"}
    assert any(s.endswith("topk_compress.cu") for s in _build.sources())
    assert any(s.endswith("qsgd.cu") for s in _build.sources())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _same_topk(got, want, sign):
    """Counts and survivor masks exactly; plain Top_k values and memory
    bit for bit, SignTop_k values within rtol 1e-6."""
    (sel, mem, cnt), (sel_r, mem_r, cnt_r) = got, want
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt_r)
    assert torch.equal(sel != 0, sel_r != 0)
    if sign:
        torch.testing.assert_close(sel, sel_r, rtol=1e-6, atol=0)
    else:
        assert torch.equal(sel, sel_r) and torch.equal(mem, mem_r)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", [
    (64, 4096, 41), (4, 65536, 655),
    # around the longest row staged in shared memory (12288 floats, more
    # than the default 48 KB per block with the kernel's scratch)
    (4, 12160, 121), (4, 12288, 123), (4, 12416, 124),
    # the global TopK shapes chip_smoke.py times (clusters of 16 and 8),
    # and a 2^21 row
    (16, 524288, 5243), (8, 524288, 5243), (56, 65536, 655),
    (3, 1 << 21, 20972)])
@pytest.mark.parametrize("sign", [False, True])
def test_topk_kernel_matches_plain_on_card(cuda, rows, n, k, sign):
    x = torch.from_numpy(topk_input(7, rows, n)).to(cuda)
    _same_topk(topk_compress(x, k, sign=sign),
               ref.topk_compress_ref(x, k, sign=sign), sign)


def long_rows(seed, rows, n):
    """Rows the cluster kernel must get exactly right: heavy ties at the
    threshold (few distinct magnitudes), zeros with -0.0, subnormals,
    magnitudes past FLT_MAX / 2 (counted in full, lo + hi may overflow),
    one magnitude throughout (hi is never lowered), a spike."""
    rng = np.random.default_rng(seed)
    x = np.empty((rows, n), np.float32)
    for r in range(rows):
        kind = r % 6
        if kind == 0:
            x[r] = rng.choice([-2.0, -1.0, 0.0, 0.5, 1.0, 2.0], n)
        elif kind == 1:
            x[r] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
            x[r, rng.integers(n, size=50)] = rng.standard_normal(50)
        elif kind == 2:
            x[r] = rng.standard_normal(n) * 1e-40
        elif kind == 3:
            x[r] = rng.uniform(-3.4e38, 3.4e38, n)
        elif kind == 4:
            x[r] = np.where(rng.random(n) < 0.5, -3.0, 3.0)
        else:
            x[r] = 0.0
            x[r, rng.integers(n)] = 5.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("force8", [False, True])
@pytest.mark.parametrize("n,k", [(65536, 655), (524288, 5243),
                                 (13001, 1)])
@pytest.mark.parametrize("sign", [False, True])
def test_topk_cluster_kernel_edge_rows_on_card(cuda, monkeypatch, n, k,
                                               sign, force8):
    """The long-row kernel at both cluster sizes (``force8``: as on a card
    where clusters of 16 do not schedule), on heavy-tie and edge rows,
    a row length that is not a multiple of 4 and a start that is not on
    a 16-byte boundary (both take the scalar loads)."""
    from repro_torch.kernels import topk_compress as tk
    if force8:
        capacity = tk.cluster_capacity
        monkeypatch.setattr(tk, "cluster_capacity",
                            lambda index, cs, chunk: 0 if cs == 16
                            else capacity(index, cs, chunk))
    x = torch.from_numpy(long_rows(n + k, 6, n)).to(cuda)
    _same_topk(topk_compress(x, k, sign=sign),
               ref.topk_compress_ref(x, k, sign=sign), sign)
    flat = torch.zeros(6 * n + 1, device=cuda)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(6, n)          # 4 bytes past the allocation
    assert shifted.data_ptr() % 16
    _same_topk(topk_compress(shifted, k, sign=sign),
               ref.topk_compress_ref(x, k, sign=sign), sign)


@pytest.mark.gpu
def test_topk_cluster_capacity_on_card(cuda):
    """Clusters of 16 blocks schedule on an H100 for 524288-float rows,
    and the portable 8 do, as many at once as
    tests/test_torch_topk_levels.py's MAIN_SHAPES take."""
    from repro_torch.kernels.topk_compress import cluster_capacity
    index = torch.cuda.current_device()
    assert cluster_capacity(index, 8, 65536) >= 16
    assert cluster_capacity(index, 16, 32768) >= 8


@pytest.mark.gpu
def test_qsgd_kernel_matches_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((7, 65536), generator=g, device=cuda)
    u = torch.rand((7, 65536), generator=g, device=cuda)
    out = qsgd_quantize(x, u, 15)
    out_r = ref.qsgd_bucketed_ref(x, u, 15)
    torch.cuda.synchronize()
    far = ~torch.isclose(out, out_r, rtol=1e-6, atol=0)
    assert int(far.sum()) <= 16


# ---------------------------------------------------------------------------
# the serving kernels on the card, at Yi-6B's shapes: each against its
# plain version with TF32 off.  Tolerances: the GEMMs sum float32
# products in another order, within 1e-5 of the largest output; decode
# attention within 1e-5 in float32 and one bfloat16 rounding (2^-7 of
# the largest output) in bfloat16; length-0 rows exactly zero.
# ---------------------------------------------------------------------------


def compact_buffers(g, R, n, k, kcap, device):
    """Ascending random survivors per row (k of them, one row empty),
    the sentinel (n, 0) after them: the layout compress_tree builds."""
    idx = torch.full((R, kcap), n, dtype=torch.int32, device=device)
    keys = torch.rand((R, n), generator=g, device=device)
    top = torch.sort(torch.topk(keys, k, dim=1).indices, dim=1).values
    idx[:, :k] = top.to(torch.int32)
    idx[0] = n
    val = torch.zeros((R, kcap), device=device)
    val[:, :k] = torch.randn((R, k), generator=g, device=device)
    val[0] = 0.0
    return idx, val


def _close_to_scale(out, want, rtol, scale):
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=scale * float(want.float().abs().max()))


@pytest.fixture
def exact_f32(cuda):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("M,R,n,k", [
    (8, 11008, 4096, 41),       # w1 / w3 at decode
    (8, 4096, 11008, 110),      # w2 at decode
    (128, 512, 4096, 41),       # wk / wv at prefill
    (1, 4096, 4096, 41),
    (128, 11008, 4096, 41),     # w1 / w3 at prefill: the tiled kernel
    (4, 6912, 1152, 12),        # gemma3-1b w1 / w3 and w2 at decode
    (4, 1152, 6912, 69),
    (2048, 6912, 1152, 12),     # ... at a 2048-token prefill
    (2048, 1152, 6912, 69),
    (1100, 6912, 1152, 12),     # ... a ragged one
    (1100, 1152, 6912, 69),
    (2048, 256, 1152, 12),      # gemma3-1b wk / wv
    (47, 6912, 1152, 12),       # one below, at and above the crossover
    (48, 6912, 1152, 12),
    (49, 6912, 1152, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_gemm_kernel_matches_plain_on_card(exact_f32, M, R, n, k,
                                                  dtype):
    from repro_torch.kernels.sparse_gemm import sparse_gemm
    g = torch.Generator(device=exact_f32).manual_seed(M + R)
    idx, val = compact_buffers(g, R, n, k, 128, exact_f32)
    x = torch.randn((M, n), generator=g, device=exact_f32).to(dtype)
    y = sparse_gemm(x, idx, val, n)
    want = ref.sparse_gemm_ref(x, idx, val, n)
    torch.cuda.synchronize()
    _close_to_scale(y, want, 1e-5, 1e-5)
    assert not y[:, 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("M,R,n,k", [
    (47, 6912, 1152, 12), (48, 6912, 1152, 12), (128, 4096, 11008, 110),
    (300, 1152, 6912, 69), (130, 300, 100, 128), (64, 6000, 4096, 41)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_gemm_routes_on_card(exact_f32, M, R, n, k, dtype):
    """Both kernels agree with the plain version at one shape, and the
    launch takes the one ``tiled_route`` names: its output is that
    kernel's, bit for bit (each sums in its own fixed order)."""
    from repro_torch.kernels.sparse_gemm import (
        sparse_gemm, sparse_gemm_route, tile_geometry, tiled_route)
    from repro_torch.kernels.flash_attention import sm_count
    g = torch.Generator(device=exact_f32).manual_seed(M * R + n)
    idx, val = compact_buffers(g, R, n, min(k, n), 128, exact_f32)
    x = torch.randn((M, n), generator=g, device=exact_f32).to(dtype)
    want = ref.sparse_gemm_ref(x, idx, val, n)
    got = {r: sparse_gemm_route(x, idx, val, n, r) for r in ("rows", "tiled")}
    auto = sparse_gemm(x, idx, val, n)
    torch.cuda.synchronize()
    for y in got.values():
        _close_to_scale(y, want, 1e-5, 1e-5)
    tiled = tiled_route(M, R, sm_count(exact_f32.index or 0), tile_geometry())
    assert torch.equal(auto, got["tiled" if tiled else "rows"])


@pytest.mark.gpu
def test_sparse_gemm_tiled_unaligned_on_card(exact_f32):
    """x at an offset of one element (not 16-byte aligned) and a row
    length that is not a multiple of 8: the staging's element path."""
    from repro_torch.kernels.sparse_gemm import sparse_gemm_route
    g = torch.Generator(device=exact_f32).manual_seed(5)
    for n in (1152, 1150):
        idx, val = compact_buffers(g, 700, n, 12, 128, exact_f32)
        flat = torch.randn(300 * n + 1, generator=g, device=exact_f32).to(
            torch.bfloat16)
        x = flat[1:].view(300, n)
        y = sparse_gemm_route(x, idx, val, n, "tiled")
        want = ref.sparse_gemm_ref(x, idx, val, n)
        torch.cuda.synchronize()
        _close_to_scale(y, want, 1e-5, 1e-5)


#: (R, n): the two QSGD heads (Yi-6B's 64000 x 4096, gemma3-1b's tied
#: 262144 x 1152), a row length that is a multiple of 4 but not of 16,
#: and a long one (the tensor cores' partial sums)
QDQ_HEADS = [(64000, 4096), (262144, 1152), (3000, 4100), (3000, 11008)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("R,n", QDQ_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdq_gemm_kernel_matches_plain_on_card(exact_f32, M, R, n, dtype):
    from repro_torch.kernels.sparse_gemm import qdq_gemm
    g = torch.Generator(device=exact_f32).manual_seed(M + R)
    lv = torch.randint(-127, 128, (R, n), generator=g, device=exact_f32,
                       dtype=torch.int8)
    scale = torch.rand((R, 1), generator=g, device=exact_f32)
    x = torch.randn((M, n), generator=g, device=exact_f32).to(dtype)
    y = qdq_gemm(x, lv, scale)
    want = ref.qdq_gemm_ref(x, lv, scale)
    torch.cuda.synchronize()
    _close_to_scale(y, want, 1e-5, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [4, 8, 12, 16])
def test_qdq_gemm_level_views_on_card(exact_f32, offset):
    """Levels that start 4, 8 or 12 bytes past a 16-byte boundary (a
    layer view of a stacked leaf) take the 4-byte loads; 16 the wide
    ones."""
    from repro_torch.kernels.sparse_gemm import qdq_gemm
    g = torch.Generator(device=exact_f32).manual_seed(offset)
    R, n = 5000, 1152
    flat = torch.randint(-127, 128, (R * n + offset,), generator=g,
                         device=exact_f32, dtype=torch.int8)
    lv = flat[offset:].view(R, n)
    scale = torch.rand((R, 1), generator=g, device=exact_f32)
    x = torch.randn((4, n), generator=g, device=exact_f32).to(torch.bfloat16)
    y = qdq_gemm(x, lv, scale)
    want = ref.qdq_gemm_ref(x, lv, scale)
    torch.cuda.synchronize()
    _close_to_scale(y, want, 1e-5, 1e-5)


def paged_case(g, device, dtype, quant, B=8, H=32, KV=4, hd=128, ps=16,
               P=32, n_pages=256):
    """A Yi-6B decode batch on a page pool: a free slot (length 0), a
    full row, partial rows, -1 entries past each row's pages."""
    q = torch.randn((B, 1, H, hd), generator=g, device=device).to(dtype)
    shape = (n_pages, ps, KV, hd)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device=device,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=device,
                           dtype=torch.int8)
        ks = torch.rand((n_pages, ps), generator=g, device=device) * 0.02
        vs = torch.rand((n_pages, ps), generator=g, device=device) * 0.02
    else:
        kp = torch.randn(shape, generator=g, device=device).to(dtype)
        vp = torch.randn(shape, generator=g, device=device).to(dtype)
        ks = torch.zeros((n_pages, ps), device=device)
        vs = torch.zeros((n_pages, ps), device=device)
    lengths = torch.randint(1, P * ps + 1, (B,), generator=g, device=device,
                            dtype=torch.int32)
    lengths[0], lengths[1] = 0, P * ps
    perm = torch.randperm(n_pages, generator=g, device=device)[:B * P]
    tables = perm.reshape(B, P).to(torch.int32)
    need = (lengths + ps - 1) // ps
    cols = torch.arange(P, device=device)[None, :]
    tables = torch.where(cols < need.clamp(min=1)[:, None], tables,
                         torch.full_like(tables, -1))
    return q, kp, vp, ks, vs, tables, lengths


def _close_per_row(out, want, tol):
    """Within ``tol`` of each row's (position and head's) largest
    |output|: rows that average many positions are small, and a
    whole-tensor bound would not see a bad merge there.  A row of zeros
    (a free slot) must be exactly zero."""
    top = want.float().abs().amax(dim=-1, keepdim=True)
    assert ((out.float() - want.float()).abs() <= tol * top).all()


def _check_paged(out, want, dtype):
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    _close_to_scale(out, want, tol, tol)
    _close_per_row(out, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pb", [1, 4])
def test_paged_decode_kernel_matches_plain_on_card(cuda, quant, dtype, pb):
    from repro_torch.kernels.paged_attention import paged_decode
    g = torch.Generator(device=cuda).manual_seed(int(quant) + pb)
    args = paged_case(g, cuda, dtype, quant)
    out = paged_decode(*args, pages_per_block=pb)
    want = ref.paged_decode_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert not out[0].any()                   # length 0: exact zeros
    _check_paged(out, want, dtype)


#: split cases (B, P, pages per split, lengths): many splits (64 of one
#: page, rows ending mid-page and mid-split); a long table whose rows
#: end early, so most splits lie past the length; one split a row; the
#: Yi-6B serve run's lengths (64-192) over 32 entries of 16
PAGED_SPLIT_CASES = {
    "many_splits": (4, 64, 1, (0, 1024, 517, 33)),
    "past_length": (4, 64, 4, (0, 70, 3, 129)),
    "one_split": (3, 8, 8, (0, 128, 77)),
    "yi6b": (8, 32, 4, (0, 64, 100, 128, 129, 150, 191, 192)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8_f32",
                                  "int8_bf16"])
@pytest.mark.parametrize("case", sorted(PAGED_SPLIT_CASES))
def test_paged_decode_splits_on_card(cuda, case, pool):
    """The split kernel against its plain version per row; every page
    slot it must not read (past each row's length, and the pages -1
    entries clamp to) holds NaN, so a read of one would show; one launch
    a call, and a second call (the ticket counters reset) equal."""
    from repro_torch.kernels.paged_attention import paged_decode
    B, P, pb, lengths = PAGED_SPLIT_CASES[case]
    dtype = torch.bfloat16 if pool.endswith("bf16") or pool == "bfloat16" \
        else torch.float32
    quant = pool.startswith("int8")
    g = torch.Generator(device=cuda).manual_seed(P + pb)
    q, kp, vp, ks, vs, _, _ = paged_case(g, cuda, dtype, quant, B=B, P=P,
                                         n_pages=2 * B * P)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    ps = kp.shape[1]
    need = (lengths + ps - 1) // ps
    cols = torch.arange(P, device=cuda)[None, :]
    perm = torch.randperm(2 * B * P, generator=g, device=cuda)[:B * P]
    tables = torch.where(cols < need.clamp(min=1)[:, None],
                         perm.reshape(B, P).to(torch.int32),
                         torch.full((B, P), -1, dtype=torch.int32,
                                    device=cuda))
    want = ref.paged_decode_ref(q, kp, vp, ks, vs, tables, lengths)
    # poison every slot no live position maps to
    live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for b, n in enumerate(lengths.tolist()):
        pos = torch.arange(n, device=cuda)
        live[tables[b, pos // ps].long(), pos % ps] = True
    if quant:                                 # int8 holds no NaN: the scales
        ks, vs = ks.clone(), vs.clone()
        ks[~live] = vs[~live] = float("nan")
    else:
        kp, vp = kp.clone(), vp.clone()
        kp[~live] = vp[~live] = float("nan")
    before = LAUNCHES["paged_decode"]
    out = paged_decode(q, kp, vp, ks, vs, tables, lengths,
                       pages_per_block=pb)
    assert LAUNCHES["paged_decode"] == before + 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    for b, n in enumerate(lengths.tolist()):
        if n == 0:
            assert not out[b].any()           # a free slot: exact zeros
    _check_paged(out, want, dtype)
    torch.testing.assert_close(
        paged_decode(q, kp, vp, ks, vs, tables, lengths, pages_per_block=pb),
        out, rtol=0, atol=0)


#: flash_decode card cases: (B, H, KV, hd, C, valid slots).  "random":
#: each row valid on a random prefix; "full"; "ragged" (lo, hi): prefixes
#: drawn in [lo, hi); "empty_row": row 0 has no valid slot (uniform
#: average); "empty_split": only the last 10 slots are valid, so every
#: earlier split of each row is all masked
DECODE_CASES = {
    "yi6b": (8, 32, 4, 128, 512, "random"),
    "gemma_window": (4, 4, 1, 256, 1024, "full"),
    "gemma_global": (4, 4, 1, 256, 2304, (1100, 2081)),
    "empty_row": (4, 4, 1, 256, 1024, "empty_row"),
    "empty_split": (4, 8, 2, 128, 2304, "empty_split"),
    "one_slot": (3, 8, 2, 64, 1, "full"),
    "one_split": (2, 8, 2, 64, 100, "random"),   # the block writes out
    "ragged_chunk": (2, 8, 2, 64, 1000, "random"),
    # the old wrapper refused this cache (its [G, C] score tile needed
    # 540 KB of shared memory)
    "long_cache": (1, 8, 1, 128, 16384, "random"),
    "six_heads_hd80": (2, 12, 2, 80, 300, "random"),
    "sixteen_heads": (2, 16, 1, 64, 700, "random"),
}


def decode_case(g, device, dtype, B, H, KV, hd, C, slots):
    q = torch.randn((B, 1, H, hd), generator=g, device=device).to(dtype)
    k = torch.randn((B, C, KV, hd), generator=g, device=device).to(dtype)
    v = torch.randn((B, C, KV, hd), generator=g, device=device).to(dtype)
    if slots == "random":
        lengths = torch.randint(1, C + 1, (B,), generator=g, device=device)
    elif slots == "full" or slots == "empty_row":
        lengths = torch.full((B,), C, device=device)
    elif slots == "empty_split":
        lengths = None
    else:
        lengths = torch.randint(*slots, (B,), generator=g, device=device)
    pos = torch.arange(C, device=device)[None, :].expand(B, C)
    valid = pos >= C - 10 if lengths is None else pos < lengths[:, None]
    if slots == "empty_row":
        valid = valid.clone()
        valid[0] = False
    return q, k, v, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_flash_decode_kernel_matches_plain_on_card(cuda, dtype, per_row,
                                                   case):
    from repro_torch.kernels.flash_attention import decode_max_splits, \
        decode_splits, flash_decode, sm_count
    B, H, KV, hd, C, slots = DECODE_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(int(per_row) + C)
    q, k, v, valid = decode_case(g, cuda, dtype, B, H, KV, hd, C, slots)
    if not per_row:
        valid = valid[0]
    if case == "empty_split":
        assert decode_splits(B, KV, C, sm_count(torch.cuda.current_device()),
                             decode_max_splits())[0] > 1
    before = LAUNCHES["flash_decode"]
    out = flash_decode(q, k, v, valid)
    assert LAUNCHES["flash_decode"] == before + 1
    want = ref.flash_decode_ref(q, k, v, valid)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    _close_to_scale(out, want, tol, tol)
    if dtype == torch.bfloat16:
        # and within one bf16 rounding of each head's own largest output:
        # rows that average many slots are small
        row_tol = tol * want.float().abs().amax(dim=-1, keepdim=True)
        assert ((out.float() - want.float()).abs() <= row_tol).all()
    if case == "empty_row":
        # no valid slot: the uniform average of V over all C slots
        mean = v[0].float().mean(dim=0).repeat_interleave(H // KV, dim=0)
        _close_to_scale(out[0, 0], mean, tol, tol)
    # a second call reuses the ticket counters, which the kernel reset
    torch.testing.assert_close(flash_decode(q, k, v, valid), out, rtol=0,
                               atol=0)


@pytest.mark.gpu
def test_flash_decode_max_splits_on_card(cuda):
    """The library's split cap is the one tests/test_torch_flash_decode.py
    pins ``decode_splits`` with."""
    from repro_torch.kernels.flash_attention import decode_max_splits
    assert decode_max_splits() == 128
