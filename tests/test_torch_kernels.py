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


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", [
    (64, 4096, 41), (4, 65536, 655),
    # around the longest row staged in shared memory (12288 floats, more
    # than the default 48 KB per block with the kernel's scratch)
    (4, 12160, 121), (4, 12288, 123), (4, 12416, 124)])
@pytest.mark.parametrize("sign", [False, True])
def test_topk_kernel_matches_plain_on_card(cuda, rows, n, k, sign):
    x = torch.from_numpy(topk_input(7, rows, n)).to(cuda)
    sel, mem, cnt = topk_compress(x, k, sign=sign)
    sel_r, mem_r, cnt_r = ref.topk_compress_ref(x, k, sign=sign)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt_r)
    assert torch.equal(sel != 0, sel_r != 0)
    if sign:
        torch.testing.assert_close(sel, sel_r, rtol=1e-6, atol=0)
    else:
        assert torch.equal(sel, sel_r) and torch.equal(mem, mem_r)


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
    (1, 4096, 4096, 41)])
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
@pytest.mark.parametrize("M", [1, 8, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdq_gemm_kernel_matches_plain_on_card(exact_f32, M, dtype):
    from repro_torch.kernels.sparse_gemm import qdq_gemm
    g = torch.Generator(device=exact_f32).manual_seed(M)
    R, n = 64000, 4096
    lv = torch.randint(-15, 16, (R, n), generator=g, device=exact_f32,
                       dtype=torch.int8)
    scale = torch.rand((R, 1), generator=g, device=exact_f32)
    x = torch.randn((M, n), generator=g, device=exact_f32).to(dtype)
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
    _close_to_scale(out, want, 2 ** -7 if dtype == torch.bfloat16 else 1e-5,
                    2 ** -7 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_row", [False, True])
def test_flash_decode_kernel_matches_plain_on_card(cuda, dtype, per_row):
    from repro_torch.kernels.flash_attention import flash_decode
    g = torch.Generator(device=cuda).manual_seed(int(per_row))
    B, H, KV, hd, C = 8, 32, 4, 128, 512
    q = torch.randn((B, 1, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, C, KV, hd), generator=g, device=cuda).to(dtype)
    lengths = torch.randint(1, C + 1, (B, 1), generator=g, device=cuda)
    valid = torch.arange(C, device=cuda)[None, :] < lengths
    if not per_row:
        valid = valid[0]
    out = flash_decode(q, k, v, valid)
    want = ref.flash_decode_ref(q, k, v, valid)
    torch.cuda.synchronize()
    _close_to_scale(out, want, 2 ** -7 if dtype == torch.bfloat16 else 1e-5,
                    2 ** -7 if dtype == torch.bfloat16 else 1e-5)
