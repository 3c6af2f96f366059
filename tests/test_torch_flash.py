"""The prefill flash-attention kernel's function against ``repro``.

The same numpy inputs go through ``repro``'s Pallas kernel (interpret
mode, 32-row query and key blocks, as ``tests/test_kernels.py`` runs it)
and through the port's wrapper, which on the CPU runs the kernel's plain
version; and through both packages' plain versions.  bfloat16 inputs are
rounded from the same float32 values by each framework (round to nearest
even in both).  Tolerances: the wrapper within 2e-4 (float32) / 2e-2
(bfloat16, one rounding of the output) of ``repro``'s kernel, which sums
in another order; the plain versions within 1e-5 of each other (float32
einsums in another order).  The CUDA kernels run only on the card
(``gpu`` marker): there bfloat16 inputs go through the tensor-core kernel,
held to the plain version within 2^-7 of the largest output of each
row (the rounding of the probabilities to bf16 for P V, and of the
output), and float32 inputs through the FMA kernel, within 2e-5.
The card has no JAX, so ``repro`` is imported by the parity tests
themselves and ``pytest -m gpu tests/test_torch_flash.py`` runs there.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, dispatch as dsp, ref
from repro_torch.kernels.flash_attention import (
    FLASH_HEAD_DIMS,
    attention_schedule,
    flash_attention_fwd,
    flash_attention_smem,
)
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.flash_attention import MAX_SMEM

#: the tensor-core kernel's geometry as its library reports it (pinned on
#: the card by test_kernel_geometry_on_card): head width -> (tile rows,
#: tile keys, shared-memory bytes, scratch floats of a split tile)
TC_GEOMETRY = {D: (128 if D <= 128 else 64, 64,
                   ((128 if D <= 128 else 64) + 4 * 64) * (D + 8) * 2,
                   2 * (2 if D <= 128 else 1) * (D // 2 + 4) * 128)
               for D in FLASH_HEAD_DIMS}

#: repro's flash-attention test shapes (tests/test_kernels.py)
SHAPES = [
    (2, 64, 4, 2, 32, -1),
    (1, 100, 4, 4, 16, -1),      # ragged S against the 32-row blocks
    (2, 128, 8, 2, 64, 24),      # sliding window
    (1, 256, 2, 1, 128, 64),     # MQA, bigger head width
    (1, 70, 4, 4, 112, -1),      # zamba2-7b's head width (MHA)
]
DTYPES = {"float32": (torch.float32, 2e-4),
          "bfloat16": (torch.bfloat16, 2e-2)}


def inputs(B, S, H, KV, D, seed=0):
    rng = np.random.default_rng(seed + S + H)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D,w", SHAPES)
def test_wrapper_matches_repro_kernel(B, S, H, KV, D, w, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    tdt, tol = DTYPES[dtype]
    jdt = getattr(jnp, dtype)
    q, k, v = inputs(B, S, H, KV, D)
    want = jops.flash_attention(*(jnp.asarray(a).astype(jdt)
                                  for a in (q, k, v)),
                                window=w, q_block=32, kv_block=32,
                                interpret=True)
    got = flash_attention_fwd(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), window=w)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,KV,D,w", SHAPES)
def test_plain_version_matches_repro_oracle(B, S, H, KV, D, w):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, k, v = inputs(B, S, H, KV, D, seed=1)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=w)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_window_wider_than_sequence_is_causal():
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 40, 2, 1, 32))
    torch.testing.assert_close(flash_attention_fwd(q, k, v, window=64),
                               flash_attention_fwd(q, k, v, window=-1),
                               rtol=0, atol=0)


def test_wrapper_counts_one_launch_per_call():
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 48, 4, 1, 32))
    before = LAUNCHES["flash_attention"]
    flash_attention_fwd(q, k, v)
    flash_attention_fwd(q, k, v, window=16)
    assert LAUNCHES["flash_attention"] == before + 2
    # the dispatch entry: the wrapper under "kernel", the plain version
    # (no launch) under "reference", the same values either way
    a = dsp.flash_attention(q, k, v, 16, dsp.DispatchConfig(mode="kernel"))
    b = dsp.flash_attention(q, k, v, 16,
                            dsp.DispatchConfig(mode="reference"))
    assert LAUNCHES["flash_attention"] == before + 3
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_has_no_backward():
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 32, 4, 2, 16))
    q.requires_grad_(True)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        dsp.flash_attention(q, k, v, -1, dsp.DispatchConfig(mode="kernel"))
    assert LAUNCHES["flash_attention"] == before
    with torch.no_grad():
        out = flash_attention_fwd(q, k, v)
    assert not out.requires_grad


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 32, 4, 2, 16))
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_fwd(q[:, :, :3].contiguous(), k, v)   # H % KV
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_fwd(q, k[:, :16].contiguous(),
                            v[:, :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention_fwd(q[..., :8].contiguous(), k[..., :8].contiguous(),
                            v[..., :8].contiguous())


def test_kernel_is_declared_and_built_lazily():
    assert "qs_flash_attention" in _build.SIGNATURES
    assert any(s.endswith("flash_attention.cu") for s in _build.sources())
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 32, 4, 2, 16))
    flash_attention_fwd(q, k, v)
    assert _build._LIB is None
    # every instantiated head width fits one block's shared memory
    assert max(flash_attention_smem(d) for d in FLASH_HEAD_DIMS) \
        <= 232_448


@pytest.mark.parametrize("arch,scan,apps", [
    ("zamba2-7b", True, 2),              # the shared block: static window
    ("qwen3-moe-30b-a3b", True, 0),      # scanned periods: traced windows
    ("llama4-maverick-400b-a17b", True, 0),
    ("gemma3-1b", True, 0),              # the dense stacked stack
    ("gemma3-1b", False, 2),             # unscanned: a launch a layer
])
def test_prefill_kernel_follows_static_windows(arch, scan, apps):
    """As in ``repro``, a prefill under ``use_pallas`` runs the kernel
    where the caller's window is static (Zamba2's shared block, an
    unscanned dense stack) and chunked attention where ``repro`` traces
    it (MoE periods, a stacked dense stack)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_config(arch, smoke=True), use_pallas=True,
                              scan_layers=scan)
    m = get_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    before = LAUNCHES["flash_attention"]
    m.prefill(params, {"tokens": toks}, cfg,
              dsp.DispatchConfig(mode="kernel"), max_len=16)
    assert LAUNCHES["flash_attention"] - before == apps


def schedule(S, H, KV, w, D):
    rows, keys = TC_GEOMETRY[D][:2]
    return attention_schedule(S, H, KV, w, rows, keys)


@pytest.mark.parametrize("S,H,KV,D,w,want", [
    (2048, 4, 1, 256, -1, 64),     # gemma3-1b global: 128 tiles
    (2048, 4, 1, 256, 1024, 0),    # windowed: keys bounded
    (1100, 4, 1, 256, 1024, 0),
    (2048, 32, 4, 128, -1, 64),    # Yi-6B's heads: 128 tiles a kv head
    (1, 4, 1, 256, -1, 0),
    (150, 8, 2, 256, -1, 2),
    (150, 8, 2, 64, -1, 1),        # 128-row tiles
])
def test_attention_schedule_at_the_prefill_shapes(S, H, KV, D, w, want):
    assert schedule(S, H, KV, w, D) == want


@pytest.mark.parametrize("S", [1, 17, 64, 150, 700, 2048, 5000])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("KV", [1, 4])
@pytest.mark.parametrize("D", [64, 256])
def test_attention_schedule_evens_out_causal_tiles(S, G, KV, D):
    """The split tiles are the longest ones, and no block walks more key
    tiles than half the longest tile (rounded up) plus one."""
    n_split = schedule(S, G * KV, KV, -1, D)
    rows = TC_GEOMETRY[D][0]
    tiles = -(-S * G // rows)
    n_kt = [min(S - 1, (t * rows + rows - 1) // G) // 64 + 1
            for t in range(tiles)]
    assert n_kt == sorted(n_kt)          # so the split ones are the last
    assert 0 <= n_split <= tiles
    split, whole = n_kt[tiles - n_split:], n_kt[:tiles - n_split]
    longest = max(n_kt)
    assert all(n >= 2 for n in split)
    blocks = [n - n // 2 for n in split] + whole
    assert max(blocks) <= -(-longest // 2) + 1


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def close_per_row(out, want, scale):
    """Every output within ``scale`` times the largest |want| of its own
    row (one position and head), so that rows which average many keys
    (small outputs) are held to their own size, not to the early rows'."""
    o, w = out.float(), want.float()
    atol = scale * w.abs().amax(dim=-1, keepdim=True)
    excess = ((o - w).abs() - atol).max()
    assert excess <= 0, f"{float(excess)} past {scale} of a row's largest"


def _on_card(cuda, B, S, H, KV, D, w, tdt):
    q, k, v = (torch.from_numpy(a).to(cuda, tdt)
               for a in inputs(B, S, H, KV, D, seed=2))
    out = flash_attention_fwd(q, k, v, window=w)
    want = ref.flash_attention_ref(q, k, v, window=w)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    if tdt == torch.bfloat16:
        close_per_row(out, want, 2 ** -7)
    else:
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-5,
                                   atol=2e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D,w", SHAPES + [
    (1, 300, 4, 1, 256, 100),    # gemma3's head width, partial windows
    (1, 200, 8, 8, 80, -1),      # stablelm's head width
    (2, 130, 4, 2, 64, 1),       # a window of one key
    # bfloat16 runs the tensor-core kernel: every head width, 4 heads of
    # a kv group packed into one tile
    *[(1, 150, 8, 2, d, -1) for d in FLASH_HEAD_DIMS],
    (1, 1, 4, 1, 256, -1),       # one position
    (1, 1100, 4, 1, 256, 1024),  # gemma3-1b's ragged prompt, windowed
    (1, 300, 4, 1, 256, 1),      # a window of one key at D = 256
    (1, 300, 4, 1, 256, 37),     # partial windows inside a key tile
    (1, 200, 14, 2, 64, 50),     # 7 heads a group: tiles cut positions
    (1, 700, 4, 1, 256, -1),     # the longest causal tiles split in two
    (2, 300, 4, 1, 256, -1),     # split tiles of two batch rows
    (2, 300, 8, 2, 64, -1),      # 〃, 128-row tiles, two kv heads
    (2, 600, 32, 4, 128, -1)])   # Yi-6B's heads, split tiles
def test_kernel_matches_plain_on_card(cuda, B, S, H, KV, D, w, dtype):
    _on_card(cuda, B, S, H, KV, D, w, DTYPES[dtype][0])


@pytest.mark.gpu
def test_kernel_geometry_on_card(cuda):
    """The library's tensor-core geometry is the one the schedule tests
    above are pinned with, and every head width fits a block's shared
    memory."""
    from repro_torch.kernels.flash_attention import tc_geometry
    for D in FLASH_HEAD_DIMS:
        assert tuple(tc_geometry(D)) == TC_GEOMETRY[D]
        assert TC_GEOMETRY[D][2] <= MAX_SMEM
