"""The split ``flash_decode``'s schedule and arithmetic, on the CPU.

The CUDA kernel splits each (row, kv head)'s cache slots into chunks
and merges per-chunk partials (m, l, o) with the log-sum-exp rescaling.
Here the wrapper's split choice (``decode_splits``) is pinned, and
``ref.flash_decode_split_ref``, a plain PyTorch model of the kernel's
split-and-combine arithmetic with the finite -1e30 mask, is held against
the plain version ``ref.flash_decode_ref`` (float32 einsums in another
order: within 1e-5 of the largest output) and against ``repro``'s
``flash_decode_fwd`` in interpret mode on the same numpy inputs (within
1e-5; bfloat16 within 2e-2, one rounding of the output), including a
row with no valid slot and splits with none.  The kernel itself runs
only on the card (``tests/test_torch_kernels.py``, ``gpu`` marker).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    DECODE_MIN_CHUNK,
    decode_heads_per_block,
    decode_splits as _decode_splits,
)

#: SMs of an H100 SXM and the kernel's most splits
#: (``qs_flash_decode_max_splits``, pinned on the card by
#: tests/test_torch_kernels.py::test_flash_decode_max_splits_on_card)
SMS = 132
DECODE_MAX_SPLITS = 128


def decode_splits(B, KV, C):
    return _decode_splits(B, KV, C, SMS, DECODE_MAX_SPLITS)


@pytest.mark.parametrize("B", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("KV", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [1, 2, 63, 64, 65, 127, 512, 1000, 1024,
                               2304, 16384, 100_000])
def test_splits_cover_every_slot_once(B, KV, C):
    splits, chunk = decode_splits(B, KV, C)
    assert 1 <= splits <= DECODE_MAX_SPLITS and chunk >= 1
    # chunks [s * chunk, (s + 1) * chunk) clipped to C: a partition of
    # the slots, every chunk non-empty
    owner = np.full(C, -1)
    for s in range(splits):
        lo, hi = s * chunk, min(C, (s + 1) * chunk)
        assert lo < hi
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    if splits > 1:
        assert chunk >= DECODE_MIN_CHUNK
    # no more blocks than about two waves, unless one split already has
    # more (row, kv head) pairs than that
    assert B * KV * (splits - 1) < 2 * SMS or splits == 1


def test_splits_at_the_serving_shapes():
    assert decode_splits(4, 1, 1024) == (16, 64)     # gemma3-1b window
    assert decode_splits(4, 1, 2304) == (36, 64)     # gemma3-1b global
    assert decode_splits(8, 4, 512) == (8, 64)       # Yi-6B contiguous
    assert decode_splits(1, 1, 16384) == (128, 128)  # capped
    assert decode_splits(3, 2, 1) == (1, 1)
    assert decode_splits(64, 8, 4096) == (1, 4096)   # the grid is full


@pytest.mark.parametrize("G,want", [(1, 1), (2, 2), (3, 4), (4, 4),
                                    (5, 8), (7, 8), (8, 8), (16, 8)])
def test_heads_per_block(G, want):
    assert decode_heads_per_block(G) == want


#: (B, H, KV, hd, C, valid): "random" prefixes, "empty_row" (row 0 has
#: no valid slot; for the shared mask, every row), "empty_split" (only
#: the last 10 slots valid), "scattered" (random slots)
SPLIT_CASES = [
    (3, 8, 2, 32, 200, "random"),
    (2, 4, 1, 64, 300, "empty_row"),
    (2, 8, 2, 32, 500, "empty_split"),
    (3, 6, 3, 16, 1, "random"),
    (2, 8, 4, 32, 1000, "scattered"),
]


def split_inputs(B, H, KV, hd, C, kind, seed=0):
    rng = np.random.default_rng(seed + C + H)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    pos = np.arange(C)[None, :].repeat(B, 0)
    if kind == "empty_split":
        valid = pos >= C - 10
    elif kind == "scattered":
        valid = rng.random((B, C)) < 0.3
    else:
        valid = pos < rng.integers(1, C + 1, (B, 1))
    if kind == "empty_row":
        valid[0] = False
    return q, k, v, valid


@pytest.mark.parametrize("B,H,KV,hd,C,kind", SPLIT_CASES)
@pytest.mark.parametrize("shape_of_splits", ["wrapper", "many"])
def test_split_model_matches_plain_version(B, H, KV, hd, C, kind,
                                           shape_of_splits):
    q, k, v, valid = (torch.from_numpy(a) for a in
                      split_inputs(B, H, KV, hd, C, kind))
    splits, chunk = decode_splits(B, KV, C) if shape_of_splits == "wrapper" \
        else (-(-C // 7), 7)
    if kind == "empty_split" and shape_of_splits == "many":
        assert splits > 1
    got = ref.flash_decode_split_ref(q, k, v, valid, splits, chunk)
    want = ref.flash_decode_ref(q, k, v, valid)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    if kind == "empty_row":
        # no valid slot: the uniform average of V over every slot
        mean = v[0].mean(dim=0).repeat_interleave(H // KV, dim=0)
        torch.testing.assert_close(got[0, 0], mean, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,C,kind", SPLIT_CASES)
def test_split_model_matches_repro_kernel(B, H, KV, hd, C, kind, dtype):
    """``repro`` takes one [C] mask for the batch: row 1's mask (row 0's
    for the empty-row case) is shared by every row."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_decode_fwd
    q, k, v, valid = split_inputs(B, H, KV, hd, C, kind, seed=1)
    shared = valid[0] if kind == "empty_row" else valid[min(1, B - 1)]
    jdt = getattr(jnp, dtype)
    want = flash_decode_fwd(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                            jnp.asarray(shared), interpret=True)
    tdt = getattr(torch, dtype)
    splits, chunk = -(-C // 7), 7
    got = ref.flash_decode_split_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(shared), splits, chunk)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))
