"""The split ``paged_decode``'s schedule and arithmetic, on the CPU.

The CUDA kernel splits each row's block table into runs of
``pages_per_block`` logical pages, lets only the splits holding a live
position work, and merges their partials (m, l, o) with the log-sum-exp
rescaling, dead positions masked on p itself.  Here ``paged_splits`` is
pinned (every page in exactly one split), and
``ref.paged_decode_split_ref``, a plain PyTorch model of that
split-and-merge arithmetic, is held against the plain version
``ref.paged_decode_ref`` (float32 einsums in another order: within 1e-5
of the largest output) and against ``repro``'s ``paged_decode_fwd`` in
interpret mode on the same numpy inputs (float32 and int8 pools within
1e-5, bfloat16 within 2e-2, one rounding of the output): a length-0 row
(exact zeros), a full row, rows ending mid-page and mid-split, -1 table
entries past each row's pages.  The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, ``gpu`` marker).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_splits


@pytest.mark.parametrize("pb", [1, 2, 3, 4, 7, 32, 64])
@pytest.mark.parametrize("P", [1, 3, 4, 5, 32, 33])
def test_splits_cover_every_page_once(P, pb):
    pb = max(1, min(pb, P))                 # the wrapper's clamp
    splits = paged_splits(P, pb)
    owner = np.full(P, -1)
    for s in range(splits):
        lo, hi = s * pb, min(P, (s + 1) * pb)
        assert lo < hi                      # no split without a page
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()


def test_splits_at_the_serving_shape():
    assert paged_splits(32, 4) == 8         # Yi-6B: 512 positions of 16
    assert paged_splits(3, 4) == 1


#: (lengths, page size, table width P, pages per split): a free slot, a
#: full row, rows ending mid-page, at a page edge, mid-split and at a
#: split edge
SPLIT_CASES = [
    ((0, 32, 7, 13), 4, 8, 2),
    ((0, 5, 16, 17, 31), 4, 8, 2),
    ((3, 64, 40, 1), 8, 8, 1),
    ((0, 100, 128, 77), 16, 8, 4),
    ((12, 0), 4, 3, 4),                     # one split per row
]


def split_inputs(lengths, ps, P, quant, B_heads=(8, 2, 32), seed=0):
    """q, a page pool twice the rows' need, block tables of distinct
    pages with -1 past each row's pages."""
    H, KV, hd = B_heads
    B = len(lengths)
    rng = np.random.default_rng(seed + ps * P + quant)
    n_pages = 2 * B * P
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    shape = (n_pages, ps, KV, hd)
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random((n_pages, ps)) * 0.05).astype(np.float32)
        vs = (rng.random((n_pages, ps)) * 0.05).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = np.zeros((n_pages, ps), np.float32)
    perm = rng.permutation(n_pages)[:B * P].reshape(B, P)
    tables = np.full((B, P), -1, np.int32)
    for b, n in enumerate(lengths):
        need = max(1, -(-n // ps))
        tables[b, :need] = perm[b, :need]
    return q, kp, vp, ks, vs, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths,ps,P,pb", SPLIT_CASES)
def test_split_model_matches_plain_version(lengths, ps, P, pb, quant):
    args = [torch.from_numpy(a) for a in split_inputs(lengths, ps, P, quant)]
    got = ref.paged_decode_split_ref(*args, pages_per_block=pb)
    want = ref.paged_decode_ref(*args)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()         # a free slot: exact zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("lengths,ps,P,pb", SPLIT_CASES[:4])
def test_split_model_matches_repro_kernel(lengths, ps, P, pb, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.paged_attention import paged_decode_fwd
    quant = dtype == "int8"
    q, kp, vp, ks, vs, tables, lens = split_inputs(lengths, ps, P, quant,
                                                   seed=1)
    fdt = "bfloat16" if dtype == "bfloat16" else "float32"
    jq = jnp.asarray(q).astype(getattr(jnp, fdt))
    jk, jv = (jnp.asarray(a) if quant else
              jnp.asarray(a).astype(getattr(jnp, fdt)) for a in (kp, vp))
    want = paged_decode_fwd(jq, jk, jv, *(jnp.asarray(a) for a in
                                          (ks, vs, tables, lens)),
                            pages_per_block=pb, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, fdt))
    tk, tv = (torch.from_numpy(a) if quant else
              torch.from_numpy(a).to(getattr(torch, fdt)) for a in (kp, vp))
    got = ref.paged_decode_split_ref(
        tq, tk, tv, *(torch.from_numpy(a) for a in (ks, vs, tables, lens)),
        pages_per_block=pb).float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()
