"""The cluster ``qsgd_quantize`` kernel's arithmetic and geometry, on the CPU.

Each QSGD bucket (a row of up to 512Ki floats) runs on the card as a
thread-block cluster: block r quantizes a contiguous chunk, and the norm
is summed in one order that no cluster size changes (``ref.tree_sq_ref``:
groups of four, then the adjacent-pair tree; the blocks sum whole units
of 2048 floats and read each other's through distributed shared memory).
Here ``ref.qsgd_cluster_ref``, a plain model of that (the norm as a
cluster of ``cs`` blocks sums it, then the plain version's level
expression), is held to the plain version ``ref.qsgd_bucketed_ref`` and
to ``repro``'s ``qsgd_quantize`` in interpret mode and its oracle (whose
level expression XLA rounds its own way: the level rule there); it is
one float at every cluster size (``tests/test_torch_autotune.py``).

Tolerance: the norm is a float sum in another order, so an element
whose uniform lies within rounding of its level's fraction may round
the other way: at most 16 elements differ, each by exactly one level
(norm / s, within rtol 1e-4), the rest within rtol 1e-6 -- the rule
``chip_smoke.py`` holds the kernel to.  Where every sum is exact (small
dyadic values) the outputs are equal bit for bit.  ``qsgd_geometry`` is
pinned at ResNet-50's bucket shapes with the blocks the H100 holds at
once, and covers every element once.  The ``gpu`` cases run the kernel against
the plain version at every cluster size, and against the model bit for
bit: one output whatever the geometry.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import qsgd as qs
from repro_torch.kernels import ref
from repro_torch.kernels.qsgd import (QSGD_CLUSTERS, QSGD_MIN_CHUNK,
                                      QsgdGeometry, qsgd_geometry,
                                      qsgd_quantize)
from repro_torch.kernels.topk_compress import _chunk


def assert_levels_close(out, want, x, s):
    """At most 16 elements off, each by one level (norm / s)."""
    out, want, x = (np.asarray(a, np.float32) for a in (out, want, x))
    far = ~np.isclose(out, want, rtol=1e-6, atol=0)
    level = np.sqrt((x.astype(np.float64) ** 2).sum(axis=1,
                                                   keepdims=True)) / s
    off = np.isclose(np.abs(out - want), np.broadcast_to(level, out.shape),
                     rtol=1e-4, atol=0)
    assert int(far.sum()) <= 16, int(far.sum())
    assert off[far].all()


def buckets(seed: int, rows: int, n: int, dyadic: bool = False):
    """Gaussian buckets (a zero one and a half-zero one among them), or
    small dyadic values whose squares and sums are exact in float32; and
    their uniforms."""
    rng = np.random.default_rng(seed)
    if dyadic:
        x = rng.integers(-8, 9, (rows, n)) / 8.0
    else:
        x = rng.standard_normal((rows, n))
    if rows > 1:
        x[1] = 0.0
    if rows > 2:
        x[2, n // 2:] = 0.0
    u = rng.random((rows, n))
    return x.astype(np.float32), u.astype(np.float32)


def geometries(n: int):
    """Every (cs, chunk) the kernel takes for rows of n."""
    for cs in qs.qsgd_clusters(n):
        yield cs, max(4, _chunk(n, cs))


@settings(max_examples=40, deadline=None)
@given(rows=st.integers(1, 5), n=st.integers(1, 3000),
       s=st.sampled_from([1, 3, 15, 255]), seed=st.integers(0, 2 ** 31 - 1),
       dyadic=st.booleans())
def test_cluster_model_matches_plain_version(rows, n, s, seed, dyadic):
    x, u = buckets(seed, rows, n, dyadic)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    want = ref.qsgd_bucketed_ref(xt, ut, s).numpy()
    for cs, chunk in geometries(n):
        got = ref.qsgd_cluster_ref(xt, ut, s, cs).numpy()
        if dyadic:
            np.testing.assert_array_equal(got, want)
        else:
            assert_levels_close(got, want, x, s)
        if rows > 1:
            assert (got[1] == 0).all()            # a zero bucket gives 0


@pytest.mark.parametrize("n", [128, 1024, 4096, 65536])
def test_cluster_model_exact_on_dyadic_values(n):
    """Every cluster size, where the sums are exact: bit for bit."""
    x, u = buckets(n, 4, n, dyadic=True)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    want = ref.qsgd_bucketed_ref(xt, ut, 15)
    for cs, _ in geometries(n):
        assert torch.equal(ref.qsgd_cluster_ref(xt, ut, 15, cs), want)


@pytest.fixture
def jx():
    """``repro``'s QSGD kernel and oracle (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import qsgd as jq
    from repro.kernels import ref as jref
    return types.SimpleNamespace(jnp=jnp, qsgd=jq, ref=jref)


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("rows,n,s", [(3, 1024, 15), (4, 4096, 15),
                                      (2, 640, 1), (2, 8192, 255)])
def test_cluster_model_matches_repro(jx, rows, n, s, dyadic):
    x, u = buckets(rows * n + s, rows, n, dyadic)
    jnp = jx.jnp
    wants = [np.asarray(jx.qsgd.qsgd_quantize(jnp.asarray(x), jnp.asarray(u),
                                              s, interpret=True)),
             np.asarray(jx.ref.qsgd_bucketed_ref(jnp.asarray(x),
                                                 jnp.asarray(u), s))]
    for cs, _ in geometries(n):
        got = ref.qsgd_cluster_ref(torch.from_numpy(x), torch.from_numpy(u),
                                   s, cs).numpy()
        # XLA rounds the level expression its own way (the plain versions
        # agree within rtol 1e-6, tests/test_torch_kernels.py): the level
        # rule, on dyadic values too
        for want in wants:
            assert_levels_close(got, want, x, s)


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------


#: blocks of the kernel one NVIDIA H100 80GB HBM3 holds at once: two of
#: 512 threads an SM on 132 SMs (``qs_qsgd_resident_blocks``; PERF.md §6)
H100_SLOTS = 264

#: ResNet-50's QSGD buckets at R = 8 (every worker's rows of a bucket in
#: one launch: 2 leaves of 512Ki, 7 of 64Ki) and one worker's: the
#: cluster sizes that measured fastest on the card
MAIN_SHAPES = {(16, 524288): (16, 32768), (56, 65536): (4, 16384),
               (1, 524288): (16, 32768), (7, 65536): (16, 4096)}


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_qsgd_geometry_at_the_main_shapes(shape):
    assert tuple(qsgd_geometry(*shape, H100_SLOTS)) == MAIN_SHAPES[shape]


def test_qsgd_geometry_one_wave_of_the_most_blocks():
    """The cluster doubles while the rows' blocks fit the card at once,
    up to 16, and while a block keeps QSGD_MIN_CHUNK floats; a row of one
    block takes no cluster."""
    assert qsgd_geometry(56, 65536, 447) == QsgdGeometry(4, 16384)
    assert qsgd_geometry(56, 65536, 448) == QsgdGeometry(8, 8192)
    assert qsgd_geometry(300, 65536, 264) == QsgdGeometry(1, 65536)
    assert qsgd_geometry(1, 4 * QSGD_MIN_CHUNK, 264) == QsgdGeometry(
        4, QSGD_MIN_CHUNK)
    assert qsgd_geometry(1, 4 * QSGD_MIN_CHUNK - 16, 264).cs == 2
    assert qsgd_geometry(1, 1 << 24, 264) == QsgdGeometry(16, 1 << 20)
    assert qsgd_geometry(3, 100, 264) == QsgdGeometry(1, 100)
    assert qsgd_geometry(3, 0, 264) == QsgdGeometry(1, 4)


@pytest.mark.parametrize("n", [1, 3, 4, 127, 128, 2048, 2049, 32768, 32769,
                               65536, 131072, 524288])
@pytest.mark.parametrize("rows", [1, 16, 56])
def test_qsgd_geometry_covers_every_element_once(n, rows):
    cs, chunk = qsgd_geometry(rows, n, H100_SLOTS)
    assert cs in QSGD_CLUSTERS and chunk % 4 == 0 and chunk >= 4
    assert rows * cs <= H100_SLOTS or cs == 1
    assert cs == 1 or chunk >= QSGD_MIN_CHUNK
    owner = np.full(n, -1)
    for r in range(cs):
        lo, hi = min(n, r * chunk), min(n, (r + 1) * chunk)
        assert hi > lo or n == 0                      # no block empty
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = r
    assert (owner >= 0).all()


def test_wrapper_counts_launches_and_checks_inputs():
    from repro_torch.kernels.launch_stats import LAUNCHES
    x, u = (torch.from_numpy(a) for a in buckets(0, 3, 256))
    before = LAUNCHES["qsgd"]
    out = qsgd_quantize(x, u, 15)
    assert LAUNCHES["qsgd"] == before + 1
    assert torch.equal(out, ref.qsgd_bucketed_ref(x, u, 15))
    with pytest.raises(ValueError):
        qsgd_quantize(x, u[:, :128], 15)
    with pytest.raises(ValueError):
        qsgd_quantize(x, u, 0)
    assert LAUNCHES["qsgd"] == before + 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 130, 4096, 65536, 524288, 65537])
def test_qsgd_kernel_every_cluster_size_on_card(cuda, n):
    """Each cluster size the kernel takes at a row length (n = 65537: not
    a multiple of 4, scalar accesses), against the plain version under
    the level rule, bit for bit on dyadic values, and bit for bit against
    the model (the same output at every cluster size)."""
    rows = 5
    for dyadic in (False, True):
        x, u = (torch.from_numpy(a).to(cuda)
                for a in buckets(n, rows, n, dyadic))
        want = ref.qsgd_bucketed_ref(x, u, 15)
        model = ref.qsgd_cluster_ref(x, u, 15, 1)
        for cs, chunk in geometries(n):
            got = qs._launch(x, u, 15, QsgdGeometry(cs, chunk))
            torch.cuda.synchronize()
            assert torch.equal(got, model), (cs, chunk)
            if dyadic:
                assert torch.equal(got, want), (cs, chunk)
            else:
                assert_levels_close(got.cpu(), want.cpu(), x.cpu(), 15)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_qsgd_kernel_main_shapes_on_card(cuda, shape):
    """The wrapper's own geometry at ResNet-50's shapes, and the rows at
    an offset of one float (scalar accesses)."""
    rows, n = shape
    x, u = (torch.from_numpy(a).to(cuda) for a in buckets(rows, rows, n))
    assert_levels_close(qsgd_quantize(x, u, 15).cpu(),
                        ref.qsgd_bucketed_ref(x, u, 15).cpu(), x.cpu(), 15)
    flat = torch.empty(2, rows * n + 1, device=cuda)
    flat[0, 1:], flat[1, 1:] = x.flatten(), u.flatten()
    xs, us = flat[0, 1:].view(rows, n), flat[1, 1:].view(rows, n)
    assert_levels_close(qsgd_quantize(xs, us, 15).cpu(),
                        ref.qsgd_bucketed_ref(xs, us, 15).cpu(), x.cpu(), 15)
