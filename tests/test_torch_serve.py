"""The serving slice against ``repro``: compression at load, the serving
GEMMs, the yi-6b smoke model's prefill / decode logits and whole
``ServeEngine`` runs on the contiguous KV layout.

Both packages get the same numpy weights (``convert.params_from_jax``),
tie-free so that the two libraries' Top_k pick the same survivors.  The
port runs with dispatch "kernel": on the CPU every kernel wrapper runs
its plain version and counts its launch.  Tolerances: indices and int8
levels exact; values and scales within 1e-6 (a float sum in another
order feeds the QSGD norm); logits within 1e-4 (float32 products summed
in another order through two layers); greedy tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import dispatch as jdsp
from repro.kernels import ref as jref
from repro.kernels import sparse_gemm as jsg
from repro.models import transformer as jtf
from repro.serve import compressed as jsc
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import POLICY_PRESETS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
from repro_torch.kernels.sparse_gemm import qdq_gemm, sparse_gemm
from repro_torch.models import get_model, transformer as tf
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import tree_leaves

KERNEL = dsp.DispatchConfig(mode="kernel")
POLICY = POLICY_PRESETS["lm_hetero"]  # yi-6b's preset, as a DSL string


def tie_free_params(cfg_j, seed: int):
    """repro's parameter structure for ``cfg_j`` with numpy values whose
    magnitudes are distinct within every leaf (scaled like repro's init:
    fan_in ** -0.5, embeddings O(1)); norm gains small and distinct."""
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    cfg_j))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = jax.tree_util.keystr(path)
        d = int(np.prod(sd.shape))
        mags = np.linspace(0.05, 1.0, d)
        signs = np.where(rng.random(d) < 0.5, -1.0, 1.0)
        x = (mags * signs)[rng.permutation(d)].reshape(sd.shape)
        if "norm" in name or "ln" in name:
            x = 0.1 * x
        elif "embed" not in name:
            x = x * 2.0 * sd.shape[-2] ** -0.5
        return x.astype(sd.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def smoke():
    cfg_j = j_get_config("yi-6b", smoke=True)
    cfg_t = get_config("yi-6b", smoke=True)
    tree = tie_free_params(cfg_j, 0)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params_t = params_from_jax(tree, device="cpu")
    comp_j = jsc.compress_tree(params_j, POLICY)
    comp_t = sc.compress_tree(params_t, POLICY)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, comp_j=comp_j, comp_t=comp_t)


def _compressed_leaves(tree_j, tree_t):
    lj = jax.tree_util.tree_leaves(
        tree_j, is_leaf=lambda x: isinstance(x, jsc.CompressedTensor))
    lt = tree_leaves(tree_t)
    assert len(lj) == len(lt)
    return list(zip(lj, lt))


# ---------------------------------------------------------------------------
# compression at load
# ---------------------------------------------------------------------------


def test_compress_tree_matches_repro(smoke):
    pairs = _compressed_leaves(smoke["comp_j"], smoke["comp_t"])
    kinds = []
    for cj, ct in pairs:
        if not isinstance(cj, jsc.CompressedTensor):
            assert not isinstance(ct, sc.CompressedTensor)
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            continue
        kinds.append(ct.kind)
        assert (ct.kind, ct.row_len, ct.shape, ct.out_axis, ct.dtype,
                ct.op) == (cj.kind, cj.row_len, cj.shape, cj.out_axis,
                           cj.dtype, cj.op)
        assert ct.a.dtype == {"sparse": torch.int32,
                              "quant": torch.int8}[ct.kind]
        np.testing.assert_array_equal(ct.a.numpy(), np.asarray(cj.a))
        np.testing.assert_allclose(ct.b.numpy(), np.asarray(cj.b),
                                   rtol=1e-6, atol=0)
    # lm_hetero on yi: 7 Top_k matmul stacks, QSGD embed and head
    assert sorted(kinds) == ["quant"] * 2 + ["sparse"] * 7
    assert sc.tree_bytes(smoke["comp_t"]) == jsc.tree_bytes(smoke["comp_j"])


def test_compressed_rows_are_ascending_with_trailing_sentinels(smoke):
    for ct in tree_leaves(smoke["comp_t"]):
        if not (isinstance(ct, sc.CompressedTensor) and ct.kind == "sparse"):
            continue
        idx = ct.a.reshape(-1, ct.a.shape[-1])
        live = idx < ct.row_len
        k = int(live[0].sum())
        assert bool(live[:, :k].all()) and not bool(live[:, k:].any())
        assert bool((idx[:, 1:k] > idx[:, :k - 1]).all())
        assert ct.a.shape[-1] == dsp.capacity(k, ct.row_len)


def test_densify_and_take_rows_match_repro(smoke):
    sc.reset_stats()
    for cj, ct in _compressed_leaves(smoke["comp_j"], smoke["comp_t"]):
        if not isinstance(ct, sc.CompressedTensor):
            continue
        np.testing.assert_allclose(ct.densify().numpy(),
                                   np.asarray(cj.densify()), rtol=1e-6,
                                   atol=1e-7)
        if ct.out_axis == 0:
            tok = np.array([[3, 0, 511], [7, 7, 1]])
            np.testing.assert_allclose(
                ct.take_rows(torch.from_numpy(tok)).numpy(),
                np.asarray(cj.take_rows(jnp.asarray(tok))), rtol=1e-6,
                atol=1e-7)
    assert sc.STATS["densify"] == 9 and sc.STATS["take_rows"] == 1


def test_capacity_and_decode_rows_match_repro():
    for k, n in [(1, 1), (41, 4096), (110, 11008), (200, 130), (3, 256)]:
        assert dsp.capacity(k, n) == jdsp.capacity(k, n)
    rng = np.random.RandomState(0)
    idx, val = _compact_rows(rng, 9, 300, 12)
    np.testing.assert_array_equal(
        dsp.decode_rows(torch.from_numpy(idx), torch.from_numpy(val),
                        300).numpy(),
        np.asarray(jdsp.decode_rows(jnp.asarray(idx), jnp.asarray(val),
                                    300)))


# ---------------------------------------------------------------------------
# the serving GEMMs' plain versions
# ---------------------------------------------------------------------------


def _compact_rows(rng, R, n, kcap):
    """Ascending survivors, a random count per row (one row empty), the
    sentinel (n, 0) after them."""
    idx = np.full((R, kcap), n, np.int32)
    val = np.zeros((R, kcap), np.float32)
    for r in range(1, R):
        kk = rng.randint(1, kcap + 1)
        idx[r, :kk] = np.sort(rng.choice(n, kk, replace=False))
        val[r, :kk] = rng.randn(kk)
    return idx, val


@pytest.mark.parametrize("M,R,n,kcap", [(4, 40, 256, 16), (1, 8, 128, 8),
                                        (9, 33, 300, 12)])
def test_sparse_gemm_plain_matches_repro(M, R, n, kcap):
    rng = np.random.RandomState(M * R + n)
    x = rng.randn(M, n).astype(np.float32)
    idx, val = _compact_rows(rng, R, n, kcap)
    before = LAUNCHES["sparse_gemm"]
    y = sparse_gemm(torch.from_numpy(x), torch.from_numpy(idx),
                    torch.from_numpy(val), n).numpy()
    assert LAUNCHES["sparse_gemm"] == before + 1
    xj, ij, vj = map(jnp.asarray, (x, idx, val))
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(y).max()))
    np.testing.assert_allclose(
        y, np.asarray(jsg.sparse_gemm(xj, ij, vj, n, interpret=True)), **tol)
    np.testing.assert_allclose(
        y, np.asarray(jref.sparse_gemm_ref(xj, ij, vj, n)), **tol)
    assert not y[:, 0].any()            # the empty row


@pytest.mark.parametrize("M,R,n", [(4, 40, 256), (1, 8, 128), (9, 33, 300)])
def test_qdq_gemm_plain_matches_repro(M, R, n):
    rng = np.random.RandomState(M + R + n)
    x = rng.randn(M, n).astype(np.float32)
    lv = rng.randint(-15, 16, (R, n)).astype(np.int8)
    scale = rng.rand(R, 1).astype(np.float32)
    y = qdq_gemm(torch.from_numpy(x), torch.from_numpy(lv),
                 torch.from_numpy(scale)).numpy()
    xj, lj, sj = map(jnp.asarray, (x, lv, scale))
    # float32 sums of n products in another order: 1e-5 of the largest
    # output (cancellation leaves small outputs with a larger rtol)
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(y).max()))
    np.testing.assert_allclose(
        y, np.asarray(jsg.qdq_gemm(xj, lj, sj, interpret=True)), **tol)
    np.testing.assert_allclose(y, np.asarray(jref.qdq_gemm_ref(xj, lj, sj)),
                               **tol)


def test_gemm_wrappers_refuse_bad_inputs():
    x = torch.zeros(2, 8)
    idx = torch.zeros(3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="features"):
        sparse_gemm(x, idx, torch.zeros(3, 4), 16)
    with pytest.raises(TypeError):
        sparse_gemm(x, idx.to(torch.int64), torch.zeros(3, 4), 8)
    with pytest.raises(ValueError, match="scale"):
        qdq_gemm(x, torch.zeros(3, 8, dtype=torch.int8), torch.zeros(3))
    with pytest.raises(ValueError, match="contiguous"):
        qdq_gemm(torch.zeros(8, 2).T, torch.zeros(3, 8, dtype=torch.int8),
                 torch.zeros(3, 1))


# ---------------------------------------------------------------------------
# the model: prefill and contiguous decode logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compressed", [False, True])
def test_prefill_and_decode_logits_match_repro(smoke, compressed):
    cfg_j, cfg_t = smoke["cfg_j"], smoke["cfg_t"]
    pj = smoke["comp_j"] if compressed else smoke["params_j"]
    pt = smoke["comp_t"] if compressed else smoke["params_t"]
    toks = np.random.RandomState(1).randint(0, cfg_j.vocab, (2, 11))
    lj, cj, _ = jtf.prefill(pj, {"tokens": jnp.asarray(toks)}, cfg_j,
                            max_len=24)
    lt, ct, _ = tf.prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t,
                           KERNEL, max_len=24)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        tf.forward(pt, {"tokens": torch.from_numpy(toks)}, cfg_t,
                   KERNEL).numpy(),
        np.asarray(jtf.forward(pj, {"tokens": jnp.asarray(toks)}, cfg_j)),
        rtol=1e-4, atol=1e-4)
    tok = np.array([4, 200])
    for pos in (11, 12, 13):
        lj, cj = jtf.decode_step(pj, cj, jnp.asarray(tok), pos, cfg_j)
        lt, ct = tf.decode_step(pt, ct, torch.from_numpy(tok), pos, cfg_t,
                                KERNEL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k),
                                   rtol=1e-4, atol=1e-5)
        tok = np.array(jnp.argmax(lj, axis=-1))


def test_flash_decode_path_matches_plain_decode(smoke):
    cfg_t = smoke["cfg_t"]
    flash = dataclasses.replace(cfg_t, use_pallas=True)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 512, (3, 7)))
    _, c0, _ = tf.prefill(smoke["comp_t"], {"tokens": toks}, cfg_t, KERNEL,
                          max_len=16)
    _, c1, _ = tf.prefill(smoke["comp_t"], {"tokens": toks}, cfg_t, KERNEL,
                          max_len=16)
    tok, pos = torch.tensor([1, 2, 3]), torch.tensor([7, 7, 7])
    before = LAUNCHES["flash_decode"]
    l0, _ = tf.decode_step(smoke["comp_t"], c0, tok, pos, cfg_t, KERNEL)
    l1, _ = tf.decode_step(smoke["comp_t"], c1, tok, pos, flash, KERNEL)
    assert LAUNCHES["flash_decode"] == before + cfg_t.n_layers
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)


def test_get_model_and_unported_paths_raise():
    cfg = get_config("yi-6b", smoke=True)
    m = get_model(cfg)
    assert m.prefill is tf.prefill and m.decode_step is tf.decode_step
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        m.loss_fn(None, None, cfg)
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        get_model(get_config("qwen3-moe-30b-a3b", smoke=True))
    with pytest.raises(NotImplementedError):
        tf.init_params(torch.Generator(),
                       dataclasses.replace(cfg, scan_layers=False), "cpu")


# ---------------------------------------------------------------------------
# the engine, contiguous KV layout
# ---------------------------------------------------------------------------

REQS = [([5, 6, 7], 6), ([1], 4), ([9, 8, 7, 6, 5], 8), ([3, 3], 5),
        ([11, 2, 4], 7), ([8], 3)]


def _run(eng, reqs=REQS):
    for p, n in reqs:
        eng.submit(p, n)
    return eng.run()


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_engine_tokens_match_repro(smoke, scheduler):
    kw = dict(max_batch=2, max_len=20, prompt_pad=6, scheduler=scheduler)
    jeng = JEngine(smoke["comp_j"], smoke["cfg_j"], **kw)
    res_j = _run(jeng)
    sc.reset_stats()
    reset_launches()
    eng = ServeEngine(smoke["comp_t"], smoke["cfg_t"], dispatch=KERNEL, **kw)
    res_t = _run(eng)
    assert res_t["outputs"] == res_j["outputs"]
    assert res_t["steps"] == res_j["steps"]
    assert eng.occupancy == jeng.occupancy
    assert sc.STATS["densify"] == 0
    L, calls = smoke["cfg_t"].n_layers, eng.steps + eng.admissions
    assert LAUNCHES["sparse_gemm"] == 7 * L * calls
    assert LAUNCHES["qdq_gemm"] == calls
    assert LAUNCHES["flash_decode"] == LAUNCHES["paged_decode"] == 0
    # the flash-decode kernel path gives the same tokens
    flash = dataclasses.replace(smoke["cfg_t"], use_pallas=True)
    reset_launches()
    eng = ServeEngine(smoke["comp_t"], flash, dispatch=KERNEL, **kw)
    assert _run(eng)["outputs"] == res_j["outputs"]
    assert LAUNCHES["flash_decode"] == L * eng.steps


def test_engine_rejects_bad_requests(smoke):
    eng = ServeEngine(smoke["params_t"], smoke["cfg_t"], max_batch=2,
                      max_len=20, prompt_pad=6)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 3)
    with pytest.raises(ValueError, match="prompt_pad"):
        eng.submit(list(range(7)), 3)
    with pytest.raises(ValueError, match="room"):
        ServeEngine(smoke["params_t"], smoke["cfg_t"], max_len=6,
                    prompt_pad=6)


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "yi-6b", "--smoke", "--compressed", "--paged",
                "--kv-quant", "--flash", "--dispatch", "kernel", "--device",
                "cpu", "--requests", "3", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "'densify': 0" in out and "requests=3" in out
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--checkpoint", "/nonexistent"])
