"""Unscanned layer stacks (``scan_layers=False``) against ``repro``: the
path on which prefill runs the flash-attention kernel.

``repro``'s unscanned parameters (a list of per-layer dicts with 2-D
leaves, tie-free values as in ``test_torch_serve.py``) go through
``convert.params_from_jax``; both packages then run the gemma3-1b smoke
model (a 16-token window, then a global layer) and the yi-6b smoke model
in float32, with ``use_pallas`` on (``repro``'s Pallas kernels in
interpret mode, the port's wrappers on the CPU through dispatch
"kernel") and off.  Tolerances: logits and caches within 1e-5 of their
largest magnitude and the loss within 1e-5 relative (float32 sums in
another order through two layers); gradients within 1e-4 of each leaf's
largest entry; engine logits within 1e-4 of the largest (compressed
matmuls sum in another order); greedy tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import NO_SHARDING
from repro.models import transformer as jtf
from repro.serve import compressed as jsc
from repro.serve.engine import ServeEngine as JEngine
from repro.train import checkpoint as jckpt
from repro_torch.configs import POLICY_PRESETS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import policy as pol
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
from repro_torch.models import transformer as tf
from repro_torch.models.layers import KVCache
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, value_and_grad
from test_torch_serve import tie_free_params

ARCHS = ["gemma3-1b", "yi-6b"]
KERNEL = dsp.DispatchConfig(mode="kernel")
POLICY = POLICY_PRESETS["lm_hetero"]  # both archs' preset:arch


def configs(arch: str, use_pallas: bool):
    kw = dict(scan_layers=False, use_pallas=use_pallas)
    return (dataclasses.replace(j_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg_j, cfg_t = configs(arch, False)
    tree = tie_free_params(cfg_j, 3)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params_t = params_from_jax(tree, device="cpu")
    return dict(arch=arch, tree=tree, params_j=params_j, params_t=params_t,
                comp_j=jsc.compress_tree(params_j, POLICY),
                comp_t=sc.compress_tree(params_t, POLICY))


def tokens(cfg, batch=2, seq=40, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, (batch, seq)).astype(np.int32)


def close(a, b, tol=1e-5):
    """``a`` within ``tol`` of ``b``, relative and of ``b``'s largest
    magnitude."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(b).max())))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_gives_repro_unscanned_structure(arch):
    cfg_j, cfg_t = configs(arch, False)
    want = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                  cfg_j))
    got = tf.init_params(torch.Generator().manual_seed(0), cfg_t, "cpu")
    assert isinstance(got["layers"], list)
    assert len(got["layers"]) == cfg_t.n_layers
    paths_t, leaves_t, _ = pol.tree_paths(got)
    flat_j = jax.tree_util.tree_flatten_with_path(want)[0]
    paths_j = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in p) for p, _ in flat_j]
    assert paths_t == paths_j
    assert "layers/0/attn/wq" in paths_t
    for t, (_, j) in zip(leaves_t, flat_j):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


def test_converted_tree_keeps_the_list(model):
    layers = model["params_t"]["layers"]
    assert isinstance(layers, list) and all(
        lp["attn"]["wq"].dim() == 2 for lp in layers)
    for a, b in zip(tree_leaves(model["params_t"]),
                    jax.tree_util.tree_leaves(model["tree"])):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_round_trips_between_packages(model, writer, tmp_path):
    path = str(tmp_path / "ckpt")
    if writer == "repro":
        jckpt.save(path, model["params_j"], step=5)
        like = tf.init_params(torch.Generator().manual_seed(1),
                              configs(model["arch"], False)[1], "cpu")
        back = checkpoint.restore(path, like)
        assert isinstance(back["layers"], list)
        for a, b in zip(tree_leaves(back),
                        jax.tree_util.tree_leaves(model["tree"])):
            np.testing.assert_array_equal(a.numpy(), b)
    else:
        checkpoint.save(path, model["params_t"], step=5)
        back = jckpt.restore(path, model["params_j"])
        assert isinstance(back["layers"], list)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        tree_leaves(model["params_t"])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_compressed_leaves_match_repro(model):
    lj = jax.tree_util.tree_leaves(
        model["comp_j"], is_leaf=lambda x: isinstance(x, jsc.CompressedTensor))
    lt = tree_leaves(model["comp_t"])
    assert len(lj) == len(lt)
    n_sparse = 0
    for cj, ct in zip(lj, lt):
        if not isinstance(cj, jsc.CompressedTensor):
            assert not isinstance(ct, sc.CompressedTensor)
            continue
        assert (ct.kind, ct.row_len, ct.shape, ct.out_axis, ct.op) == (
            cj.kind, cj.row_len, cj.shape, cj.out_axis, cj.op)
        assert ct.a.dim() == 2
        n_sparse += ct.kind == "sparse"
        np.testing.assert_array_equal(ct.a.numpy(), np.asarray(cj.a))
        np.testing.assert_allclose(ct.b.numpy(), np.asarray(cj.b),
                                   rtol=1e-6, atol=0)
    # lm_hetero: the 7 Top_k matmuls of every layer, 2-D each
    assert n_sparse == 7 * len(model["params_t"]["layers"])
    assert sc.tree_bytes(model["comp_t"]) == jsc.tree_bytes(model["comp_j"])


# ---------------------------------------------------------------------------
# forward, loss, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_loss_match_repro(model, use_pallas):
    cfg_j, cfg_t = configs(model["arch"], use_pallas)
    toks = tokens(cfg_t, seq=41)
    reset_launches()
    got = tf.forward(model["params_t"], {"tokens": torch.from_numpy(
        toks[:, :-1])}, cfg_t, KERNEL)
    want = jtf.forward(model["params_j"], {"tokens": jnp.asarray(
        toks[:, :-1])}, cfg_j)
    close(got, want)
    loss_t, _ = tf.loss_fn(model["params_t"], {"tokens": torch.from_numpy(
        toks)}, cfg_t, KERNEL, loss_chunk=16)
    loss_j, _ = jtf.loss_fn(model["params_j"], {"tokens": jnp.asarray(toks)},
                            cfg_j, NO_SHARDING, loss_chunk=16)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    L = cfg_t.n_layers
    assert LAUNCHES["flash_attention"] == (2 * L if use_pallas else 0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_repro(model, use_pallas):
    cfg_j, cfg_t = configs(model["arch"], use_pallas)
    toks = tokens(cfg_t, seq=21, seed=1)
    lt, ct, n = tf.prefill(model["params_t"], {"tokens": torch.from_numpy(
        toks)}, cfg_t, KERNEL, max_len=32)
    lj, cj, nj = jtf.prefill(model["params_j"], {"tokens": jnp.asarray(
        toks)}, cfg_j, max_len=32)
    assert n == nj == 21
    close(lt, lj)
    # one ring cache per layer, as repro's unscanned prefill returns
    assert isinstance(ct, list) and len(ct) == cfg_t.n_layers
    for a, b in zip(ct, cj):
        assert isinstance(a, KVCache)
        close(a.k, b.k)
        close(a.v, b.v)
        # the port keeps a position map per row, repro one for the batch
        np.testing.assert_array_equal(
            a.pos.numpy(), np.broadcast_to(np.asarray(b.pos), a.pos.shape))
    tok_t = lt[:, 0].argmax(-1)
    tok_j = jnp.argmax(lj[:, 0], -1)
    for pos in range(21, 25):
        lt, ct = tf.decode_step(model["params_t"], ct, tok_t, pos, cfg_t,
                                KERNEL)
        lj, cj = jtf.decode_step(model["params_j"], cj, tok_j, pos, cfg_j)
        close(lt, lj)
        tok_t, tok_j = lt.argmax(-1), jnp.argmax(lj, -1)


def test_loss_gradient_matches_repro(model):
    cfg_j, cfg_t = configs(model["arch"], False)
    toks = tokens(cfg_t, seq=41, seed=2)

    def loss_j(p):
        return jtf.loss_fn(p, {"tokens": jnp.asarray(toks)}, cfg_j,
                           NO_SHARDING, loss_chunk=16)[0]

    vj, gj = jax.value_and_grad(loss_j)(model["params_j"])
    fn = value_and_grad(lambda p, b: tf.loss_fn(p, b, cfg_t,
                                                loss_chunk=16)[0])
    vt, gt = fn(model["params_t"], {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    gj, gt = jax.tree_util.tree_leaves(gj), tree_leaves(gt)
    assert len(gj) == len(gt)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_flash_loss_evaluates_but_has_no_backward(model):
    _, cfg_t = configs(model["arch"], True)
    batch = {"tokens": torch.from_numpy(tokens(cfg_t, seq=17))}
    params = params_from_jax(model["tree"], device="cpu")
    with torch.no_grad():
        loss, _ = tf.loss_fn(params, batch, cfg_t, KERNEL)
    assert torch.isfinite(loss)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tf.loss_fn(params, batch, cfg_t, KERNEL)


def test_last_real_logits_do_not_depend_on_padding(model):
    """What admission relies on: the engine right-pads prompts, and the
    causal mask keeps the real positions' outputs free of the pad (to
    float32 sums over rows of another length)."""
    _, cfg_t = configs(model["arch"], True)
    toks = torch.from_numpy(tokens(cfg_t, batch=1, seq=13, seed=4))
    padded = torch.cat([toks, torch.full((1, 19), 7, dtype=toks.dtype)], 1)
    a = tf.forward(model["params_t"], {"tokens": toks}, cfg_t, KERNEL)
    b = tf.forward(model["params_t"], {"tokens": padded}, cfg_t, KERNEL)
    close(b[:, :13], a)


def test_stacked_stacks_never_launch_the_prefill_kernel(model):
    """repro reaches its flash kernel only with static windows, i.e. on
    unscanned stacks; the port's stacked configs keep chunked attention
    under use_pallas too."""
    cfg = dataclasses.replace(get_config(model["arch"], smoke=True),
                              use_pallas=True)
    assert cfg.scan_layers
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    reset_launches()
    tf.prefill(params, {"tokens": torch.from_numpy(tokens(cfg))}, cfg,
               KERNEL, max_len=48)
    eng = ServeEngine(params, cfg, max_batch=2, max_len=20, prompt_pad=6,
                      dispatch=KERNEL)
    eng.submit([1, 2, 3], 3)
    eng.run()
    assert LAUNCHES["flash_attention"] == 0
    assert LAUNCHES["flash_decode"] == cfg.n_layers * eng.steps > 0


def test_paged_serving_refuses_unscanned(model):
    _, cfg_t = configs(model["arch"], True)
    with pytest.raises(ValueError, match="scanned"):
        ServeEngine(model["params_t"], cfg_t, max_batch=2, max_len=20,
                    prompt_pad=6, paged=True, page_size=4)
    with pytest.raises(ValueError, match="scanned"):
        tf.decode_step_paged(model["params_t"], None, None,
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.bool), cfg_t)


# ---------------------------------------------------------------------------
# the engine, contiguous KV layout
# ---------------------------------------------------------------------------

REQS = [([5, 6, 7], 6), ([1], 4), ([9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8], 8),
        ([3, 3], 5), ([11, 2, 4, 200, 17, 40, 41], 7), ([8], 3)]


def _repro_step_recorder(eng, cfg_j, record):
    """Replace the repro engine's jitted contiguous step by the same step
    that also hands out each slot's logits (appended to ``record`` with
    the active-slot mask at the time)."""
    def step(params, caches, toks, poss):
        def one(cache, tok, pos):
            logits, new_c = jtf.decode_step(params, cache, tok[None], pos,
                                            cfg_j)
            return (jnp.argmax(logits[0], axis=-1).astype(jnp.int32),
                    new_c, logits[0])
        nxt, new_caches, lg = jax.vmap(one)(caches, toks, poss)
        return nxt, new_caches, poss + 1, lg

    jitted = jax.jit(step)

    def call(*args):
        nxt, caches, poss, lg = jitted(*args)
        record.append((np.asarray(lg), [not s.free for s in eng._slots]))
        return nxt, caches, poss

    eng._step_jit = call


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_engine_matches_repro(model, scheduler, compressed, monkeypatch):
    cfg_j, cfg_t = configs(model["arch"], True)
    key = "comp" if compressed else "params"
    kw = dict(max_batch=2, max_len=24, prompt_pad=12, scheduler=scheduler)
    rec_j, rec_t = [], []
    jeng = JEngine(model[key + "_j"], cfg_j, **kw)
    _repro_step_recorder(jeng, cfg_j, rec_j)
    for p, n in REQS:
        jeng.submit(p, n)
    res_j = jeng.run()

    decode_step = tf.decode_step

    def recording(params, cache, token, pos, cfg, dispatch=None):
        logits, cache = decode_step(params, cache, token, pos, cfg, dispatch)
        rec_t.append(logits.numpy().copy())
        return logits, cache

    monkeypatch.setattr(tf, "decode_step", recording)
    sc.reset_stats()
    reset_launches()
    eng = ServeEngine(model[key + "_t"], cfg_t, dispatch=KERNEL, **kw)
    for p, n in REQS:
        eng.submit(p, n)
    res_t = eng.run()
    assert res_t["outputs"] == res_j["outputs"]
    assert res_t["steps"] == res_j["steps"] and eng.occupancy == \
        jeng.occupancy
    assert len(rec_t) == len(rec_j) == eng.steps
    for lt, (lj, active) in zip(rec_t, rec_j):
        close(lt[active], lj[active], tol=1e-4)
    L = cfg_t.n_layers
    assert LAUNCHES["flash_attention"] == L * eng.admissions
    assert LAUNCHES["flash_decode"] == L * eng.steps
    if compressed:
        assert sc.STATS["densify"] == 0
        assert LAUNCHES["sparse_gemm"] == 7 * L * (eng.steps + eng.admissions)
