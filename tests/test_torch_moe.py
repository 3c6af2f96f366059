"""The port's MoE decoder (``repro_torch.models.moe``) against ``repro``'s.

``repro``'s smoke weights (float32) of qwen3-moe (every layer MoE, top-2
of 4 experts) and llama4-maverick (MoE every 2nd layer, top-1, a shared
expert, dense SwiGLUs between) go to numpy and through
``convert.params_from_jax``; the same numpy tokens go to both packages.
``repro``'s functions run under ``jax.jit`` with ``NO_SHARDING`` (its
training path; the expert-parallel path is not ported).  Tolerances
(measured gaps in brackets, on this container's CPU):

- ``loss_fn``: the loss within 1e-5 relative [0 / 1.4e-7]; each
  gradient leaf within 1e-4 of its largest entry [8.3e-7 / 4.7e-6]
  against ``jax.value_and_grad``; ``dropped`` equal and ``aux_loss``
  within 1e-6 relative [0], at the smoke capacity and at
  ``capacity_factor`` 0.3, where assignments are dropped [224 / 56 of
  them; loss 1.4e-7, gradients 1.3e-6 / 2.0e-6];
- ``prefill``: the last logits and the KV caches within 1e-5 [logits
  1.9e-6 / 1.7e-6, caches 1.7e-6];
- four ``decode_step`` s: logits within 1e-4 [1.7e-6 / 2.1e-6];
- routing: ``_route`` and ``_assignments`` give ``repro``'s experts,
  capacity positions and keep mask exactly (weights within 1e-6), also
  under a router of zeros, where every probability ties (``lax.top_k``
  takes the lower expert index first);
- a loss and its backward read nothing back to the host
  (``FakeTensorMode``), so a round program can capture them;
- ``preset:arch`` resolves leaf by leaf as in ``repro`` (qwen3-moe,
  rwkv6-3b, zamba2-7b at full size);
- ``repro``'s prefill ≡ decode pin (``tests/test_models.py``) on the
  port, at its tolerance (5e-4).

The full configs' parameter trees (``meta`` device) equal
``jax.eval_shape`` of ``repro``'s (qwen3-moe-30b-a3b: 30.5 B).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.models import get_model, moe
from repro_torch.tree import tree_leaves, value_and_grad
from test_torch_rwkv6 import assert_same_tree, full_trees, tokens

ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    return jax, jnp, jget, jmoe


def repro_loss(jx, params, jcfg, toks):
    """(loss, aux, grads) of repro's loss_fn under jit."""
    jax, jnp, _, jmoe = jx
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg,
                               loss_chunk=16), has_aux=True))(params)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


@pytest.fixture(scope="module", params=ARCHS)
def model(jx, request):
    """repro's smoke weights in both packages, and repro's outputs:
    loss, aux and gradients, prefill of 24 tokens, four decode steps."""
    jax, jnp, jget, jmoe = jx
    arch = request.param
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    params = jax.jit(functools.partial(jmoe.init_params, cfg=jcfg))(
        jax.random.PRNGKey(3))
    toks = tokens(cfg.vocab)
    loss, aux, grads = repro_loss(jx, params, jcfg, toks)
    logits, cache, _ = jax.jit(functools.partial(
        jmoe.prefill, cfg=jcfg, max_len=64))(
        params, {"tokens": jnp.asarray(toks[:, :24])})
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    pre = (np.asarray(logits), as_np(cache))
    step = jax.jit(lambda p, c, t, pos: jmoe.decode_step(p, c, t, pos, jcfg))
    dec = []
    for t in range(24, 28):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t]), t)
        dec.append(np.asarray(logits))
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, toks=toks, loss=loss,
                aux=aux, grads=grads, jparams=params,
                params=params_from_jax(as_np(params), "cpu"),
                prefill=pre, decode=dec)


def port_loss(params, cfg, toks):
    fn = value_and_grad(lambda p, b: moe.loss_fn(p, b, cfg,
                                                 loss_chunk=16)[0])
    loss, grads = fn(params, {"tokens": torch.from_numpy(toks)})
    _, aux = moe.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg,
                         loss_chunk=16)
    return float(loss), aux, [g.numpy() for g in tree_leaves(grads)]


def assert_aux_equal(aux, want):
    assert set(aux) == {"aux_loss", "dropped"}
    assert all(isinstance(v, torch.Tensor) for v in aux.values())
    assert float(aux["dropped"]) == want["dropped"]
    np.testing.assert_allclose(float(aux["aux_loss"]), want["aux_loss"],
                               rtol=1e-6)


def assert_grads_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_loss_and_grads_match_repro(model):
    cfg = model["cfg"]
    assert cfg.param_dtype == "float32" and cfg.remat
    loss, aux, grads = port_loss(model["params"], cfg, model["toks"])
    np.testing.assert_allclose(loss, model["loss"], rtol=1e-5)
    assert_aux_equal(aux, model["aux"])
    assert_grads_close(grads, model["grads"])


def test_capacity_drops_match_repro(jx, model):
    """At capacity_factor 0.3 an expert keeps fewer slots than it is
    routed: the same assignments are dropped (count equal), with the
    same loss and gradients."""
    jcfg = dataclasses.replace(model["jcfg"], capacity_factor=0.3)
    cfg = dataclasses.replace(model["cfg"], capacity_factor=0.3)
    loss_j, aux_j, grads_j = repro_loss(jx, model["jparams"], jcfg,
                                        model["toks"])
    assert aux_j["dropped"] > 0
    loss, aux, grads = port_loss(model["params"], cfg, model["toks"])
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    assert_aux_equal(aux, aux_j)
    assert_grads_close(grads, grads_j)


def test_prefill_and_decode_match_repro(model):
    cfg, toks = model["cfg"], model["toks"]
    logits, cache, n = moe.prefill(
        model["params"], {"tokens": torch.from_numpy(toks[:, :24])}, cfg,
        max_len=64)
    want_logits, want = model["prefill"]
    assert n == 24 and tuple(logits.shape) == want_logits.shape
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=1e-5)
    for got, exp in ((cache.k, want.k), (cache.v, want.v)):
        assert tuple(got.shape) == exp.shape
        np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-5)
    for row in range(toks.shape[0]):
        np.testing.assert_array_equal(cache.pos[:, row].numpy(), want.pos)
    for t, exp in zip(range(24, 28), model["decode"]):
        logits, cache = moe.decode_step(
            model["params"], cache, torch.from_numpy(toks[:, t]), t, cfg)
        np.testing.assert_allclose(logits.numpy(), exp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("zero_router", [False, True])
def test_routing_matches_repro(jx, zero_router):
    """_route's experts and weights, and _assignments' positions and
    keep mask, at a capacity that drops; a router of zeros makes every
    probability tie, and both take experts 0 .. K-1."""
    jax, jnp, jget, jmoe = jx
    jcfg = jget("qwen3-moe-30b-a3b", smoke=True)
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((48, cfg.d_model)).astype(np.float32)
    router = (np.zeros((cfg.d_model, cfg.n_experts), np.float32)
              if zero_router else
              (rng.standard_normal((cfg.d_model, cfg.n_experts))
               * cfg.d_model ** -0.5).astype(np.float32))
    eids_j, w_j, aux_j = jmoe._route(jnp.asarray(x), jnp.asarray(router),
                                     jcfg)
    eids, w, aux = moe._route(torch.from_numpy(x), torch.from_numpy(router),
                              cfg)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(eids_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)
    if zero_router:
        assert (eids.numpy() == np.arange(cfg.moe_top_k)).all()
    C = moe._capacity(eids.numel(), cfg.n_experts, 0.3)
    assert C == jmoe._capacity(eids.numel(), cfg.n_experts, 0.3)
    got = moe._assignments(eids, 0, cfg.n_experts, C)
    want = jmoe._assignments(eids_j, 0, cfg.n_experts, C)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[2].all()                  # some assignments dropped


def test_zero_router_loss_matches_repro(jx):
    """Every router probability tied in every layer: the whole loss,
    aux and drops as repro's."""
    jax, _, jget, jmoe = jx
    arch = "qwen3-moe-30b-a3b"
    jcfg = dataclasses.replace(jget(arch, smoke=True), capacity_factor=0.3)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=0.3)
    params = jmoe.init_params(jax.random.PRNGKey(7), jcfg)
    params["layers"]["moe"]["router"] = jax.numpy.zeros_like(
        params["layers"]["moe"]["router"])
    toks = tokens(cfg.vocab, seq=24, seed=4)
    loss_j, aux_j, _ = repro_loss(jx, params, jcfg, toks)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    loss, aux = moe.loss_fn(pt, {"tokens": torch.from_numpy(toks)}, cfg,
                            loss_chunk=16)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert_aux_equal(aux, aux_j)


def test_decode_matches_prefill():
    """repro's pin (tests/test_models.py) on the port, and decode under
    ``use_pallas`` launching ``flash_decode`` once a layer with the same
    logits."""
    from repro_torch.kernels import dispatch as dsp
    cfg = ModelConfig(name="t", family="moe", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=97,
                      n_experts=4, moe_top_k=2, capacity_factor=8.0,
                      param_dtype="float32", act_dtype="float32", q_chunk=8)
    params = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(tokens(cfg.vocab, seq=11, seed=1))
    _, cache, _ = moe.prefill(params, {"tokens": toks[:, :8]}, cfg,
                              max_len=32)
    want, _, _ = moe.prefill(params, {"tokens": toks[:, :9]}, cfg, max_len=32)
    fl = dataclasses.replace(cfg, use_pallas=True)
    before = LAUNCHES["flash_decode"]
    got, _ = moe.decode_step(params, cache, toks[:, 8], 8, fl,
                             dsp.DispatchConfig(mode="kernel"))
    assert LAUNCHES["flash_decode"] - before == cfg.n_layers
    torch.testing.assert_close(got, want[:, 0], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_reads_nothing_back_to_the_host(arch):
    """A loss body and its backward read no value back to the host and
    make no tensor whose shape depends on the data (no ``.item()``,
    ``nonzero`` or boolean indexing), so a round program can capture
    them as one CUDA graph: ``FakeTensorMode`` runs them on tensors with
    no data and raises on either."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch, smoke=True)
    params = moe.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    toks = torch.from_numpy(tokens(cfg.vocab, seq=16))
    with FakeTensorMode(allow_non_fake_inputs=True):
        loss, grads = value_and_grad(lambda p, b: moe.loss_fn(p, b, cfg)[0])(
            params, {"tokens": toks})
    assert loss.shape == () and len(tree_leaves(grads)) == len(
        tree_leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_tree_matches_repro(jx, arch):
    got, want = full_trees(jx, arch)
    total = assert_same_tree(got, want, jx[0])
    assert total == {"qwen3-moe-30b-a3b": 30_532_110_336,
                     "llama4-maverick-400b-a17b": 403_731_747_840}[arch]
    assert total == get_config(arch).param_count()


def test_model_api_dispatches_moe():
    m = get_model(get_config("qwen3-moe-30b-a3b", smoke=True))
    assert m.module is moe and m.forward is None
    assert m.prefill is moe.prefill and m.decode_step is moe.decode_step


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_arch_policy_resolves_as_repro(jx, arch):
    """``preset:arch`` (budget_1pct for the MoE archs, sign_hetero for
    the SSM ones) resolves leaf by leaf as in ``repro`` on the full
    config's tree: the same operator and k a leaf.  Under budget_1pct a
    path that matches none of its patterns (the expert stacks
    ``layers/moe/w1``, the router, the embeddings) is Identity."""
    jax = jx[0]
    from repro.configs import get_config as jget
    from repro.configs.policies import get_policy_preset as jpreset
    from repro.core import operators as jops
    from repro.core import policy as jpol
    from repro.models import api as japi
    from repro_torch.configs import get_policy_preset
    from repro_torch.core import policy as pol
    from repro_torch.core.operators import CompressionOp
    cfg = get_config(arch)
    got = pol.resolve(pol.as_channel_spec(get_policy_preset(
        "arch", arch=arch)).uplink,
        get_model(cfg).init_params(None, cfg, device="meta"))
    jcfg = jget(arch)
    want = jpol.resolve(jpol.as_channel_spec(jpreset("arch", arch=arch))
                        .uplink, jax.eval_shape(lambda: japi.get_model(
                            jcfg).init_params(jax.random.PRNGKey(0), jcfg)))
    got = tree_leaves(got, is_leaf=lambda o: isinstance(o, CompressionOp))
    want = jax.tree_util.tree_leaves(
        want, is_leaf=lambda o: isinstance(o, jops.CompressionOp))
    assert [type(o).__name__ for o in got] == [type(o).__name__
                                               for o in want]
    for a, b in zip(got, want):
        assert getattr(a, "k", None) == getattr(b, "k", None)
    if arch.startswith("qwen3"):
        paths = [p for p, o in zip(tree_paths_of(cfg), got)
                 if type(o).__name__ != "Identity"]
        assert paths == [f"layers/attn/{w}" for w in ("wk", "wo", "wq",
                                                      "wv")]


def tree_paths_of(cfg) -> list:
    from repro_torch.core.policy import tree_paths
    return tree_paths(get_model(cfg).init_params(None, cfg,
                                                 device="meta"))[0]
