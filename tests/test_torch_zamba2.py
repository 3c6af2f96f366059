"""The port's Zamba2 (``repro_torch.models.zamba2``) against ``repro``'s.

``repro``'s smoke weights (float32: 4 Mamba2 layers, the shared
attention block before layers 0 and 2) go to numpy and through
``convert.params_from_jax``; the same numpy tokens go to both packages.
``repro``'s functions run under ``jax.jit``.  Tolerances (measured gaps
in brackets, on this container's CPU):

- ``loss_fn``: the loss within 1e-5 relative [7.2e-8]; each gradient
  leaf within 1e-4 of its largest entry [8.6e-6] against
  ``jax.value_and_grad``;
- ``prefill``: the last logits within 1e-5 [4.3e-6]; the SSM and conv
  states and the shared block's KV caches within 1e-5 of their largest
  entry where that exceeds 1, else 1e-5 [the SSM states, up to 13.5:
  1.1e-5 absolute, float32 sums over 24 positions in another order;
  conv 3.3e-6, k / v 6.5e-6 / 5.8e-6];
- four ``decode_step`` s: logits within 1e-4 [3.1e-6];
- ``ssd_chunked`` against ``repro``'s at chunks of 16 and 64 over a
  padded 45-position sequence, output and final state within 1e-5 of
  their largest entry [2.4e-7 / 1.5e-6 and 1.5e-7 / 3.3e-7];
- ``repro``'s prefill ≡ decode pin (``tests/test_models.py``) on the
  port, at its tolerance (7e-4).

The full zamba2-7b config's parameter tree (``meta`` device) equals
``jax.eval_shape`` of ``repro``'s.
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
from repro_torch.models import get_model, zamba2
from repro_torch.tree import tree_leaves, value_and_grad
from test_torch_rwkv6 import assert_same_tree, full_trees, tokens

ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import zamba2 as jzm
    return jax, jnp, jget, jzm


@pytest.fixture(scope="module")
def model(jx):
    """repro's smoke weights in both packages, and repro's outputs:
    loss and gradients, prefill of 24 tokens, four decode steps."""
    jax, jnp, jget, jzm = jx
    jcfg, cfg = jget(ARCH, smoke=True), get_config(ARCH, smoke=True)
    params = jax.jit(functools.partial(jzm.init_params, cfg=jcfg))(
        jax.random.PRNGKey(3))
    toks = tokens(cfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jzm.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, jcfg, loss_chunk=16)[0]))(params)
    logits, cache, _ = jax.jit(functools.partial(
        jzm.prefill, cfg=jcfg, max_len=64))(
        params, {"tokens": jnp.asarray(toks[:, :24])})
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    pre = (np.asarray(logits), as_np(cache))
    step = jax.jit(lambda p, c, t, pos: jzm.decode_step(p, c, t, pos, jcfg))
    dec = []
    for t in range(24, 28):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t]), t)
        dec.append(np.asarray(logits))
    return dict(cfg=cfg, toks=toks, loss=float(loss),
                grads=[np.asarray(g)
                       for g in jax.tree_util.tree_leaves(grads)],
                params=params_from_jax(as_np(params), "cpu"),
                prefill=pre, decode=dec)


def test_loss_and_grads_match_repro(model):
    cfg = model["cfg"]
    assert cfg.param_dtype == "float32" and cfg.remat
    assert zamba2.shared_apps(cfg) == [0, 2]
    fn = value_and_grad(lambda p, b: zamba2.loss_fn(p, b, cfg,
                                                    loss_chunk=16)[0])
    loss, grads = fn(model["params"], {"tokens": torch.from_numpy(
        model["toks"])})
    np.testing.assert_allclose(float(loss), model["loss"], rtol=1e-5)
    got = tree_leaves(grads)
    assert len(got) == len(model["grads"])
    for a, b in zip(got, model["grads"]):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_prefill_and_decode_match_repro(model):
    """Logits, the SSM / conv states (the conv state is the last K - 1
    pre-activation columns of [x | B | C]) and the shared block's ring
    caches; the port keeps a slot -> position map per row, repro one
    for the batch."""
    cfg, toks = model["cfg"], model["toks"]
    logits, cache, n = zamba2.prefill(
        model["params"], {"tokens": torch.from_numpy(toks[:, :24])}, cfg,
        max_len=64)
    want_logits, want = model["prefill"]
    assert n == 24 and tuple(logits.shape) == want_logits.shape
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=1e-5)
    for got, exp in ((cache.ssm, want.ssm), (cache.conv, want.conv),
                     (cache.attn.k, want.attn.k), (cache.attn.v, want.attn.v)):
        assert tuple(got.shape) == exp.shape
        scale = max(1.0, float(np.abs(exp).max()))
        np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                   atol=1e-5 * scale)
    for row in range(toks.shape[0]):
        np.testing.assert_array_equal(cache.attn.pos[:, row].numpy(),
                                      want.attn.pos)
    for t, exp in zip(range(24, 28), model["decode"]):
        logits, cache = zamba2.decode_step(
            model["params"], cache, torch.from_numpy(toks[:, t]), t, cfg)
        np.testing.assert_allclose(logits.numpy(), exp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_repro(jx, chunk):
    jax, jnp, _, jzm = jx
    rng = np.random.default_rng(chunk)
    Bt, S, H, P, N = 2, 45, 3, 4, 8
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B, C = (rng.standard_normal((Bt, S, N)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    args = (x, dt, A, B, C, D)
    y_j, h_j = jzm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk,
                               return_state=True)
    t = [torch.from_numpy(a) for a in args]
    y, h = zamba2.ssd_chunked(*t, chunk=chunk, return_state=True)
    for got, want in ((y, y_j), (h, h_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    want = zamba2.ssd_ref(*t).numpy()
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_decode_matches_prefill():
    """repro's pin (tests/test_models.py) on the port."""
    cfg = ModelConfig(name="t", family="zamba2", n_layers=5, d_model=32,
                      n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64, vocab=97,
                      ssm_state=8, ssm_head_dim=8, attn_every=2,
                      param_dtype="float32", act_dtype="float32", q_chunk=8)
    params = zamba2.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    toks = torch.from_numpy(tokens(cfg.vocab, seq=12, seed=2))
    _, cache, _ = zamba2.prefill(params, {"tokens": toks[:, :8]}, cfg,
                                 max_len=32)
    for t in range(8, 12):
        want, _, _ = zamba2.prefill(params, {"tokens": toks[:, :t + 1]}, cfg,
                                    max_len=32)
        got, cache = zamba2.decode_step(params, cache, toks[:, t], t, cfg)
        torch.testing.assert_close(got, want, rtol=7e-4, atol=7e-4)


def test_shared_block_runs_the_attention_kernels(model):
    """Under ``use_pallas`` the shared block's window is static: its
    prefill launches ``flash_attention`` once an application and its
    decode ``flash_decode`` once an application (on the CPU, the
    kernels' plain versions), with the plain path's logits."""
    from repro_torch.kernels import dispatch as dsp
    cfg = model["cfg"]
    fl = dataclasses.replace(cfg, use_pallas=True)
    kernel = dsp.DispatchConfig(mode="kernel")
    toks = torch.from_numpy(model["toks"][:, :24])
    before = dict(LAUNCHES)
    got, cache, _ = zamba2.prefill(model["params"], {"tokens": toks}, fl,
                                   kernel, max_len=64)
    assert LAUNCHES["flash_attention"] - before["flash_attention"] == 2
    want, plain, _ = zamba2.prefill(model["params"], {"tokens": toks}, cfg,
                                    max_len=64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    tok = torch.from_numpy(model["toks"][:, 24])
    before = dict(LAUNCHES)
    got, _ = zamba2.decode_step(model["params"], cache, tok, 24, fl, kernel)
    assert LAUNCHES["flash_decode"] - before["flash_decode"] == 2
    want, _ = zamba2.decode_step(model["params"], plain, tok, 24, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_full_parameter_tree_matches_repro(jx):
    got, want = full_trees(jx, ARCH)
    assert assert_same_tree(got, want, jx[0]) == 6_789_666_000


def test_model_api_dispatches_zamba2():
    m = get_model(get_config(ARCH, smoke=True))
    assert m.module is zamba2 and m.forward is None
    assert m.loss_fn is zamba2.loss_fn
