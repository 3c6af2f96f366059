"""The port's RWKV-6 (``repro_torch.models.rwkv6``) against ``repro``'s.

``repro``'s smoke weights (float32) go to numpy and through
``convert.params_from_jax``; the same numpy tokens go to both packages.
``repro``'s functions run under ``jax.jit``.  Tolerances (measured gaps
in brackets, on this container's CPU):

- ``loss_fn``: the loss within 1e-5 relative [0]; each gradient leaf
  within 1e-4 of its largest entry [2.1e-6] against
  ``jax.value_and_grad``;
- ``prefill``: the last logits and the cache's wkv states and shift
  states within 1e-5 [logits 1.9e-6; wkv states 3.3e-6, up to 7.0];
- four ``decode_step`` s: logits within 1e-4 [1.8e-6];
- ``wkv6_chunked`` against ``repro``'s at chunks of 8 and 32 over a
  padded 45-position sequence, output and final state within 1e-5 of
  their largest entry [3.2e-7 / 1.7e-6 and 1.4e-6 / 4.3e-7], and
  against the port's sequential ``wkv6_ref`` alike;
- ``repro``'s prefill ≡ decode pin (``tests/test_models.py``) on the
  port, at its tolerance (5e-4).

The full rwkv6-3b config's parameter tree (``meta`` device) equals
``jax.eval_shape`` of ``repro``'s: leaf paths, shapes, dtypes, total.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import tree_paths
from repro_torch.models import get_model, rwkv6
from repro_torch.tree import tree_leaves, value_and_grad

ARCH = "rwkv6-3b"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import rwkv6 as jrw
    return jax, jnp, jget, jrw


def tokens(vocab, batch=2, seq=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (batch, seq + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def model(jx):
    """repro's smoke weights in both packages, and repro's outputs:
    loss and gradients, prefill of 24 tokens, four decode steps."""
    jax, jnp, jget, jrw = jx
    jcfg, cfg = jget(ARCH, smoke=True), get_config(ARCH, smoke=True)
    params = jax.jit(functools.partial(jrw.init_params, cfg=jcfg))(
        jax.random.PRNGKey(3))
    toks = tokens(cfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jrw.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, jcfg, loss_chunk=16)[0]))(params)
    logits, cache, _ = jax.jit(functools.partial(jrw.prefill, cfg=jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :24])})
    pre = (np.asarray(logits), [np.asarray(c) for c in cache])
    step = jax.jit(lambda p, c, t, pos: jrw.decode_step(p, c, t, pos, jcfg))
    dec = []
    for t in range(24, 28):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t]), t)
        dec.append(np.asarray(logits))
    return dict(cfg=cfg, toks=toks, loss=float(loss),
                grads=[np.asarray(g)
                       for g in jax.tree_util.tree_leaves(grads)],
                params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params), "cpu"),
                prefill=pre, decode=dec)


def test_loss_and_grads_match_repro(model):
    cfg = model["cfg"]
    assert cfg.param_dtype == "float32" and cfg.remat
    fn = value_and_grad(lambda p, b: rwkv6.loss_fn(p, b, cfg,
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
    cfg, toks = model["cfg"], model["toks"]
    logits, cache, n = rwkv6.prefill(
        model["params"], {"tokens": torch.from_numpy(toks[:, :24])}, cfg)
    want_logits, want_cache = model["prefill"]
    assert n == 24 and tuple(logits.shape) == want_logits.shape
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=1e-5)
    assert isinstance(cache, rwkv6.RWKVCache)
    for got, want in zip(cache, want_cache):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for t, want in zip(range(24, 28), model["decode"]):
        logits, cache = rwkv6.decode_step(
            model["params"], cache, torch.from_numpy(toks[:, t]), t, cfg)
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("chunk", [8, 32])
def test_wkv6_chunked_matches_repro(jx, chunk):
    """repro's chunked form (log-space decays, the [-60, 0] clip, decay-1
    padding: 45 positions are 6 chunks of 8 or 2 of 32, padded) and its
    final state, against the port's, and the port's against its own
    sequential oracle."""
    jax, jnp, _, jrw = jx
    rng = np.random.default_rng(chunk)
    B, S, H, N = 2, 45, 3, 8
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, N)))).astype(np.float32)
    w[0, 3, 1, 2] = 1e-30                # a decay of nearly all the state
    u = rng.standard_normal((H, N)).astype(np.float32)
    out_j, st_j = jrw.wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                   chunk=chunk, return_state=True)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    out, st = rwkv6.wkv6_chunked(*t, chunk=chunk, return_state=True)
    for got, want in ((out, out_j), (st, st_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    want = rwkv6.wkv6_ref(*t).numpy()
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_chunk_groups_do_not_change_the_result(monkeypatch):
    """The intra-chunk products run a group of chunks at a time; groups
    of one chunk (repro's scan) give the same output."""
    rng = np.random.default_rng(1)
    r, k, v, x = (torch.from_numpy(rng.standard_normal(
        (1, 40, 2, 4)).astype(np.float32)) for _ in range(4))
    t, w = [r, k, v], torch.sigmoid(x)
    u = torch.ones(2, 4)
    whole = rwkv6.wkv6_chunked(*t, w, u, chunk=8)
    monkeypatch.setattr(rwkv6, "GROUP_ELEMS", 1)
    torch.testing.assert_close(rwkv6.wkv6_chunked(*t, w, u, chunk=8), whole,
                               rtol=0, atol=1e-6)


def test_decode_matches_prefill():
    """repro's pin (tests/test_models.py) on the port: prefill of t + 1
    tokens ≡ prefill of 8 then decode steps."""
    cfg = ModelConfig(name="t", family="rwkv6", n_layers=2, d_model=32,
                      d_ff=64, vocab=97, ssm_head_dim=8,
                      param_dtype="float32", act_dtype="float32")
    params = rwkv6.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    toks = torch.from_numpy(tokens(cfg.vocab, seq=12, seed=2))
    _, cache, _ = rwkv6.prefill(params, {"tokens": toks[:, :8]}, cfg)
    for t in range(8, 12):
        want, _, _ = rwkv6.prefill(params, {"tokens": toks[:, :t + 1]}, cfg)
        got, cache = rwkv6.decode_step(params, cache, toks[:, t], t, cfg)
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


def full_trees(jx, arch):
    """(port's meta tree, repro's eval_shape tree) at the full config."""
    jax, _, jget, _ = jx
    from repro.models import api as japi
    cfg = get_config(arch)
    got = get_model(cfg).init_params(None, cfg, device="meta")
    jcfg = jget(arch)
    want = jax.eval_shape(lambda: japi.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg))
    return got, want


def assert_same_tree(got, want, jax) -> int:
    paths, leaves, _ = tree_paths(got)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert paths == ["/".join(str(getattr(k, "key", k)) for k in p)
                     for p, _ in flat]
    for t, (_, a) in zip(leaves, flat):
        assert t.device.type == "meta"
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
    total = sum(t.numel() for t in leaves)
    assert total == sum(int(np.prod(a.shape)) for _, a in flat)
    return total


def test_full_parameter_tree_matches_repro(jx):
    got, want = full_trees(jx, ARCH)
    total = assert_same_tree(got, want, jx[0])
    assert total == 3_073_313_280


def test_model_api_dispatches_rwkv6():
    m = get_model(get_config(ARCH, smoke=True))
    assert m.module is rwkv6 and m.forward is None
    assert m.init_cache is rwkv6.init_cache
