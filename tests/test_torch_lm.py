"""The port's LM training loss against ``repro``'s.

``repro_torch.models.transformer.loss_fn`` and its gradients (through
``tree.value_and_grad``) against ``jax.value_and_grad`` of ``repro``'s
``loss_fn`` (``NO_SHARDING``, run outside ``shard_map``) on the float32
smoke configs of yi-6b, gemma3-1b (mixed local / global windows, tied
embeddings) and stablelm-3b, with ``repro``'s initial weights passed
through ``convert.params_from_jax`` and the same tokens.

Tolerances: the loss within 1e-5 relative (float32 sums over the
vocabulary and the chunks in another order); each gradient leaf within
1e-4 of its largest entry (float32 matmul and softmax backward in
another order).  Remat on and off run the same operations in the same
order, so their gradients are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import get_model
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, value_and_grad

ARCHS = ["yi-6b", "gemma3-1b", "stablelm-3b"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs.base import NO_SHARDING
    from repro.models import transformer as jtf
    return jax, jnp, jget, jtf, NO_SHARDING


def tokens_for(cfg, batch=2, seq=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)


def repro_loss_and_grads(jx, arch, toks, loss_chunk):
    jax, jnp, jget, jtf, nos = jx
    jcfg = jget(arch, smoke=True)
    params = jtf.init_params(jax.random.PRNGKey(3), jcfg)

    def loss(p):
        return jtf.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg, nos,
                           loss_chunk=loss_chunk)[0]

    value, grads = jax.value_and_grad(loss)(params)
    as_np = jax.tree_util.tree_map(np.asarray, params)
    return float(value), jax.tree_util.tree_leaves(grads), as_np


def port_loss_and_grads(arch, params_np, toks, loss_chunk, remat=True):
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    params = params_from_jax(params_np, device="cpu")
    fn = value_and_grad(lambda p, b: tf.loss_fn(
        p, b, cfg, loss_chunk=loss_chunk)[0])
    value, grads = fn(params, {"tokens": torch.from_numpy(toks)})
    return float(value), [g.numpy() for g in tree_leaves(grads)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(jx, arch):
    cfg = get_config(arch, smoke=True)
    assert cfg.param_dtype == "float32" and cfg.remat
    toks = tokens_for(cfg)
    # chunks of 16 over 40 positions: two full chunks and a ragged one
    lj, gj, params_np = repro_loss_and_grads(jx, arch, toks, 16)
    lt, gt = port_loss_and_grads(arch, params_np, toks, 16)
    assert np.isfinite(lt)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert len(gt) == len(gj)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_gemma_windows_are_mixed():
    """The smoke gemma3 stack alternates a 16-token window and global
    attention, so 40 positions exercise both masks."""
    assert get_config("gemma3-1b", smoke=True).layer_windows() == (16, -1)
    assert set(get_config("gemma3-1b").layer_windows()) == {1024, -1}


@pytest.mark.parametrize("arch", ["gemma3-1b", "yi-6b"])
def test_remat_on_and_off_give_equal_grads(arch):
    cfg = get_config(arch, smoke=True)
    params = tf.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    toks = tokens_for(cfg, seed=2)
    outs = {r: port_loss_and_grads(arch, params_to_numpy(params), toks, 16,
                                   remat=r) for r in (True, False)}
    assert outs[True][0] == outs[False][0]
    for a, b in zip(outs[True][1], outs[False][1]):
        np.testing.assert_array_equal(a, b)


def _graph_nodes(root) -> list:
    seen, stack, out = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        out.append(node)
        stack.extend(f for f, _ in node.next_functions)
    return out


def test_stacked_leaves_are_unbound_once():
    """Each stacked [L, ...] leaf reaches the layers through one
    ``UnbindBackward`` (its layers' gradients are stacked in one write),
    never through a per-layer select, which would write a full-size
    zero gradient of the stack for every layer."""
    cfg = get_config("gemma3-1b", smoke=True)
    params = tf.init_params(torch.Generator().manual_seed(4), cfg,
                            device="cpu")
    stacked = [p.requires_grad_(True) for p in tree_leaves(
        params["layers"])]
    toks = torch.from_numpy(tokens_for(cfg, seq=24, seed=5))
    loss, _ = tf.loss_fn(params, {"tokens": toks}, cfg)
    nodes = _graph_nodes(loss.grad_fn)

    def feeds_leaf(node):
        return any(type(f).__name__ == "AccumulateGrad"
                   and any(f.variable is p for p in stacked)
                   for f, _ in node.next_functions if f is not None)

    names = [type(n).__name__ for n in nodes if feeds_leaf(n)]
    assert sorted(names) == ["UnbindBackward0"] * len(stacked)


def test_model_api_exposes_loss():
    cfg = get_config("stablelm-3b", smoke=True)
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    loss, aux = model.loss_fn(params, {"tokens": torch.from_numpy(
        tokens_for(cfg, seq=8))}, cfg)
    assert aux == {"ntokens": 16} and torch.isfinite(loss)
