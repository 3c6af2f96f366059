"""The port's ResNet against ``repro``'s on the same weights.

A tiny bottleneck ResNet (two stages, width 8, stem stride 2) in
``repro``'s parameter layout is converted with ``params_from_jax`` and
run by both packages on the same images, at 8x8 (even: XLA's "SAME" pads a
stride-2 3x3 conv 0 before and 1 after) and 7x7 (odd: 1 and 1).  Logits
and every gradient leaf agree to rtol 1e-5 / atol 1e-6: the two
frameworks' convolutions and GroupNorm reduce in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as jres
from repro.models import softmax as jsoft
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import resnet as tres
from repro_torch.models import softmax as tsoft
from repro_torch.tree import tree_leaves, value_and_grad

CFG_J = jres.ResNetConfig(stage_sizes=(1, 1), bottleneck=True, width=8,
                          num_classes=10, stem_stride=2)
CFG_T = tres.ResNetConfig(stage_sizes=(1, 1), bottleneck=True, width=8,
                          num_classes=10, stem_stride=2)


def tiny_repro_params(seed=1):
    """``repro``'s parameter tree for ``CFG_J`` as numpy arrays.  The
    layout (tree, key names, shapes, flatten order) is checked against
    ``jax.eval_shape`` of ``repro``'s ``init_params``; the values come
    from the port's seeded init, which draws from the same
    distributions, because ``repro``'s eager init compiles one XLA
    program per leaf shape (about 13 s on the CPU).  Seed 0 is avoided:
    on ``batch(8)`` it puts a pre-ReLU activation at 2e-7, where the two
    frameworks' rounding lands on opposite sides of the kink and the
    gradients below it differ by design, not by a fault."""
    tree = params_to_numpy(tres.init_params(torch.Generator().manual_seed(
        seed), CFG_T, device="cpu"))
    want = jax.eval_shape(lambda: jres.init_params(jax.random.PRNGKey(0),
                                                   CFG_J))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    assert [a.shape for a in jax.tree_util.tree_leaves(tree)] == \
        [s.shape for s in jax.tree_util.tree_leaves(want)]
    return tree


def batch(hw, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


@pytest.mark.parametrize("size,k,stride", [(8, 3, 2), (7, 3, 2), (8, 1, 2),
                                           (7, 3, 1), (224, 3, 2),
                                           (112, 1, 1), (5, 7, 2)])
def test_same_pads_match_xla(size, k, stride):
    x = jnp.zeros((1, size, size, 1))
    w = jnp.zeros((k, k, 1, 1))
    out = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO",
                                                          "NHWC"))
    lo, hi = tres.same_pads(size, k, stride)
    assert (size + lo + hi - k) // stride + 1 == out.shape[1]
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert (lo, hi) == tuple(want)


@pytest.mark.parametrize("hw", [8, 7])
def test_resnet_logits_and_grads_match_repro(hw):
    tree = tiny_repro_params()
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params_t = params_from_jax(tree, device="cpu")
    assert [tuple(p.shape) for p in tree_leaves(params_t)] == \
        [p.shape for p in jax.tree_util.tree_leaves(params_j)]
    b = batch(hw)
    logits_j = jax.jit(lambda p, x: jres.forward(p, x, CFG_J))(
        params_j, jnp.asarray(b["images"]))
    logits_t = tres.forward(params_t, b["images"], CFG_T)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jres.loss_fn(p, jax.tree_util.tree_map(jnp.asarray, b),
                               CFG_J)[0]))(params_j)
    loss_t, grads_t = value_and_grad(
        lambda p: tres.loss_fn(p, b, CFG_T)[0])(params_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for gt, gj in zip(tree_leaves(params_to_numpy(grads_t)),
                      jax.tree_util.tree_leaves(grads_j)):
        np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-5, atol=1e-6)


def test_resnet50_layout_matches_repro():
    """Full-width ResNet-50 parameters (initialized, not run): the same
    leaves, shapes and flatten order as repro — 25,541,672 parameters in
    153 leaves, which fixes how dispatch buckets them."""
    shapes_j = [l.shape for l in jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: jres.init_params(jax.random.PRNGKey(0),
                                 jres.resnet50_config(1000))))]
    params_t = tres.init_params(torch.Generator().manual_seed(0),
                                tres.resnet50_config(1000), device="cpu")
    shapes_t = [tuple(p.shape) for p in tree_leaves(params_t)]
    assert shapes_t == shapes_j
    assert len(shapes_t) == 153
    assert sum(int(np.prod(s)) for s in shapes_t) == 25_541_672


def test_softmax_loss_and_grads_match_repro():
    cfg_j = jsoft.SoftmaxConfig(input_dim=20, num_classes=5, l2=0.01)
    cfg_t = tsoft.SoftmaxConfig(input_dim=20, num_classes=5, l2=0.01)
    rng = np.random.default_rng(3)
    params = {"x": rng.standard_normal((20, 5)).astype(np.float32),
              "z": rng.standard_normal(5).astype(np.float32)}
    b = {"features": rng.standard_normal((6, 20)).astype(np.float32),
         "labels": rng.integers(0, 5, 6).astype(np.int32)}
    loss_j, g_j = jax.value_and_grad(lambda p: jsoft.loss_fn(
        p, jax.tree_util.tree_map(jnp.asarray, b), cfg_j)[0])(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss_t, g_t = value_and_grad(lambda p: tsoft.loss_fn(p, b, cfg_t)[0])(
        params_from_jax(params, device="cpu"))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]),
                                   rtol=1e-5, atol=1e-7)
    zero = tsoft.init_params(cfg_t, device="cpu")
    assert all(float(v.abs().sum()) == 0 for v in zero.values())
