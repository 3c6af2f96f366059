"""Checkpoints from trainer to server, against ``repro``: the trainer's
``ckpt_dir`` / ``ckpt_every`` files, ``latest_step`` / ``latest_full`` /
``is_compact``, the compact serving format (``save_compact`` /
``load_compact``) both ways between the packages, and
``launch/serve.py --checkpoint`` on both formats, on the CPU.

Tolerances: checkpoint files of one package restore bit for bit in the
other; the two trainers' masters agree to rtol 1e-5 / atol 1e-7 (XLA's
fused multiply-adds over six steps); compressed buffers: indices, int8
levels and Top_k values exact, SignTop_k values and QSGD scales to rtol
1e-6 (a float sum in another order); greedy tokens exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import worker_batches as j_batches
from repro.models import softmax as jsoft
from repro.optim import inverse_time as j_inverse_time, sgd as j_sgd
from repro.serve import compressed as jsc
from repro.serve.engine import ServeEngine as JEngine
from repro.train import RunConfig as JRun, checkpoint as jckpt, train as jtrain
from repro_torch.configs import POLICY_PRESETS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import policy as pol
from repro_torch.data import mnist_like, worker_batches
from repro_torch.kernels import dispatch as dsp
from repro_torch.launch import serve as launch
from repro_torch.models import softmax as tsoft
from repro_torch.optim import inverse_time, sgd
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import RunConfig, checkpoint, train
from repro_torch.tree import tree_flatten_with_path, tree_leaves, \
    value_and_grad
from test_torch_serve import tie_free_params

KERNEL = dsp.DispatchConfig(mode="kernel")
POLICY = POLICY_PRESETS["lm_hetero"]


# ---------------------------------------------------------------------------
# the trainer's checkpoints and per-group ledger
# ---------------------------------------------------------------------------

def _softmax_runs(jdir: str, tdir: str):
    R, T, b, n = 4, 6, 8, 400
    x, y = mnist_like(n, seed=0)
    kw = dict(total_steps=T, R=R, H=2, log_every=1, runtime="step",
              ckpt_every=2, leaf_ledger=True, policy="topk:k=0.05")
    cfg_j = jsoft.SoftmaxConfig(l2=1.0 / n)

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jsoft.loss_fn(pp, batch, cfg_j)[0])(p)

    _, hj = jtrain(grad_j, jsoft.init_params(jax.random.PRNGKey(0), cfg_j),
                   j_sgd(), None, j_inverse_time(60.0, 100.0),
                   j_batches(x, y, R, b, T, seed=1),
                   JRun(ckpt_dir=jdir, **kw))
    cfg_t = tsoft.SoftmaxConfig(l2=1.0 / n)
    grad_t = value_and_grad(lambda p, batch: tsoft.loss_fn(p, batch,
                                                           cfg_t)[0])
    _, ht = train(grad_t, tsoft.init_params(cfg_t, device="cpu"), sgd(),
                  None, inverse_time(60.0, 100.0),
                  worker_batches(x, y, R, b, T, seed=1),
                  RunConfig(ckpt_dir=tdir, **kw), device="cpu")
    return hj, ht, cfg_j, cfg_t


def test_trainer_checkpoints_and_leaf_ledger_match_repro(tmp_path):
    jdir, tdir = str(tmp_path / "repro"), str(tmp_path / "port")
    hj, ht, cfg_j, cfg_t = _softmax_runs(jdir, tdir)
    # the per-group ledger (groups "x", "z") and its summary
    assert ht.leaf_groups == list(hj.leaf_groups) == ["x", "z"]
    assert ht.leaf_bits == hj.leaf_bits
    assert ht.leaf_bits_down == hj.leaf_bits_down
    assert ht.bits == hj.bits and ht.bits_down == hj.bits_down
    assert ht.summary()["leaf_bits"] == hj.summary()["leaf_bits"]
    assert ht.summary()["leaf_bits_down"] == hj.summary()["leaf_bits_down"]
    assert sum(ht.leaf_bits[-1]) == ht.bits[-1]
    # step_<N> at each ckpt_every point and final, and the full
    # train-state snapshots full_step_<N>, in both packages
    masters = {"step_2", "step_4", "step_6", "final"}
    fulls = {"full_step_2", "full_step_4", "full_step_6"}
    assert set(os.listdir(tdir)) == set(os.listdir(jdir)) == masters | fulls
    for root in (jdir, tdir):
        assert checkpoint.latest_step(root) == jckpt.latest_step(root) == 6
        assert checkpoint.latest_full(root) == jckpt.latest_full(root) == 6
    like_t = tsoft.init_params(cfg_t, device="cpu")
    like_j = jsoft.init_params(jax.random.PRNGKey(0), cfg_j)
    for name in sorted(masters):
        with open(os.path.join(jdir, name, "manifest.json")) as f:
            man_j = json.load(f)
        with open(os.path.join(tdir, name, "manifest.json")) as f:
            man_t = json.load(f)
        assert man_t == man_j                # keys, dtypes, step, policy
        assert str(checkpoint.load_policy(os.path.join(tdir, name))) == \
            str(pol.from_dict(man_j["policy"]))
        t_of_t = checkpoint.restore(os.path.join(tdir, name), like_t)
        t_of_j = checkpoint.restore(os.path.join(jdir, name), like_t)
        j_of_t = jckpt.restore(os.path.join(tdir, name), like_j)
        j_of_j = jckpt.restore(os.path.join(jdir, name), like_j)
        for a, b, c, d in zip(tree_leaves(t_of_t), tree_leaves(t_of_j),
                              jax.tree_util.tree_leaves(j_of_t),
                              jax.tree_util.tree_leaves(j_of_j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
            np.testing.assert_array_equal(b.numpy(), np.asarray(d))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


def test_latest_helpers_and_is_compact(tmp_path):
    root = str(tmp_path)
    for d in ("step_3", "step_12", "step_x", "full_step_5", "full_step_17",
              "final", "stepper"):
        os.makedirs(os.path.join(root, d))
    for mod in (checkpoint, jckpt):
        assert mod.latest_step(root) == 12
        assert mod.latest_full(root) == 17
        assert mod.latest_step(str(tmp_path / "missing")) is None
        assert mod.latest_full(str(tmp_path / "missing")) is None
        assert not mod.is_compact(root)
        assert not mod.is_compact(str(tmp_path / "missing"))
    checkpoint.save(os.path.join(root, "dense"), {"w": torch.ones(3)})
    assert not checkpoint.is_compact(os.path.join(root, "dense"))
    with pytest.raises(ValueError, match="compact-v1"):
        checkpoint.load_compact(os.path.join(root, "dense"), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(os.path.join(root, "dense"), {"w": torch.ones(4)})


# ---------------------------------------------------------------------------
# compact-v1 between the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg_j = j_get_config("yi-6b", smoke=True)
    cfg_t = get_config("yi-6b", smoke=True)
    tree = tie_free_params(cfg_j, 0)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params_t = params_from_jax(tree, device="cpu")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, comp_j=jsc.compress_tree(params_j, POLICY),
                comp_t=sc.compress_tree(params_t, POLICY))


def _is_ct(x):
    return isinstance(x, (sc.CompressedTensor, jsc.CompressedTensor))


def _paths_j(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_ct)[0]
    return ["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in p) for p, _ in flat]


def _paths_t(tree):
    return ["/".join(str(k) for k in p)
            for p, _ in tree_flatten_with_path(tree, is_leaf=_is_ct)[0]]


@pytest.mark.parametrize("arch,unscanned", [("yi-6b", False),
                                            ("gemma3-1b", True)])
def test_serving_tree_paths_match_jax(arch, unscanned):
    cfg_j = dataclasses.replace(j_get_config(arch, smoke=True),
                                scan_layers=not unscanned)
    tree = tie_free_params(cfg_j, 1)
    comp_j = jsc.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                               POLICY)
    comp_t = sc.compress_tree(params_from_jax(tree, device="cpu"), POLICY)
    assert _paths_t(comp_t) == _paths_j(comp_j)
    if unscanned:
        assert "layers/0/attn/wq" in _paths_t(comp_t)
    assert any(isinstance(l, sc.CompressedTensor) for l in tree_leaves(
        comp_t, is_leaf=_is_ct))


def _same_leaves(tree_t, tree_j):
    lt = tree_leaves(tree_t, is_leaf=_is_ct)
    lj = jax.tree_util.tree_leaves(tree_j, is_leaf=_is_ct)
    assert len(lt) == len(lj)
    for t, j in zip(lt, lj):
        if isinstance(t, sc.CompressedTensor):
            assert (t.kind, t.row_len, t.shape, t.out_axis, t.dtype, t.op) \
                == (j.kind, j.row_len, tuple(j.shape), j.out_axis, j.dtype,
                    j.op)
            np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
            np.testing.assert_allclose(t.b.numpy(), np.asarray(j.b),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


REQS = [([5, 6, 7], 6), ([1], 4), ([9, 8, 7, 6, 5], 8), ([3, 3], 5),
        ([11, 2, 4], 7)]


def _tokens(eng):
    for p, n in REQS:
        eng.submit(p, n)
    return eng.run()["outputs"]


def test_compact_checkpoints_cross_load_and_serve_the_same_tokens(
        smoke, tmp_path):
    kw = dict(max_batch=2, max_len=20, prompt_pad=6)
    jpath, tpath = str(tmp_path / "by_repro"), str(tmp_path / "by_port")
    jckpt.save_compact(jpath, smoke["comp_j"], step=7, policy={"x": 1})
    checkpoint.save_compact(tpath, smoke["comp_t"], step=7, policy={"x": 1})
    with open(os.path.join(jpath, "manifest.json")) as f:
        man_j = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        man_t = json.load(f)
    assert man_t == man_j and man_t["format"] == "compact-v1"
    assert checkpoint.is_compact(jpath) and jckpt.is_compact(tpath)
    # repro's file in the port: repro's buffers, never densified
    sc.reset_stats()
    back_t = checkpoint.load_compact(jpath, device="cpu")
    assert sc.STATS["densify"] == 0
    assert _paths_t(back_t) == _paths_j(smoke["comp_j"])
    _same_leaves(back_t, smoke["comp_j"])
    assert sc.tree_bytes(back_t) == sc.tree_bytes(smoke["comp_t"])
    # the port's file in repro
    back_j = jckpt.load_compact(tpath)
    _same_leaves(smoke["comp_t"], back_j)
    tokens_j = _tokens(JEngine(back_j, smoke["cfg_j"], **kw))
    tokens_t = _tokens(ServeEngine(back_t, smoke["cfg_t"], dispatch=KERNEL,
                                   **kw))
    assert tokens_t == tokens_j
    assert sc.STATS["densify"] == 0
    assert _tokens(ServeEngine(smoke["comp_t"], smoke["cfg_t"],
                               dispatch=KERNEL, **kw)) == tokens_j


def test_unscanned_compact_checkpoint_from_repro_serves_its_tokens(tmp_path):
    """An unscanned stack (``layers/<i>/...`` paths, the layout whose
    prefill runs the flash-attention kernel) saved by ``repro`` loads in
    the port as the same list of layers and serves ``repro``'s tokens."""
    cfg_j = dataclasses.replace(j_get_config("gemma3-1b", smoke=True),
                                scan_layers=False, use_pallas=True)
    cfg_t = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                                scan_layers=False, use_pallas=True)
    comp_j = jsc.compress_tree(jax.tree_util.tree_map(
        jnp.asarray, tie_free_params(cfg_j, 2)), POLICY)
    path = str(tmp_path / "unscanned")
    jckpt.save_compact(path, comp_j)
    sc.reset_stats()
    back_t = checkpoint.load_compact(path, device="cpu")
    assert isinstance(back_t["layers"], list)
    assert len(back_t["layers"]) == cfg_t.n_layers
    assert _paths_t(back_t) == _paths_j(comp_j)
    kw = dict(max_batch=2, max_len=20, prompt_pad=6)
    tokens_t = _tokens(ServeEngine(back_t, cfg_t, dispatch=KERNEL, **kw))
    assert sc.STATS["densify"] == 0
    assert tokens_t == _tokens(JEngine(comp_j, cfg_j, **kw))


# ---------------------------------------------------------------------------
# launch/serve.py --checkpoint
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--smoke", "--device", "cpu", "--dispatch", "kernel",
              "--requests", "3", "--new-tokens", "4"]


def _in_process(params, cfg):
    """What the launcher's defaults serve: its synthetic requests through
    a contiguous continuous-batching engine."""
    eng = ServeEngine(params, cfg, max_batch=4, max_len=64, prompt_pad=16,
                      dispatch=KERNEL)
    for p in launch.synthetic_requests(0, 3, 16, cfg.vocab):
        eng.submit(p, max_new_tokens=4)
    return eng.run()["outputs"]


def test_launcher_serves_a_compact_checkpoint(smoke, tmp_path):
    path = str(tmp_path / "compact")
    checkpoint.save_compact(path, smoke["comp_t"])
    res = launch.main(["--arch", "yi-6b", "--checkpoint", path] + SERVE_ARGS)
    assert res["source"] == "compact checkpoint"
    assert res["stats"]["densify"] == 0
    assert res["sizes"] == sc.tree_bytes(smoke["comp_t"])
    assert res["outputs"] == _in_process(smoke["comp_t"], smoke["cfg_t"])


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_launcher_compresses_a_dense_checkpoint(smoke, writer, tmp_path):
    """A dense checkpoint restored into the model's structure (shapes on
    the meta device) and compressed once with the manifest's policy:
    the tokens of compressing the same master in-process."""
    dsl = "embed|head->qsgd:s=15;.*->topk:k=0.05"
    spec = pol.parse(dsl)
    path = str(tmp_path / "dense")
    if writer == "port":
        checkpoint.save(path, smoke["params_t"], step=3,
                        policy=spec.to_dict())
    else:
        from repro.core import policy as jpol
        jckpt.save(path, smoke["params_j"], step=3,
                   policy=jpol.parse(dsl).to_dict())
    res = launch.main(["--arch", "yi-6b", "--checkpoint", path,
                       "--compressed"] + SERVE_ARGS)
    assert res["source"] == "dense checkpoint -> compressed at load"
    assert res["stats"]["densify"] == 0
    want = sc.compress_tree(smoke["params_t"], spec)
    assert res["sizes"] == sc.tree_bytes(want)
    assert res["outputs"] == _in_process(want, smoke["cfg_t"])
    # --policy wins over the manifest's spec
    res = launch.main(["--arch", "yi-6b", "--checkpoint", path,
                       "--compressed", "--policy", "preset:arch"]
                      + SERVE_ARGS)
    assert res["sizes"] == sc.tree_bytes(smoke["comp_t"])
    # without --compressed the restored master is served dense
    res = launch.main(["--arch", "yi-6b", "--checkpoint", path]
                      + SERVE_ARGS)
    assert res["source"] == "dense checkpoint"
    assert res["outputs"] == _in_process(smoke["params_t"], smoke["cfg_t"])
