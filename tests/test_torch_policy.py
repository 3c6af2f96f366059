"""``core.policy`` and the policy presets against ``repro``'s: the DSL
round-trips to identical ``to_string`` / ``to_dict`` output in both
packages, ``tree_paths`` / ``resolve`` / ``leaf_groups`` agree leaf for
leaf on the yi-6b smoke transformer, and the trainer resolves a policy
(or a string ``downlink_op``) as ``repro``'s does: the quickstart's
softmax regression with ``lm_hetero``-style rules gives the same wire
bits exactly and losses within rtol 1e-4.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.policies import POLICY_PRESETS as J_PRESETS
from repro.core import policy as jpol
from repro.models import softmax as jsoft, transformer as jtf
from repro.optim import inverse_time as j_inverse_time, sgd as j_sgd
from repro.train import RunConfig as JRun, train as jtrain
from repro_torch.configs import POLICY_PRESETS, get_config, get_policy_preset
from repro_torch.core import policy as pol
from repro_torch.data import mnist_like, worker_batches
from repro_torch.models import softmax as tsoft, transformer as tf
from repro_torch.optim import inverse_time, sgd
from repro_torch.train import RunConfig, train
from repro_torch.tree import value_and_grad

SPECS = [
    "topk:k=0.01",
    "topk",
    "norm|bias|ln->identity; embed|head->qsgd:s=15; .*->topk:k=0.01",
    "budget=0.01; mlp|attn->topk; .*->identity",
    "budget=500; attn->row_topk:row_len=128; .*->identity",
    "topk:k=0.01 >> topk:k=0.05",
    ".*->signtopk:k=0.01,m=2",
    "layers/attn/w[qk]->randk:k=0.1; .*->qtopk:k=0.2,s=7,scaled=true",
] + sorted(POLICY_PRESETS.values())


@pytest.mark.parametrize("text", SPECS)
def test_dsl_roundtrip_matches_repro(text):
    t, j = pol.parse(text), jpol.parse(text)
    assert type(t).__name__ == type(j).__name__
    assert t.to_string() == j.to_string()
    assert t.to_dict() == j.to_dict()
    assert pol.parse(t.to_string()).to_dict() == t.to_dict()
    assert pol.from_dict(j.to_dict()).to_string() == t.to_string()
    assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())


def test_presets_match_repro():
    assert POLICY_PRESETS == J_PRESETS
    assert (get_policy_preset("arch", "yi-6b").to_string()
            == jpol.parse(J_PRESETS["lm_hetero"]).to_string())
    with pytest.raises(KeyError):
        get_policy_preset("nope")


def test_load_from_file(tmp_path):
    spec = pol.parse("embed->qsgd:s=15;.*->topk:k=0.02")
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(spec.to_dict()))
    assert pol.load(f"@{path}").to_dict() == jpol.load(f"@{path}").to_dict()
    (tmp_path / "op.json").write_text(json.dumps({"op": "topk", "k": 3}))
    assert (pol.load(f"@{tmp_path / 'op.json'}").to_string()
            == jpol.load(f"@{tmp_path / 'op.json'}").to_string())


@pytest.mark.parametrize("bad,exc", [
    ("nosuchop", KeyError), ("topk:q=1", TypeError), ("topk:k", ValueError),
    ("a >> b >> c", ValueError), ("budget=2.5; topk", ValueError),
    ("(->topk", Exception),
])
def test_bad_specs_fail_like_repro(bad, exc):
    with pytest.raises(exc):
        jpol.parse(bad)
    with pytest.raises(exc):
        pol.parse(bad)


@pytest.fixture(scope="module")
def smoke_trees():
    cfg_j = j_get_config("yi-6b", smoke=True)
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                    cfg_j))
    params_t = tf.init_params(torch.Generator().manual_seed(0),
                              get_config("yi-6b", smoke=True), "cpu")
    return shapes, params_t


def test_tree_paths_and_groups_match_repro(smoke_trees):
    shapes, params_t = smoke_trees
    pj, lj, _ = jpol.tree_paths(shapes)
    pt, lt, _ = pol.tree_paths(params_t)
    assert pt == pj
    assert [tuple(t.shape) for t in lt] == [tuple(s.shape) for s in lj]
    assert pol.leaf_groups(params_t) == jpol.leaf_groups(shapes)


@pytest.mark.parametrize("text", [s for s in SPECS if ">>" not in s])
def test_resolve_matches_repro(smoke_trees, text):
    shapes, params_t = smoke_trees
    ops_j = jax.tree_util.tree_leaves(
        jpol.resolve(text, shapes),
        is_leaf=lambda o: isinstance(o, jpol.CompressionOp))
    ops_t = pol.tree_paths(pol.resolve(text, params_t),
                           is_leaf=lambda o: isinstance(
                               o, pol.CompressionOp))[1]
    assert ([pol.OpSpec.of(o).to_string() for o in ops_t]
            == [jpol.OpSpec.of(o).to_string() for o in ops_j])


def test_resolve_requires_a_catch_all(smoke_trees):
    _, params_t = smoke_trees
    with pytest.raises(ValueError, match="catch-all"):
        pol.resolve("attn->topk", params_t)
    with pytest.raises(ValueError, match="single direction"):
        pol.resolve("topk >> topk", params_t)
    up, down = pol.as_channel_spec("ln->identity;.*->topk >> "
                                   "qsgd").resolve(params_t)
    assert type(up["layers"]["ln1"]).__name__ == "Identity"
    assert type(down["embed"]).__name__ == "QSGDQuantizer"


# ---------------------------------------------------------------------------
# the trainer resolves policies as repro's does
# ---------------------------------------------------------------------------


def _softmax_runs(run_kw, op_j=None, op_t=None):
    R, T, b = 4, 12, 8
    x, y = mnist_like(400, seed=0)
    cfg_j = jsoft.SoftmaxConfig(l2=1.0 / len(x))
    cfg_t = tsoft.SoftmaxConfig(l2=1.0 / len(x))

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jsoft.loss_fn(pp, batch, cfg_j)[0])(p)

    grad_t = value_and_grad(lambda p, batch: tsoft.loss_fn(p, batch,
                                                           cfg_t)[0])
    kw = dict(total_steps=T, R=R, H=2, log_every=3, runtime="step",
              dispatch="kernel", **run_kw)
    _, hj = jtrain(grad_j, jsoft.init_params(jax.random.PRNGKey(0), cfg_j),
                   j_sgd(), op_j, j_inverse_time(60.0, 100.0),
                   worker_batches(x, y, R, b, T, seed=1), JRun(**kw))
    _, ht = train(grad_t, tsoft.init_params(cfg_t, device="cpu"), sgd(),
                  op_t, inverse_time(60.0, 100.0),
                  worker_batches(x, y, R, b, T, seed=1), RunConfig(**kw),
                  device="cpu")
    return hj, ht


@pytest.mark.parametrize("policy", [
    "z->identity; x->topk:k=0.05",
    "budget=0.02; x->topk; .*->identity",
    # a Top_k downlink after a Top_k uplink: a SignTop_k uplink would make
    # the averaged delta full of equal magnitudes, whose ties at the
    # downlink threshold follow float rounding (ROADMAP queue 3)
    "z->identity; .*->topk:k=0.05 >> z->identity; .*->topk:k=0.1",
    "z->identity; .*->row_signtopk:k=0.05,row_len=10,m=2",
])
def test_trainer_policy_matches_repro(policy):
    hj, ht = _softmax_runs({"policy": policy})
    assert ht.bits == hj.bits and ht.rounds == hj.rounds
    assert ht.bits_down == hj.bits_down
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-4)
    assert ht.bits[-1] > 0


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_trainer_string_downlink_matches_repro():
    from repro.core import operators as jops
    from repro_torch.core import operators as tops
    hj, ht = _softmax_runs({"downlink_op": "topk:k=0.1"},
                           jops.TopK(k=0.05), tops.TopK(k=0.05))
    assert ht.bits == hj.bits and ht.bits_down == hj.bits_down
    assert ht.bits_down[-1] > 0
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-4)


def test_trainer_policy_conflicts_raise():
    from repro_torch.core import operators as tops
    with pytest.raises(ValueError, match="OR the operator"):
        _softmax_runs_port({"policy": "topk"}, tops.TopK(k=0.1))
    with pytest.raises(ValueError, match="conflicts"):
        _softmax_runs_port({"policy": "topk", "downlink_op": "topk"})


def _softmax_runs_port(run_kw, op=None):
    x, y = mnist_like(64, seed=0)
    cfg = tsoft.SoftmaxConfig()
    grad = value_and_grad(lambda p, b: tsoft.loss_fn(p, b, cfg)[0])
    return train(grad, tsoft.init_params(cfg, device="cpu"), sgd(), op,
                 inverse_time(1.0, 10.0), worker_batches(x, y, 2, 4, 2,
                                                         seed=0),
                 RunConfig(total_steps=2, R=2, **run_kw), device="cpu")
