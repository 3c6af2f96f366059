"""The slice as a whole: the port's ``train`` against ``repro``'s.

Both trainers run the same model (weights converted with
``params_from_jax``), the same numpy batches and the same schedule, the
port with ``dispatch="kernel"`` (the plain kernel versions through the
packing path) and ``repro`` with Pallas in interpret mode, on the
per-step runtime.  Wire bits and rounds must be identical; the smoothed
losses agree to rtol 1e-4 (the frameworks' convolutions and XLA's fused
multiply-adds round differently, and a few steps compound that).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro.data import make_image_data as j_images, mnist_like as j_mnist
from repro.models import resnet as jres, softmax as jsoft
from repro.optim import inverse_time as j_inverse_time
from repro.optim import momentum_sgd as j_momentum, sgd as j_sgd
from repro.train import RunConfig as JRun, train as jtrain
from repro_torch.convert import params_from_jax
from repro_torch.core import operators as tops
from repro_torch.data import make_image_data, mnist_like, worker_batches
from repro_torch.models import resnet as tres, softmax as tsoft
from repro_torch.optim import inverse_time, momentum_sgd, sgd
from repro_torch.train import RunConfig, make_mask, train
from repro_torch.tree import tree_leaves, value_and_grad
from test_torch_resnet import CFG_J, CFG_T, tiny_repro_params


def test_data_copy_matches_repro():
    xj, yj = j_images(32, hw=8, classes=10, seed=3)
    xt, yt = make_image_data(32, hw=8, classes=10, seed=3)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    xj, yj = j_mnist(200, seed=1)
    xt, yt = mnist_like(200, seed=1)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("name,kw", [
    ("row_topk", {"k": 0.1, "row_len": 128}),
    ("signtopk", {"k": 0.05, "m": 2}),
])
def test_resnet_train_matches_repro(name, kw):
    R, H, T, b = 2, 2, 4, 4
    x, y = make_image_data(64, hw=8, classes=10, seed=0)
    tree = tiny_repro_params()
    params_j = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    params_t = params_from_jax(tree, device="cpu")

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jres.loss_fn(pp, batch, CFG_J)[0])(p)

    grad_t = value_and_grad(lambda p, batch: tres.loss_fn(p, batch,
                                                          CFG_T)[0])
    run_kw = dict(total_steps=T, R=R, H=H, log_every=1, dispatch="kernel",
                  runtime="step")
    _, hist_j = jtrain(grad_j, params_j, j_momentum(0.9),
                       jops.make_operator(name, **kw),
                       j_inverse_time(1.0, 20.0),
                       worker_batches(x, y, R, b, T, seed=1,
                                      feature_key="images"), JRun(**run_kw))
    state, hist_t = train(grad_t, params_t, momentum_sgd(0.9),
                          tops.make_operator(name, **kw),
                          inverse_time(1.0, 20.0),
                          worker_batches(x, y, R, b, T, seed=1,
                                         feature_key="images"),
                          RunConfig(**run_kw), device="cpu")
    assert hist_t.steps == hist_j.steps
    assert hist_t.bits == hist_j.bits and hist_t.rounds == hist_j.rounds
    assert hist_t.bits_down == hist_j.bits_down
    np.testing.assert_allclose(hist_t.loss, hist_j.loss, rtol=1e-4)
    assert hist_t.bits[-1] > 0
    assert all(np.isfinite(float(l.abs().sum()))
               for l in tree_leaves(state.master))


def test_quickstart_softmax_matches_repro():
    """The quickstart's shape: softmax regression, R=8, SignTop_k (m=1,
    the reference operator) with H=4, against vanilla SGD."""
    R, T, b = 8, 20, 8
    x, y = mnist_like(800, seed=0)
    cfg_j = jsoft.SoftmaxConfig(l2=1.0 / len(x))
    cfg_t = tsoft.SoftmaxConfig(l2=1.0 / len(x))
    params_j = jsoft.init_params(jax.random.PRNGKey(0), cfg_j)

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jsoft.loss_fn(pp, batch, cfg_j)[0])(p)

    grad_t = value_and_grad(lambda p, batch: tsoft.loss_fn(p, batch,
                                                           cfg_t)[0])
    for (op_j, op_t), H in [((jops.Identity(), tops.Identity()), 1),
                            ((jops.SignSparsifier(k=0.01, m=1),
                              tops.SignSparsifier(k=0.01, m=1)), 4)]:
        run_kw = dict(total_steps=T, R=R, H=H, log_every=5, runtime="step",
                      target_loss=2.2)
        _, hj = jtrain(grad_j, params_j, j_sgd(), op_j,
                       j_inverse_time(60.0, 100.0),
                       worker_batches(x, y, R, b, T, seed=1), JRun(**run_kw))
        _, ht = train(grad_t, tsoft.init_params(cfg_t, device="cpu"), sgd(),
                      op_t, inverse_time(60.0, 100.0),
                      worker_batches(x, y, R, b, T, seed=1),
                      RunConfig(**run_kw), device="cpu")
        assert ht.bits == hj.bits and ht.rounds == hj.rounds
        assert ht.bits_down == hj.bits_down
        np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-4)
        assert ht.steps_to_target == hj.steps_to_target
        assert ht.bits_to_target == hj.bits_to_target


@pytest.mark.parametrize("overlap", [False, True])
def test_round_runtime_matches_repro(overlap):
    """Both trainers on their default round runtime (``repro``'s scanned
    round programs, the port's round bodies; windows of rounds under
    ``overlap``): the quickstart's SignTop_k at H = 4, ledgers exact,
    losses to test_quickstart_softmax_matches_repro's rtol."""
    R, T, b = 8, 16, 8
    x, y = mnist_like(400, seed=0)
    cfg_j = jsoft.SoftmaxConfig(l2=1.0 / len(x))
    cfg_t = tsoft.SoftmaxConfig(l2=1.0 / len(x))

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jsoft.loss_fn(pp, batch, cfg_j)[0])(p)

    grad_t = value_and_grad(lambda p, batch: tsoft.loss_fn(p, batch,
                                                           cfg_t)[0])
    run_kw = dict(total_steps=T, R=R, H=4, log_every=2, overlap=overlap,
                  overlap_window=2)
    _, hj = jtrain(grad_j, jsoft.init_params(jax.random.PRNGKey(0), cfg_j),
                   j_sgd(), jops.SignSparsifier(k=0.01, m=1),
                   j_inverse_time(60.0, 100.0),
                   worker_batches(x, y, R, b, T, seed=1), JRun(**run_kw))
    _, ht = train(grad_t, tsoft.init_params(cfg_t, device="cpu"), sgd(),
                  tops.SignSparsifier(k=0.01, m=1), inverse_time(60.0, 100.0),
                  worker_batches(x, y, R, b, T, seed=1), RunConfig(**run_kw),
                  device="cpu")
    assert ht.steps == hj.steps and ht.round_blocks == hj.round_blocks
    assert ht.bits == hj.bits and ht.rounds == hj.rounds
    assert ht.bits_down == hj.bits_down
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-4)


def test_make_mask_matches_repro():
    from repro.train.trainer import make_mask as j_make_mask
    for asyn in (False, True):
        kw = dict(total_steps=13, R=4, H=3, asynchronous=asyn, seed=2)
        np.testing.assert_array_equal(make_mask(RunConfig(**kw)),
                                      j_make_mask(JRun(**kw)))


def _tiny_run(**kw):
    x, y = mnist_like(64, seed=0)
    cfg = tsoft.SoftmaxConfig()
    grad = value_and_grad(lambda p, b: tsoft.loss_fn(p, b, cfg)[0])
    return lambda device="cpu": train(
        grad, tsoft.init_params(cfg, device="cpu"), sgd(), tops.TopK(k=0.1),
        inverse_time(1.0, 10.0), worker_batches(x, y, 2, 4, 2, seed=0),
        RunConfig(total_steps=2, R=2, **kw), device=device)


@pytest.mark.parametrize("kw", [{"tune": True}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tiny_run(**kw)()


@pytest.mark.parametrize("kw", [{"retune": True}])
def test_unported_tuning_fields_are_refused(kw):
    """Fields that only tune an unported module are refused, not
    silently ignored: they are not fields of the port's RunConfig yet."""
    with pytest.raises(TypeError):
        RunConfig(total_steps=2, R=2, **kw)
    JRun(total_steps=2, R=2, **kw)          # repro has each of them


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _tiny_run()(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tres.init_params(torch.Generator(), CFG_T)
    with pytest.raises(ValueError):
        _tiny_run(runtime="rounds")()
