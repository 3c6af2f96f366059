"""The port's overlapped round runtime on the CPU: windows of
equal-length rounds as one program (``engine.make_multiround``,
``run_rounds_overlap``, the trainer's ``overlap``, the launcher's
``--overlap``), bit for bit the serial round runtime and the per-step
runtime, as ``test_overlap.py`` pins ``repro``'s."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core import operators as tops
from repro_torch.core import rounds as trnd
from repro_torch.core import schedule as tsched
from repro_torch.data.synthetic import mnist_like, worker_batches
from repro_torch.models import softmax as tsoft
from repro_torch.optim import constant, inverse_time, momentum_sgd, sgd
from repro_torch.train.trainer import RunConfig, train
from repro_torch.tree import tree_leaves, value_and_grad
from tests.strategies import mask_grid
from tests.test_torch_rounds import assert_same, grad_t, problem

R, T = 4, 24


def _runs(mask, window, downlink=None, leaf=False, cut=None, op=None):
    params, batches = problem(T, seed=1)
    batches = batches[:cut]
    op = op or tops.TopK(k=0.25)
    inner = sgd()
    out = []
    for drive in (teng.run_rounds, teng.run_rounds_overlap):
        sup = teng.make_superstep(grad_t, inner, op, constant(0.05), R,
                                  downlink=downlink, leaf_ledger=leaf)
        kw = {} if drive is teng.run_rounds else {"window": window}
        out.append(drive(teng.init(params, inner, R, downlink=downlink,
                                   leaf_ledger=leaf, device="cpu"),
                         sup, batches, mask, torch.Generator().manual_seed(7),
                         **kw))
    return out


@pytest.mark.parametrize("name,mask", mask_grid(T=T, R=R, H=3))
def test_overlap_matches_serial(name, mask):
    (a, la), (b, lb) = _runs(mask, window=4)
    assert_same(a, b, la, lb)


@pytest.mark.parametrize("downlink,leaf", [
    (None, True), (tops.QSGDQuantizer(s=4), False),
    (tops.QSGDQuantizer(s=4), True)])
def test_overlap_matches_serial_channels(downlink, leaf):
    mask = tsched.async_schedule(T, R, 3, seed=11)
    (a, la), (b, lb) = _runs(mask, 8, downlink=downlink, leaf=leaf,
                             op=tops.QSGDQuantizer(s=4))
    assert_same(a, b, la, lb)
    assert float(a.bits) > 0


@pytest.mark.parametrize("cut", [T - 5, 7, 2])
def test_overlap_truncated_stream(cut):
    mask = np.broadcast_to(tsched.fixed_schedule(T, 3)[:, None],
                           (T, R)).copy()
    (a, la), (b, lb) = _runs(mask, 4, cut=cut)
    assert_same(a, b, la, lb)
    assert b.step == cut


def test_multiround_emits_per_round_ledgers():
    """A window's ledger snapshots are the serial rounds' states'."""
    params, batches = problem(12, seed=2)
    mask = np.broadcast_to(tsched.fixed_schedule(12, 3)[:, None],
                           (12, R)).copy()
    plans = trnd.compile_rounds(mask)
    kw = dict(leaf_ledger=True, downlink=tops.TopK(k=0.2))
    sup = teng.make_superstep(grad_t, sgd(), tops.TopK(k=0.25),
                              constant(0.05), R, **kw)
    st = teng.init(params, sgd(), R, device="cpu", **kw)
    want = []
    for p in plans:
        st, _ = sup(st, teng.stack_block(batches[p.start:p.stop]), p.mask)
        want.append((float(st.bits), float(st.bits_down), st.rounds,
                     st.leaf_bits.tolist(), st.leaf_bits_down.tolist()))
    sup2 = teng.make_superstep(grad_t, sgd(), tops.TopK(k=0.25),
                               constant(0.05), R, **kw)
    multi = teng.make_multiround(sup2)
    st2, losses, leds = multi(
        teng.init(params, sgd(), R, device="cpu", **kw),
        teng.stack_window(batches, 4, 3), np.stack([p.mask for p in plans]))
    assert losses.shape == (4, 3)
    got = list(zip(leds["bits"].tolist(), leds["bits_down"].tolist(),
                   leds["rounds"].tolist(), leds["leaf_bits"].tolist(),
                   leds["leaf_bits_down"].tolist()))
    assert got == want
    assert_same(st, st2, [], [])


def _softmax_run(**kw):
    x, y = mnist_like(96, seed=0)
    cfg = tsoft.SoftmaxConfig()
    grad = value_and_grad(lambda p, b: tsoft.loss_fn(p, b, cfg)[0])
    T_ = 14
    return train(grad, tsoft.init_params(cfg, device="cpu"),
                 momentum_sgd(0.9), tops.QSGDQuantizer(s=4),
                 inverse_time(1.0, 10.0), worker_batches(x, y, 3, 4, T_, 0),
                 RunConfig(total_steps=T_, R=3, H=3, log_every=2,
                           leaf_ledger=True, **kw), device="cpu",
                 eval_fn=lambda m: {"s": sum(float(x.sum())
                                             for x in tree_leaves(m))})


@pytest.mark.parametrize("kw", [
    {}, {"overlap": True},
    {"overlap": True, "overlap_window": 2, "eval_every": 5},
    {"asynchronous": True, "overlap": True, "eval_every": 4},
    {"asynchronous": True, "eval_every": 3},
])
def test_trainer_history_equals_step_runtime(kw):
    """The History of the round runtime (serial or overlapped, with
    mid-round eval points) is the per-step runtime's, field by field."""
    _, h_step = _softmax_run(runtime="step", **{
        k: v for k, v in kw.items() if k not in ("overlap",
                                                 "overlap_window")})
    _, h_round = _softmax_run(**kw)
    a, b = dataclasses.asdict(h_step), dataclasses.asdict(h_round)
    for k in a:
        if k not in ("wall_time", "round_blocks", "round_shapes"):
            assert a[k] == b[k], k
    assert sum(L for _, L, _ in h_round.round_blocks) == 14
    assert h_step.round_blocks == [] and h_round.captures == 0
    assert h_step.round_shapes == 0 < h_round.round_shapes


def test_trainer_overlap_guards():
    with pytest.raises(ValueError, match="round runtime"):
        _softmax_run(runtime="step", overlap=True)
    with pytest.raises(ValueError, match="runtime"):
        _softmax_run(runtime="graph")


def test_launcher_overlap_guard():
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit, match="--runtime round"):
        main(["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--device",
              "cpu", "--runtime", "step", "--overlap"])


def test_windows_of_the_trainers_schedule():
    """ResNet-50's chip cell (T = 12, H = 4) is three rounds of one
    shape: one window of two and one of one at window 2, one program
    each; its async counterpart's distinct (length, tail mask) pairs
    are what the round runtime captures."""
    mask = np.broadcast_to(tsched.fixed_schedule(12, 4)[:, None],
                           (12, 8)).copy()
    plans = trnd.compile_rounds(mask)
    assert [p.length for p in plans] == [4, 4, 4]
    assert [len(w) for w in trnd.window_rounds(plans, 2)] == [2, 1]
    asyn = trnd.compile_rounds(tsched.async_schedule(12, 8, 4, seed=0))
    keys = {(p.length, p.mask.tobytes()) for p in asyn}
    assert 1 <= len(keys) <= len(asyn)
