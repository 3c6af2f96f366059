"""The fault runtime and resume on the card: graphed fault rounds,
restored CUDA generators, kernels on no live rows.

* a fault round graphed (``engine.make_fault_superstep``: a CUDA graph
  per repeating round shape) equals the eager fault step bit for bit,
  under ``preset:none`` (one shape, captured), a fixed one-step delay
  (the arrivals repeat with the schedule: captured) and ``preset:chaos``
  (mostly first sightings, run directly);
* the trainer's round runtime resumed from a full snapshot restores the
  CUDA generator whose state the graphs advanced: its final state and
  its next draws equal the uninterrupted run's;
* each compression kernel called on zero rows (a fleet with every
  worker dead) returns at once without a launch, and an all-dead fault
  round launches nothing.

All cases need the card (``pytest -m gpu tests/test_torch_fault_graphs.py``);
the CPU holds the same round bodies eagerly in ``test_torch_faults.py``
and ``test_torch_resume.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import engine, operators as ops, scenarios as scn
from repro_torch.core import schedule as sched
from repro_torch.data.synthetic import mnist_like, worker_batches
from repro_torch.kernels import qsgd, topk_compress as tk
from repro_torch.kernels.dispatch import DispatchConfig
from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
from repro_torch.models import softmax as tsoft
from repro_torch.optim import inverse_time, momentum_sgd
from repro_torch.train import RunConfig, checkpoint, train
from repro_torch.tree import tree_leaves, value_and_grad

R, T, H = 4, 16, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _grad():
    cfg = tsoft.SoftmaxConfig()
    return cfg, value_and_grad(lambda p, b: tsoft.loss_fn(p, b, cfg)[0])


def _batches(steps=T):
    x, y = mnist_like(256, seed=0)
    return list(worker_batches(x, y, R, 8, steps, seed=0))


def _equal_states(a, b):
    for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def _fault_pair(dev, spec, op):
    cfg, grad = _grad()
    params = tsoft.init_params(cfg, device=dev)
    mask = np.broadcast_to(sched.fixed_schedule(T, H)[:, None], (T, R))
    tables = spec.tables(T, R)
    kw = dict(queue_depth=spec.depth, dispatch=DispatchConfig(mode="kernel"),
              global_rounds=True, staleness_weight="damped")
    out = []
    for make, drive in ((engine.make_fault_step, engine.run_faults),
                        (engine.make_fault_superstep,
                         engine.run_fault_rounds)):
        reset_launches()
        st = engine.init(params, momentum_sgd(0.9), R, device=dev,
                         queue_depth=spec.depth)
        fn = make(grad, momentum_sgd(0.9), op, inverse_time(1.0, 10.0), R,
                  **kw)
        st, losses = drive(st, fn, _batches(), mask, tables,
                           torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        out.append((st, losses, dict(LAUNCHES), fn))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("spec,captured", [
    ("preset:none", True), ("min_delay=1,max_delay=1", True),
    ("preset:chaos", None)])
@pytest.mark.parametrize("op_name", ["topk", "qsgd"])
def test_fault_round_graphs_match_fault_steps(cuda, spec, captured,
                                              op_name):
    op = {"topk": ops.TopK(k=0.05), "qsgd": ops.QSGDQuantizer(s=15)}[op_name]
    (a, la, na, _), (b, lb, nb, sup) = _fault_pair(
        cuda, scn.parse_faults(spec), op)
    _equal_states(a, b)
    assert la == lb and na == nb and sum(na.values()) > 0
    assert sup.runner.graphed and sup.shapes >= 1
    if captured:
        assert sup.captures >= 1


@pytest.mark.gpu
def test_resume_restores_the_cuda_generator(cuda, tmp_path):
    """QSGD draws every sync inside the round graphs: the snapshot's
    generator state is the one the replays advanced."""
    cfg, grad = _grad()
    d = str(tmp_path / "ck")
    x, y = mnist_like(256, seed=0)

    def run(**kw):
        rng = torch.Generator(device=cuda).manual_seed(0)
        st, h = train(grad, tsoft.init_params(cfg, device=cuda),
                      momentum_sgd(0.9), ops.QSGDQuantizer(s=15),
                      inverse_time(1.0, 10.0),
                      worker_batches(x, y, R, 8, 24, seed=0),
                      RunConfig(total_steps=24, R=R, H=2, log_every=1,
                                ckpt_dir=d, faults="min_delay=1,max_delay=1",
                                **kw),
                      smooth=1, device=cuda, rng=rng)
        return st, h, rng

    sa, ha, ga = run(ckpt_every=6)
    assert ha.captures >= 1
    fulls = sorted(int(n.rsplit("_", 1)[1]) for n in os.listdir(d)
                   if n.startswith("full_step_"))
    for n in fulls[2:]:
        shutil.rmtree(os.path.join(d, f"full_step_{n}"))
    start = checkpoint.latest_full(d)
    sb, hb, gb = run(resume=True)
    _equal_states(sa, sb)
    k = ha.steps.index(start + 1)
    assert ha.loss[k:] == hb.loss and ha.bits[k:] == hb.bits
    assert torch.equal(torch.rand(8, generator=ga, device=cuda),
                       torch.rand(8, generator=gb, device=cuda))


@pytest.mark.gpu
def test_kernels_on_no_live_rows(cuda):
    before = dict(LAUNCHES)
    acc = torch.empty((0, 4096), device=cuda)
    sel, mem, cnt = tk.topk_compress(acc, 40)
    assert sel.shape == mem.shape == (0, 4096) and cnt.shape == (0,)
    idx, val, mem, cnt = tk.topk_compact(acc, 40, 64)
    assert idx.shape == val.shape == (0, 64)
    assert qsgd.qsgd_quantize(acc, acc, 15).shape == (0, 4096)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == before
    dead = scn.FaultSpec(crash=tuple((r, 0, T + 1) for r in range(R)))
    (a, _, na, _), (b, _, nb, _) = _fault_pair(cuda, dead, ops.TopK(k=0.05))
    _equal_states(a, b)
    assert sum(na.values()) == sum(nb.values()) == 0
    assert float(a.bits) == 0.0 and a.rounds == 0
