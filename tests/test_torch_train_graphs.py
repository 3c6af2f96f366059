"""The training round runtime on the card: each round a CUDA graph.

``engine.make_superstep`` captures one graph per round shape (length,
tail mask) and replays it with the state updated in place; the trainer
and the LM launcher run it by default (``runtime="round"``).  Here the
graphed runs are held to the eager ``runtime="step"`` runs in one
process, bit for bit: states, ledgers, losses and the kernel launch
counts.  Each case would catch one way a capture can go wrong:

* a learning rate baked in at capture (``inverse_time`` changes every
  step, so a replay with the capture step's rate drifts at once);
* an unregistered generator (QSGD draws every sync: a replay that does
  not advance the generator repeats the capture's draws);
* graphs of one pool replayed out of capture order (two round lengths
  alternate);
* host values of the optimizer (Adam's bias corrections).

All cases need the card (``pytest -m gpu tests/test_torch_train_graphs.py``);
the CPU runs the same round bodies eagerly in ``test_torch_rounds.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine, operators as ops, schedule as sched
from repro_torch.data.synthetic import mnist_like, worker_batches
from repro_torch.kernels.dispatch import DispatchConfig
from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
from repro_torch.models import softmax as tsoft
from repro_torch.optim import adam, inverse_time, momentum_sgd
from repro_torch.train.trainer import RunConfig, train
from repro_torch.tree import tree_leaves, value_and_grad

R, T = 3, 12


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
    assert a.step == b.step and a.rounds == b.rounds
    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:   # host ints, and the int arrays of a count a worker
            np.testing.assert_array_equal(x, y)


def _captures_of(mask) -> int:
    """Round shapes that run at least twice: the graphs captured (a
    shape's first call runs eagerly, its second captures)."""
    from repro_torch.core import rounds as rnd
    seen: dict = {}
    for p in rnd.compile_rounds(mask):
        key = (p.length, np.asarray(p.mask).tobytes())
        seen[key] = seen.get(key, 0) + 1
    return sum(n >= 2 for n in seen.values())


def _engine_pair(dev, op, opt, mask, rng_seed=3, max_programs=None):
    """(step-runtime run, round-runtime run, launches of each, superstep)."""
    cfg, grad = _grad()
    params = tsoft.init_params(cfg, device=dev)
    lr = inverse_time(1.0, 10.0)
    kw = dict(dispatch=DispatchConfig(mode="kernel"), global_rounds=False,
              leaf_ledger=True)
    batches = _batches(mask.shape[0])
    out = []
    for make, drive in ((engine.make_step, engine.run),
                        (engine.make_superstep, engine.run_rounds)):
        reset_launches()
        st = engine.init(params, opt, R, leaf_ledger=True, device=dev)
        fn = make(grad, opt, op, lr, R, **kw)
        if max_programs is not None and make is engine.make_superstep:
            fn.runner.max_programs = max_programs
        st, losses = drive(st, fn, batches, mask,
                           torch.Generator(device=dev).manual_seed(rng_seed))
        torch.cuda.synchronize()
        out.append((st, losses, dict(LAUNCHES), fn))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("op_name", ["topk", "qsgd"])
@pytest.mark.parametrize("opt_name", ["momentum", "adam"])
def test_round_graphs_match_steps(cuda, op_name, opt_name):
    op = {"topk": ops.TopK(k=0.05), "qsgd": ops.QSGDQuantizer(s=15)}[op_name]
    opt = {"momentum": momentum_sgd(0.9), "adam": adam()}[opt_name]
    fixed = np.broadcast_to(sched.fixed_schedule(T, 4)[:, None],
                            (T, R)).copy()
    (a, la, na, _), (b, lb, nb, sup) = _engine_pair(cuda, op, opt, fixed)
    _equal_states(a, b)
    assert la == lb and na == nb and sum(na.values()) > 0
    assert sup.runner.graphed and sup.runner.captures == 1


@pytest.mark.gpu
def test_two_round_shapes_alternate(cuda):
    """Lengths 2 and 3 in turn: both graphs replay between each other's
    replays, from one pool."""
    sync = np.zeros(15, bool)
    sync[[1, 4, 6, 9, 11, 14]] = True
    mask = np.broadcast_to(sync[:, None], (15, R)).copy()
    (a, la, na, _), (b, lb, nb, sup) = _engine_pair(
        cuda, ops.QSGDQuantizer(s=15), momentum_sgd(0.9), mask)
    _equal_states(a, b)
    assert la == lb and na == nb
    assert sup.runner.captures == _captures_of(mask) == 2


@pytest.mark.gpu
def test_async_schedule_captures_per_tail_mask(cuda):
    mask = sched.async_schedule(T, R, 3, seed=4)
    (a, la, na, _), (b, lb, nb, sup) = _engine_pair(
        cuda, ops.TopK(k=0.05), momentum_sgd(0.9), mask)
    _equal_states(a, b)
    assert la == lb and na == nb
    assert sup.runner.captures == _captures_of(mask)


@pytest.mark.gpu
def test_shapes_past_the_program_bound_run_directly(cuda):
    """With room for one program, the async schedule's other repeated
    tail masks run through the step directly, on the runner's stream,
    between the one graph's replays."""
    mask = sched.async_schedule(2 * T, R, 3, seed=4)
    (a, la, na, _), (b, lb, nb, sup) = _engine_pair(
        cuda, ops.QSGDQuantizer(s=15), momentum_sgd(0.9), mask,
        max_programs=1)
    _equal_states(a, b)
    assert la == lb and na == nb
    assert _captures_of(mask) > 1 and sup.captures == 1


@pytest.mark.gpu
def test_uniforms_feed_and_another_generator_raise(cuda):
    cfg, grad = _grad()
    st = engine.init(tsoft.init_params(cfg, device=cuda), momentum_sgd(0.9),
                     R, device=cuda)
    sup = engine.make_superstep(grad, momentum_sgd(0.9),
                                ops.QSGDQuantizer(s=15),
                                inverse_time(1.0, 10.0), R)
    block = engine.stack_block(_batches(2))
    with pytest.raises(ValueError, match="Uniforms"):
        sup(st, block, True, ops.Uniforms([np.zeros(10, np.float32)]))
    # a captured graph advances the generator it registered, no other
    g = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(2):
        st, _ = sup(st, block, True, g)
    with pytest.raises(ValueError, match="generator"):
        sup(st, block, True, torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
def test_trainer_history_graphed_matches_steps(cuda, overlap):
    cfg, grad = _grad()
    hist = {}
    for runtime in ("step", "round"):
        st, h = train(grad, tsoft.init_params(cfg, device=cuda),
                      momentum_sgd(0.9), ops.QSGDQuantizer(s=15),
                      inverse_time(1.0, 10.0), _batches(),
                      RunConfig(total_steps=T, R=R, H=2 if overlap else 4,
                                log_every=1,
                                leaf_ledger=True, runtime=runtime,
                                overlap=overlap and runtime == "round",
                                overlap_window=2),
                      device=cuda)
        hist[runtime] = (h.loss, h.bits, h.bits_down, h.rounds, h.leaf_bits,
                         h.leaf_bits_down)
        if runtime == "round":
            # H = 4: three rounds of one shape; overlap at H = 2: three
            # windows of two rounds of one shape
            assert h.captures == 1
    assert hist["step"] == hist["round"]


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["dense_psum", "sparse_allgather"])
def test_launcher_graphed_matches_steps(cuda, tmp_path, wire):
    import json
    from repro_torch.launch.train import main
    recs = {}
    for runtime in ("step", "round"):
        out = tmp_path / f"{runtime}.json"
        main(["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--steps",
              "8", "--H", "2", "--policy", "preset:arch", "--wire", wire,
              "--runtime", runtime, "--json", str(out)])
        recs[runtime] = json.load(open(out))
    for k in ("loss", "kind", "bits_up", "bits_down", "launches_per_sync"):
        assert recs["step"][k] == recs["round"][k], k
    assert recs["round"]["captures"] == 1
