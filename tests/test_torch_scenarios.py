"""Fleet scenarios (DESIGN.md §8): the port's ``core/scenarios.py`` (a
numpy copy) against ``repro``'s, the trainer under a scenario against
``repro``'s ``History``, and partial participation on the mesh (the
launcher's ``--scenario``: ``test_torch_launch_train.py``).

* masks, spec strings, diagnostics, fault tables, ``fault_replay`` and
  ``rounds.compile_fault_rounds`` equal ``repro``'s element for element
  on every preset and a small grid (both draw from
  ``np.random.RandomState``);
* the trainer under ``flaky_fleet`` / ``mean_S``: steps, bits and
  rounds exact, smoothed losses to rtol 1e-4 (XLA's fused multiply-adds
  over a few steps), the round runtime equal to the step runtime;
* the distributed engine with ``partial=True`` at four gloo ranks (one
  spawn: both wires x ``mean_S`` / ``support_weighted``, and the round
  runtime) against the single-process engine on the same mask, as
  ``test_torch_distributed.py`` holds it (losses rtol 2e-5, masters rtol
  1e-4 / atol 1e-5, ledgers exact): ``repro``'s multi-device tests do
  not run on this jax.
"""

import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro.core import rounds as jrnd, scenarios as jscn
from repro.data import worker_batches as j_batches
from repro.models import softmax as jsoft
from repro.optim import inverse_time as j_inverse_time, sgd as j_sgd
from repro.train import RunConfig as JRun, train as jtrain
from repro_torch.core import distributed as D
from repro_torch.core import engine as teng, operators as tops
from repro_torch.core import rounds as trnd, scenarios as scn
from repro_torch.core.operators import CompressionOp
from repro_torch.data import mnist_like, worker_batches
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.models import softmax as tsoft
from repro_torch.optim import constant, inverse_time, sgd
from repro_torch.train import RunConfig, train
from repro_torch.tree import value_and_grad
from strategies import FAULT_GRID, SCENARIO_GRID

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the presets and ``tests/strategies.py``'s SCENARIO_GRID / FAULT_GRID,
#: by their spec strings (the two packages' dataclasses are distinct
#: types)
SPECS = [f"preset:{n}" for n in sorted(scn.PRESETS)] + [
    "participation=0.8,seed=3", "dropout_mid_round=0.2,seed=4",
    "straggler_frac=0.5,straggler_stale_rounds=2,seed=5",
    "hetero_H=1-6,seed=6"]
FAULTS = [f"preset:{n}" for n in sorted(scn.FAULT_PRESETS)] + [
    "max_delay=2,seed=1", "max_delay=3,min_delay=1,seed=2",
    "max_delay=2,drop=0.25,seed=3", "crash=0@2-6+2@5-9",
    "max_delay=2,crash_rate=0.08,mean_outage=3.0,seed=4"]


@pytest.mark.parametrize("spec", SPECS)
def test_scenario_masks_match_repro(spec):
    t, j = scn.parse(spec), jscn.parse(spec)
    assert t.to_string() == j.to_string()
    assert scn.parse(t.to_string() or "seed=0") == t or not t.to_string()
    for T, R, H in ((24, 4, 3), (17, 8, 1), (40, 3, 5)):
        mt, mj = t.mask(T, R, H), j.mask(T, R, H)
        np.testing.assert_array_equal(mt, mj)
        assert scn.is_partial(mt) == jscn.is_partial(mj)
        assert scn.participation_of(mt) == jscn.participation_of(mj)
        for agg in scn.AGGREGATES:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert scn.warn_if_biased(mt, agg) == \
                    jscn.warn_if_biased(mj, agg)


@pytest.mark.parametrize("spec", FAULTS)
def test_fault_tables_match_repro(spec):
    t, j = scn.parse_faults(spec), jscn.parse_faults(spec)
    assert t.to_string() == j.to_string() and t.depth == j.depth
    mask = scn.PRESETS["flaky_fleet"].mask(30, 4, 3)
    for T, R in ((30, 4), (12, 6)):
        tt, tj = t.tables(T, R), j.tables(T, R)
        for a, b in zip(tt, tj):
            np.testing.assert_array_equal(a, b)
        assert tt.depth == tj.depth and tt.trivial == tj.trivial
    tt, tj = t.tables(30, 4), j.tables(30, 4)
    for a, b in zip(scn.fault_replay(mask, tt), jscn.fault_replay(mask, tj)):
        np.testing.assert_array_equal(a, b)
    extra = [3, 11, 29]
    for ev in (None, extra):
        pt = trnd.compile_fault_rounds(mask, tt, extra_events=ev)
        pj = jrnd.compile_fault_rounds(mask, tj, extra_events=ev)
        assert [(p.start, p.length) for p in pt] == \
            [(p.start, p.length) for p in pj]
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.mask, b.mask)


def test_spec_surfaces_match_repro():
    """Parsing, refusals and the mask-layer failure injections."""
    assert SPECS[len(scn.PRESETS):] == [x.to_string()
                                        for x in SCENARIO_GRID[1:-1]]
    assert FAULTS[len(scn.FAULT_PRESETS):] == [x.to_string()
                                               for x in FAULT_GRID[1:-1]]
    assert sorted(scn.PRESETS) == sorted(jscn.PRESETS)
    assert sorted(scn.FAULT_PRESETS) == sorted(jscn.FAULT_PRESETS)
    for bad in ("nope=1", "preset:nope", "participation"):
        with pytest.raises((KeyError, ValueError)):
            scn.parse(bad)
        with pytest.raises((KeyError, ValueError)):
            scn.parse_faults(bad)
    with pytest.raises(ValueError):
        scn.validate_aggregate("dense_psum")
    with pytest.raises(ValueError):
        scn.validate_staleness_weight("inverse")
    assert scn.STALENESS_WEIGHTS == jscn.STALENESS_WEIGHTS
    assert scn.AGGREGATES == jscn.AGGREGATES == teng.AGGREGATES \
        == D.AGGREGATES
    crash = "max_delay=2,crash=0@1-4+2@3-9,seed=5"
    assert scn.parse_faults(crash).to_string() == \
        jscn.parse_faults(crash).to_string()
    m = scn.Scenario().mask(12, 3, 4)
    np.testing.assert_array_equal(scn.inject_dropout(m, 1, 3),
                                  jscn.inject_dropout(m, 1, 3))
    np.testing.assert_array_equal(scn.defer_sync(m, 2, 7, 9),
                                  jscn.defer_sync(m, 2, 7, 9))
    with pytest.raises(ValueError):
        scn.inject_dropout(m, 0, 0)


# ---------------------------------------------------------------------------
# the trainer under a scenario
# ---------------------------------------------------------------------------


def test_trainer_scenario_matches_repro():
    R, T, b, n = 4, 16, 8, 400
    x, y = mnist_like(n, seed=0)
    kw = dict(total_steps=T, R=R, H=3, log_every=4,
              scenario="preset:flaky_fleet", aggregate="mean_S")
    cfg_j = jsoft.SoftmaxConfig(l2=1.0 / n)

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jsoft.loss_fn(pp, batch, cfg_j)[0])(p)

    _, hj = jtrain(grad_j, jsoft.init_params(jax.random.PRNGKey(0), cfg_j),
                   j_sgd(), jops.TopK(k=0.05), j_inverse_time(60.0, 100.0),
                   j_batches(x, y, R, b, T, seed=1),
                   JRun(runtime="step", **kw))
    cfg_t = tsoft.SoftmaxConfig(l2=1.0 / n)
    grad_t = value_and_grad(lambda p, batch: tsoft.loss_fn(p, batch,
                                                           cfg_t)[0])
    hists = {}
    for runtime in ("round", "step"):
        _, hists[runtime] = train(
            grad_t, tsoft.init_params(cfg_t, device="cpu"), sgd(),
            tops.TopK(k=0.05), inverse_time(60.0, 100.0),
            worker_batches(x, y, R, b, T, seed=1),
            RunConfig(runtime=runtime, **kw), device="cpu")
    ht = hists["round"]
    for f in ("steps", "loss", "bits", "bits_down", "rounds"):
        assert getattr(ht, f) == getattr(hists["step"], f), f
    assert ht.steps == hj.steps and ht.rounds == hj.rounds
    assert ht.bits == hj.bits and ht.bits_down == hj.bits_down
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-4)
    mask = scn.parse("preset:flaky_fleet").mask(T, R, 3)
    assert [n for _, _, n in ht.round_blocks] == [
        int(r.sum()) for r in mask if r.any()] + (
        [0] if not mask[-1].any() else [])
    with pytest.raises(ValueError, match="mutually exclusive"):
        train(grad_t, tsoft.init_params(cfg_t, device="cpu"), sgd(),
              tops.TopK(k=0.05), inverse_time(60.0, 100.0), [],
              RunConfig(asynchronous=True, **kw), device="cpu")


# ---------------------------------------------------------------------------
# partial participation on the mesh, four gloo ranks
# ---------------------------------------------------------------------------

#: the rank side of the mesh test, run by each spawned rank and
#: exec'd here for the engine side (the ranks import no JAX)
MESH_CODE = r"""
import numpy as np
import torch
from repro_torch.core import distributed as D
from repro_torch.core import scenarios as scn
from repro_torch.core.engine import round_calls
from repro_torch.optim import constant, sgd
from repro_torch.tree import value_and_grad

D_IN, D_OUT, STEPS, H, RANKS = 16, 8, 8, 2, 4
SCENARIO = "participation=0.6,seed=3"
CELLS = [("dense_psum", "mean_S"), ("dense_psum", "support_weighted"),
         ("sparse_allgather", "mean_S"),
         ("sparse_allgather", "support_weighted")]


def regression_data():
    rng = np.random.RandomState(0)
    w_true = rng.randn(D_IN, D_OUT).astype(np.float32)
    xs = [rng.randn(RANKS, 16, D_IN).astype(np.float32)
          for _ in range(STEPS)]
    return [(x, x @ w_true) for x in xs]


def grad_fn():
    return value_and_grad(
        lambda p, b: ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean())


def init_params():
    return {"w": torch.zeros(D_IN, D_OUT), "b": torch.zeros(D_OUT)}


def run_mesh(mesh, wire, agg, rounds=False):
    # this rank's partial-participation run: per-step losses, ledgers,
    # rounds, the master and this worker's iterate and view
    mask = scn.parse(SCENARIO).mask(STEPS, RANKS, H)
    specs = {"w": (None, "model"), "b": ("model",)}
    args = (grad_fn(), sgd(), D.ShardCompressor("topk", 0.25,
                                                dispatch="kernel"),
            constant(0.1), mesh, ("data",), specs)
    kw = dict(wire=wire, aggregate=agg, partial=True)
    data = [(torch.from_numpy(x[mesh.rank]), torch.from_numpy(y[mesh.rank]))
            for x, y in regression_data()]
    losses = []
    if rounds:
        init, fn, _ = D.make_dist_multiround(*args, **kw)
        state = init(init_params())
        for _, block, tails in round_calls(data, mask):
            state, ls, _ = fn(state, block, tails=tails)
            losses += ls.reshape(-1).tolist()
    else:
        init, local, sync = D.make_dist_steps(*args, **kw)
        state = init(init_params())
        for t, b in enumerate(data):
            if mask[t].any():
                state, loss = sync(state, b, mask=mask[t])
            else:
                state, loss = local(state, b)
            losses.append(float(loss))
    return dict(losses=np.array(losses), bits=float(state.bits),
                bits_down=float(state.bits_down), rounds=state.rounds,
                w=state.master["w"].numpy(), local=state.local["w"].numpy(),
                view=state.view["w"].numpy())
"""
exec(MESH_CODE)

RANK_SCRIPT = MESH_CODE + r"""
import sys
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh("4x1", device="cpu")
try:
    out = {}
    for wire, agg in CELLS:
        for k, v in run_mesh(mesh, wire, agg).items():
            out[f"{wire}/{agg}/{k}"] = v
    for k, v in run_mesh(mesh, "sparse_allgather", "support_weighted",
                         rounds=True).items():
        out[f"rounds/{k}"] = v
    np.savez(sys.argv[1] + f"_{mesh.rank}.npz", **out)
finally:
    mesh.close()
"""


class ColTopK(CompressionOp):
    """The engine-side twin of ``ShardCompressor("topk", 0.25)`` under
    these specs: Top_k along axis 0 of ``w``, ``b`` dense."""

    def __call__(self, rng, x):
        if x.numel() <= 8:
            return x.to(torch.float32), torch.tensor(32.0 * x.numel())
        return D.axis_topk(x, 0.25, 0)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partial")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ranks = run_local_ranks([sys.executable, str(script), str(tmp / "out")],
                            RANKS, env=env, timeout=300)
    for rc, _stdout, stderr in ranks:
        assert rc == 0, stderr[-3000:]
    out = []
    for r in range(RANKS):
        with np.load(tmp / f"out_{r}.npz") as f:
            out.append(dict(f))
    return out


def engine_run(agg: str):
    mask = scn.parse(SCENARIO).mask(STEPS, RANKS, H)
    step = teng.make_step(grad_fn(), sgd(), ColTopK(), constant(0.1), RANKS,
                          global_rounds=True, aggregate=agg)
    data = [(torch.from_numpy(x), torch.from_numpy(y))
            for x, y in regression_data()]
    return teng.run(teng.init(init_params(), sgd(), RANKS, device="cpu"),
                    step,
                    data, mask)


@pytest.mark.parametrize("wire,agg", CELLS)
def test_mesh_partial_matches_engine(mesh_runs, wire, agg):
    state, losses = engine_run(agg)
    mask = scn.parse(SCENARIO).mask(STEPS, RANKS, H)
    assert scn.is_partial(mask) and not mask.any(axis=1).all()
    for r, run in enumerate(mesh_runs):
        got = {k.split("/")[-1]: v for k, v in run.items()
               if k.startswith(f"{wire}/{agg}/")}
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5,
                                   atol=2e-5)
        assert float(got["bits"]) == float(state.bits)
        assert float(got["bits_down"]) == float(state.bits_down)
        assert int(got["rounds"]) == state.rounds == int(
            mask.any(axis=1).sum())
        for key, want in (("w", state.master["w"]),
                          ("local", state.local["w"][r]),
                          ("view", state.master_view["w"][r])):
            np.testing.assert_allclose(got[key], want.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_mesh_partial_round_runtime_equals_steps(mesh_runs):
    for run in mesh_runs:
        for k in ("losses", "bits", "bits_down", "rounds", "w", "local",
                  "view"):
            np.testing.assert_array_equal(
                run[f"rounds/{k}"], run[f"sparse_allgather/support_weighted/"
                                        f"{k}"])
