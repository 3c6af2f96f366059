"""The mesh fault runtime (``core/distributed.py``'s
``make_dist_fault_steps`` / ``make_dist_fault_round``; DESIGN.md §9) at
four gloo ranks on the CPU, and the launcher's ``--faults``.

``repro``'s multi-device code does not run on this jax, so the reference
is ``repro``'s single-process ``engine.make_fault_step`` on the column
Top_k regression of ``tests/test_torch_distributed.py`` (``rounds``
counted as landing events, as the mesh counts them), under
``preset:chaos`` at R = 4 (worker 1 down for steps 2-4, random delays,
drops and one more outage) and, for Adam's per-worker counts, a crash
with an identity uplink:

* against ``repro``: losses rtol 2e-5, both ledgers and ``rounds``
  exact, master, iterates and views rtol 1e-4 / atol 1e-5 (the
  tolerances of ``assert_matches_reference``; the ranks sum a mean in
  another order than one process);
* port-only: the fault round equals the fault steps bit for bit,
  ``preset:none`` equals ``make_dist_steps`` bit for bit, and the two
  wires agree (bits exact, master rtol 1e-5).

One spawn of four ranks a wire; each rank runs every variant and
imports no JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh, run_local_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH_CODE = r"""
import numpy as np
import torch
from repro_torch.core import distributed as D
from repro_torch.core import engine as E, rounds as rnd, scenarios as scn
from repro_torch.core.engine import stack_block
from repro_torch.optim import adam, constant, sgd
from repro_torch.tree import value_and_grad

D_IN, D_OUT, STEPS, H, RANKS, LR = 16, 8, 16, 4, 4, 0.1
SPECS = {"w": (None, "model"), "b": ("model",)}
#: (name, fault spec, staleness weighting, aggregate, optimizer)
CELLS = [("chaos-uniform-mean_R", "preset:chaos", "uniform", "mean_R", "sgd"),
         ("chaos-damped-mean_S", "preset:chaos", "damped", "mean_S", "sgd"),
         ("chaos-uniform-support_weighted", "preset:chaos", "uniform",
          "support_weighted", "sgd"),
         ("crash-adam", "crash=1@2-6+3@5-9", "uniform", "mean_R", "adam")]


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


def base_mask():
    return np.array([(t + 1) % H == 0 or t == STEPS - 1
                     for t in range(STEPS)])


def fault_rows(spec):
    tables = scn.parse_faults(spec).tables(STEPS, RANKS)
    return tables, E.fault_rows(base_mask(), tables, RANKS)


def record(state, losses):
    return dict(losses=np.array(losses), bits=float(state.bits),
                bits_down=float(state.bits_down), rounds=state.rounds,
                w=state.master["w"].numpy(), b=state.master["b"].numpy(),
                local=state.local["w"].numpy(), view=state.view["w"].numpy(),
                memory=state.memory["w"].numpy(),
                arrive_at=state.arrive_at, tau=state.inflight_tau)


def run_faults(mesh, wire, cell, rounds=False):
    # this rank's fault run: per-step losses, ledgers, master, its own
    # worker's iterate, view and memory, the host tags
    _, spec, weight, agg, opt = cell
    tables, rows = fault_rows(spec)
    inner = adam() if opt == "adam" else sgd()
    comp = (D.ShardCompressor("none") if opt == "adam"
            else D.ShardCompressor("topk", 0.25, dispatch="kernel"))
    args = (grad_fn(), inner, comp, constant(LR), mesh, ("data",), SPECS)
    kw = dict(queue_depth=scn.parse_faults(spec).depth, aggregate=agg,
              wire=wire, staleness_weight=weight)
    data = [(x[mesh.rank], y[mesh.rank]) for x, y in regression_data()]
    losses = []
    if rounds:
        init, fn, _ = D.make_dist_fault_round(*args, **kw)
        state = init(init_params())
        for plan in rnd.compile_fault_rounds(rows.sync, tables):
            sl = slice(plan.start, plan.start + plan.length)
            state, ls = fn(state, stack_block(data[sl]),
                           E.index_rows(rows, sl))
            losses += ls.tolist()
    else:
        init, local, sync = D.make_dist_fault_steps(*args, **kw)
        state = init(init_params())
        _, _, events = scn.fault_replay(rows.sync, tables)
        for t, (x, y) in enumerate(data):
            step = sync if events[t] else local
            state, loss = step(state, (torch.from_numpy(x),
                                       torch.from_numpy(y)),
                               E.index_rows(rows, t))
            losses.append(float(loss))
    out = record(state, losses)
    if opt == "adam":
        out["count"] = np.asarray(state.inner["count"])
    return out


def run_plain(mesh, wire):
    # make_dist_steps on the fixed schedule, the fault-free reference
    args = (grad_fn(), sgd(), D.ShardCompressor("topk", 0.25,
                                                dispatch="kernel"),
            constant(LR), mesh, ("data",), SPECS)
    init, local, sync = D.make_dist_steps(*args, wire=wire)
    state = init(init_params())
    losses = []
    for t, (x, y) in enumerate(regression_data()):
        step = sync if base_mask()[t] else local
        state, loss = step(state, (torch.from_numpy(x[mesh.rank]),
                                   torch.from_numpy(y[mesh.rank])))
        losses.append(float(loss))
    return dict(losses=np.array(losses), bits=float(state.bits),
                bits_down=float(state.bits_down), rounds=state.rounds,
                w=state.master["w"].numpy(), b=state.master["b"].numpy(),
                local=state.local["w"].numpy())


def run_all(mesh, wire):
    out = {}
    for cell in CELLS:
        for k, v in run_faults(mesh, wire, cell).items():
            out[f"steps/{cell[0]}/{k}"] = v
    for cell in (CELLS[1], CELLS[3]):
        for k, v in run_faults(mesh, wire, cell, rounds=True).items():
            out[f"rounds/{cell[0]}/{k}"] = v
    for k, v in run_faults(mesh, wire, ("none", "preset:none", "uniform",
                                        "mean_R", "sgd")).items():
        out[f"none/{k}"] = v
    for k, v in run_plain(mesh, wire).items():
        out[f"plain/{k}"] = v
    return out
"""
exec(MESH_CODE)

RANK_SCRIPT = MESH_CODE + r"""
import sys
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh("4x1", device="cpu")
try:
    np.savez(sys.argv[2] + f"_{mesh.rank}.npz", **run_all(mesh, sys.argv[1]))
finally:
    mesh.close()
"""

WIRES = ("dense_psum", "sparse_allgather")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{wire: [rank 0..3 results]}: one spawn of four ranks a wire."""
    tmp = tmp_path_factory.mktemp("dist_faults")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    # one thread a rank: the ranks' tensors are tiny, and the test run's
    # other workers share the cores
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = {}
    for wire in WIRES:
        ranks = run_local_ranks(
            [sys.executable, str(script), wire, str(tmp / wire)], RANKS,
            env=env, timeout=300)
        for rc, _stdout, stderr in ranks:
            assert rc == 0, stderr[-3000:]
        out[wire] = []
        for r in range(RANKS):
            with np.load(tmp / f"{wire}_{r}.npz") as f:
                out[wire].append(dict(f))
    return out


def _cell(run: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in run.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def repro_runs():
    """``repro``'s single-process fault engine on every cell: (state,
    losses) with the engine's per-worker rows."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import distributed as jd
    from repro.core import engine as jeng, operators as jops
    from repro.core import scenarios as jscn
    from repro.optim import adam as jadam, constant as jconst, sgd as jsgd

    def grad_j(p, batch):
        x, y = batch
        return jax.value_and_grad(
            lambda pp: jnp.mean((x @ pp["w"] + pp["b"] - y) ** 2))(p)

    class ColTopK(jops.CompressionOp):
        """``ShardCompressor("topk", 0.25)`` under SPECS: Top_k along
        axis 0 of w (its model-sharded axis 1 is kept), b dense."""

        def __call__(self, key, x):
            if x.size <= 8:
                return x.astype(jnp.float32), jnp.float32(32 * x.size)
            return jd.axis_topk(x, 0.25, 0)

        def gamma(self, d):
            return 0.25

    data = [(jnp.asarray(x), jnp.asarray(y)) for x, y in regression_data()]
    out = {}
    for name, spec, weight, agg, opt in CELLS:
        jspec = jscn.parse_faults(spec)
        inner = jadam() if opt == "adam" else jsgd()
        op = jops.Identity() if opt == "adam" else ColTopK()
        state = jeng.init({"w": jnp.zeros((D_IN, D_OUT)),
                           "b": jnp.zeros((D_OUT,))}, inner, RANKS,
                          queue_depth=jspec.depth)
        step = jeng.make_fault_step(grad_j, inner, op, jconst(LR), RANKS,
                                    queue_depth=jspec.depth,
                                    global_rounds=True, aggregate=agg,
                                    staleness_weight=weight)
        out[name] = jeng.run_faults(state, step, data, base_mask(),
                                    jspec.tables(STEPS, RANKS),
                                    jax.random.PRNGKey(0))
    return out


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_mesh_faults_match_repro_engine(mesh_runs, repro_runs, wire, cell):
    state, losses = repro_runs[cell]
    tables, _ = fault_rows(dict((c[0], c[1]) for c in CELLS)[cell])
    assert not tables.alive.all() and tables.recover.any()
    for r, run in enumerate(mesh_runs[wire]):
        got = _cell(run, f"steps/{cell}/")
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5,
                                   atol=2e-5)
        assert float(got["bits"]) == float(state.bits) > 0
        assert float(got["bits_down"]) == float(state.bits_down)
        assert int(got["rounds"]) == int(state.rounds)
        np.testing.assert_array_equal(got["arrive_at"],
                                      np.asarray(state.arrive_at))
        np.testing.assert_array_equal(got["tau"],
                                      np.asarray(state.inflight_tau))
        for key, want in (("w", state.master["w"]),
                          ("b", state.master["b"]),
                          ("local", state.local["w"][r]),
                          ("view", state.master_view["w"][r]),
                          ("memory", state.memory["w"][r])):
            np.testing.assert_allclose(got[key], np.asarray(want),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
        if "count" in got:
            # Adam's count is the rank's own: frozen while down, reset
            # on recovery
            assert int(got["count"]) == int(state.inner["count"][r])
    if "count" in _cell(mesh_runs[wire][0], f"steps/{cell}/"):
        assert len({int(run[f"steps/{cell}/count"])
                    for run in mesh_runs[wire]}) > 1


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("cell", [CELLS[1][0], CELLS[3][0]])
def test_mesh_fault_round_equals_steps(mesh_runs, wire, cell):
    for run in mesh_runs[wire]:
        steps = _cell(run, f"steps/{cell}/")
        rounds = _cell(run, f"rounds/{cell}/")
        assert steps.keys() == rounds.keys()
        for k in steps:
            np.testing.assert_array_equal(rounds[k], steps[k], err_msg=k)


@pytest.mark.parametrize("wire", WIRES)
def test_mesh_trivial_faults_equal_plain_steps(mesh_runs, wire):
    for run in mesh_runs[wire]:
        none, plain = _cell(run, "none/"), _cell(run, "plain/")
        for k in plain:
            np.testing.assert_array_equal(none[k], plain[k], err_msg=k)


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_mesh_fault_wires_agree(mesh_runs, cell):
    for dense, sparse in zip(mesh_runs["dense_psum"],
                             mesh_runs["sparse_allgather"]):
        d, s = _cell(dense, f"steps/{cell}/"), _cell(sparse, f"steps/{cell}/")
        for k in ("bits", "bits_down", "rounds", "arrive_at", "tau"):
            np.testing.assert_array_equal(s[k], d[k], err_msg=k)
        np.testing.assert_allclose(s["losses"], d["losses"], rtol=2e-6,
                                   atol=0)
        for k in ("w", "b", "local", "view", "memory"):
            np.testing.assert_allclose(s[k], d[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# in this process: refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,words", [
    (dict(queue_depth=0), "queue_depth must be >= 1"),
    (dict(queue_depth=2, zero1=True), "zero1 master sharding is not "
     "supported under faults"),
    (dict(queue_depth=2, downlink="topk"), "a compressed downlink is not "
     "supported under faults on the mesh engine"),
    (dict(queue_depth=2, staleness_weight="linear"), "staleness"),
])
def test_fault_steps_refuse_as_repro(kw, words):
    from repro_torch.core import distributed as D
    if kw.get("downlink") == "topk":
        kw = dict(kw, downlink=D.ShardCompressor("topk", 0.1))
    mesh = Mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match=words):
        D.make_dist_fault_steps(grad_fn(), sgd(), None, constant(LR), mesh,
                                ("data",), SPECS, **kw)


def test_fault_local_step_refuses_an_event_step():
    from repro_torch.core import distributed as D
    mesh = Mesh((1, 1), ("data", "model"))
    rows = E.fault_rows(base_mask(), scn.FaultSpec().tables(STEPS, 1), 1)
    init, local, _ = D.make_dist_fault_steps(
        grad_fn(), sgd(), None, constant(LR), mesh, ("data",), SPECS,
        queue_depth=1)
    x, y = regression_data()[0]
    batch = (torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    with pytest.raises(ValueError, match="event step"):
        local(init(init_params()), batch, E.index_rows(rows, H - 1))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--device",
          "cpu", "--steps", "6", "--H", "2", "--seq", "16"]


@pytest.fixture
def few_threads():
    """Two intra-op threads while the launcher runs in this process (the
    smoke model's matmuls are small; the test run's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("wire", WIRES)
def test_launcher_faults_round_equals_step(capsys, few_threads, wire):
    """``--faults`` with repro's log lines; ``--runtime round`` (the
    fault round) and ``--runtime step`` give the same record."""
    from repro_torch.launch import train as launch
    argv = LAUNCH + ["--wire", wire, "--faults", "preset:chaos",
                     "--fault-seed", "5", "--staleness-weight", "damped",
                     "--policy", "preset:arch"]
    rec_r = launch.main(argv)
    out = capsys.readouterr().out
    assert "faults: max_delay=3,drop=0.05,crash=1@2-5," in out
    assert "(queue depth 4, " in out and "weighting damped)" in out
    assert "runtime: fault round (fused)" in out
    rec_s = launch.main(argv + ["--runtime", "step"])
    for k in ("loss", "kind", "bits_up", "bits_down", "launches_per_sync",
              "rounds"):
        assert rec_r[k] == rec_s[k], k
    assert rec_r["kind"].count("sync") >= 3


@pytest.mark.parametrize("extra,words", [
    (["--zero1"], "--faults does not support --zero1"),
    (["--policy", "topk:k=0.01 >> topk:k=0.05"],
     "--faults does not support a compressed downlink"),
    (["--overlap"], "--overlap is unsupported with --faults"),
])
def test_launcher_refuses_as_repro(extra, words):
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit, match=words):
        launch.main(LAUNCH + ["--faults", "preset:lossy"] + extra)
