"""ZeRO-1 and the compressed downlink on the mesh engine
(``core/distributed.py``'s ``zero1=True`` and ``downlink=``) at four gloo
ranks on the CPU, and the launcher's ``--zero1`` and ``'up >> down'``
policies.

``repro``'s multi-device code does not run on this jax, so the downlink's
reference is ``repro``'s single-process engine (``engine.make_step``, the
function ``qsparse`` wraps) on the column Top_k regression of
``tests/test_torch_distributed.py``, with a column Top_k downlink (k =
0.5 along w's axis 0), on the fixed schedule and under a partial
participation mask:

* against ``repro``: losses rtol 2e-5, both ledgers and ``rounds``
  exact, master, iterates, views and the server's memories rtol 1e-4 /
  atol 1e-5 (``assert_matches_reference``'s tolerances);
* port-only: ZeRO-1 equals ``zero1=False`` bit for bit on both wires,
  with and without the downlink and ``partial`` (the sync gathers the
  whole master, computes as without, and keeps its slice: no value is
  rounded differently); each rank's master shard holds 1/4 of w's
  axis 0 and the whole of b (no axis of its divides by 4 unsharded);
  the round runtime equals the steps; the wires agree (bits exact,
  master rtol 1e-5).

One spawn of four ranks a wire; each rank runs every variant and
imports no JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_local_ranks
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH_CODE = r"""
import numpy as np
import torch
from repro_torch.core import distributed as D
from repro_torch.core import scenarios as scn
from repro_torch.core.engine import round_calls
from repro_torch.optim import constant, sgd
from repro_torch.tree import value_and_grad

D_IN, D_OUT, STEPS, H, RANKS, LR = 16, 8, 12, 3, 4, 0.1
SPECS = {"w": (None, "model"), "b": ("model",)}
SCENARIO = "participation=0.6,seed=3"
#: (name, compressed downlink, partial participation)
VARIANTS = [("plain", False, False), ("down", True, False),
            ("partial", False, True), ("down_partial", True, True)]


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


def sync_mask(partial):
    if partial:
        return scn.parse(SCENARIO).mask(STEPS, RANKS, H)
    m = np.array([(t + 1) % H == 0 for t in range(STEPS)])
    return np.broadcast_to(m[:, None], (STEPS, RANKS)).copy()


def run_mesh(mesh, wire, variant, zero1, rounds=False):
    # this rank's run: losses, ledgers, the gathered master, its own
    # worker's iterate / view / server memory, its master shard shapes
    _, down, partial = variant
    args = (grad_fn(), sgd(), D.ShardCompressor("topk", 0.25,
                                                dispatch="kernel"),
            constant(LR), mesh, ("data",), SPECS)
    kw = dict(wire=wire, partial=partial, zero1=zero1,
              downlink=(D.ShardCompressor("topk", 0.5, dispatch="kernel")
                        if down else None))
    mask = sync_mask(partial)
    data = [(x[mesh.rank], y[mesh.rank]) for x, y in regression_data()]
    losses = []
    if rounds:
        init, fn, _ = D.make_dist_multiround(*args, **kw)
        state = init(init_params())
        for _, block, tails in round_calls(data, mask if partial
                                           else mask[:, 0]):
            state, ls, _ = fn(state, block,
                              tails=tails if partial else None)
            losses += ls.reshape(-1).tolist()
    else:
        init, local, sync = D.make_dist_steps(*args, **kw)
        state = init(init_params())
        for t, (x, y) in enumerate(data):
            b = (torch.from_numpy(x), torch.from_numpy(y))
            if not mask[t].any():
                state, loss = local(state, b)
            elif partial:
                state, loss = sync(state, b, mask=mask[t])
            else:
                state, loss = sync(state, b)
            losses.append(float(loss))
    full = D.gather_master(state, mesh, SPECS)
    out = dict(losses=np.array(losses), bits=float(state.bits),
               bits_down=float(state.bits_down), rounds=state.rounds,
               w=full["w"].numpy(), b=full["b"].numpy(),
               local=state.local["w"].numpy(),
               shard_w=state.master["w"].numpy(),
               shard_b=state.master["b"].numpy())
    if state.view is not None:
        out["view"] = state.view["w"].numpy()
    if state.down_memory is not None:
        out["down_memory"] = state.down_memory["w"].numpy()
    return out


def run_all(mesh, wire):
    out = {}
    for variant in VARIANTS:
        for zero1 in (False, True):
            for k, v in run_mesh(mesh, wire, variant, zero1).items():
                out[f"{variant[0]}/{int(zero1)}/{k}"] = v
    for k, v in run_mesh(mesh, wire, VARIANTS[3], True,
                         rounds=True).items():
        out[f"rounds/{k}"] = v
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
    tmp = tmp_path_factory.mktemp("dist_zero1")
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
    """``repro``'s single-process engine with the column Top_k uplink and
    downlink, on the fixed schedule and the partial mask."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import distributed as jd
    from repro.core import engine as jeng, operators as jops
    from repro.optim import constant as jconst, sgd as jsgd

    def grad_j(p, batch):
        x, y = batch
        return jax.value_and_grad(
            lambda pp: jnp.mean((x @ pp["w"] + pp["b"] - y) ** 2))(p)

    class ColTopK(jops.CompressionOp):
        """``ShardCompressor("topk", k)`` under SPECS: Top_k along axis 0
        of w, b dense."""

        def __init__(self, k):
            self.k = k

        def __call__(self, key, x):
            if x.size <= 8:
                return x.astype(jnp.float32), jnp.float32(32 * x.size)
            return jd.axis_topk(x, self.k, 0)

        def gamma(self, d):
            return self.k

    data = [(jnp.asarray(x), jnp.asarray(y)) for x, y in regression_data()]
    out = {}
    for partial in (False, True):
        params = {"w": jnp.zeros((D_IN, D_OUT)), "b": jnp.zeros((D_OUT,))}
        state = jeng.init(params, jsgd(), RANKS, downlink=ColTopK(0.5))
        step = jeng.make_step(grad_j, jsgd(), ColTopK(0.25), jconst(LR),
                              RANKS, global_rounds=True,
                              downlink=ColTopK(0.5))
        out[partial] = jeng.run(state, step, data, sync_mask(partial),
                                jax.random.PRNGKey(0))
    return out


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("partial", [False, True])
def test_mesh_downlink_matches_repro(mesh_runs, repro_runs, wire, partial):
    state, losses = repro_runs[partial]
    name = "down_partial" if partial else "down"
    for r, run in enumerate(mesh_runs[wire]):
        got = _cell(run, f"{name}/0/")
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5,
                                   atol=2e-5)
        assert float(got["bits"]) == float(state.bits) > 0
        assert float(got["bits_down"]) == float(state.bits_down) > 0
        assert int(got["rounds"]) == int(state.rounds)
        for key, want in (("w", state.master["w"]),
                          ("b", state.master["b"]),
                          ("local", state.local["w"][r]),
                          ("view", state.master_view["w"][r]),
                          ("down_memory", state.down_memory["w"][r])):
            np.testing.assert_allclose(got[key], np.asarray(want),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
    # the downlink's counted bits, not the dense broadcast's
    dense = _cell(mesh_runs[wire][0], ("partial" if partial else "plain")
                  + "/0/")
    assert float(got["bits_down"]) < float(dense["bits_down"])


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_zero1_equals_unsharded(mesh_runs, wire, variant):
    for run in mesh_runs[wire]:
        whole, z1 = _cell(run, f"{variant}/0/"), _cell(run, f"{variant}/1/")
        assert whole.keys() == z1.keys()
        for k in whole:
            if not k.startswith("shard_"):
                np.testing.assert_array_equal(z1[k], whole[k], err_msg=k)


@pytest.mark.parametrize("wire", WIRES)
def test_zero1_master_shards(mesh_runs, wire):
    for r, run in enumerate(mesh_runs[wire]):
        for variant, _, _ in VARIANTS:
            got = _cell(run, f"{variant}/1/")
            assert got["shard_w"].shape == (D_IN // RANKS, D_OUT)
            np.testing.assert_array_equal(
                got["shard_w"], got["w"][r * 4:(r + 1) * 4])
            assert got["shard_b"].shape == (D_OUT,)
            whole = _cell(run, f"{variant}/0/")
            assert whole["shard_w"].shape == (D_IN, D_OUT)


@pytest.mark.parametrize("wire", WIRES)
def test_zero1_downlink_round_runtime_equals_steps(mesh_runs, wire):
    for run in mesh_runs[wire]:
        steps, rounds = _cell(run, "down_partial/1/"), _cell(run, "rounds/")
        assert steps.keys() == rounds.keys()
        for k in steps:
            np.testing.assert_array_equal(rounds[k], steps[k], err_msg=k)


@pytest.mark.parametrize("variant", ["down", "down_partial"])
def test_downlink_wires_agree(mesh_runs, variant):
    for dense, sparse in zip(mesh_runs["dense_psum"],
                             mesh_runs["sparse_allgather"]):
        d, s = _cell(dense, f"{variant}/1/"), _cell(sparse, f"{variant}/1/")
        for k in ("bits", "bits_down", "rounds"):
            assert s[k] == d[k], k
        np.testing.assert_allclose(s["losses"], d["losses"], rtol=2e-6,
                                   atol=0)
        for k in ("w", "b", "local", "view", "down_memory"):
            np.testing.assert_allclose(s[k], d[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--device",
          "cpu", "--steps", "4", "--H", "2", "--seq", "16"]


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
def test_launcher_zero1_bidirectional(capsys, tmp_path, few_threads, wire):
    """``--policy preset:lm_hetero_bidir --zero1`` with repro's log
    lines; round and step give the same record; a sync launches the
    uplink's 7 Top_k stacks and the downlink's 8 (the stacks and the
    embedding); ``bits_down`` charges the downlink's counted bits, below
    the dense broadcast's; ``--ckpt`` saves the whole master."""
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint
    argv = LAUNCH + ["--wire", wire, "--policy", "preset:lm_hetero_bidir",
                     "--zero1", "--dispatch", "kernel"]
    rec_r = launch.main(argv + ["--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert " >> ln|norm|bias->identity;topk:k=0.05" in out
    assert "runtime: round (fused)" in out
    assert "checkpoint saved to" in out
    rec_s = launch.main(argv + ["--runtime", "step"])
    for k in ("loss", "kind", "bits_up", "bits_down", "launches_per_sync",
              "rounds"):
        assert rec_r[k] == rec_s[k], k
    kern = "topk_compact" if wire == "sparse_allgather" else "topk_compress"
    assert rec_r["launches_per_sync"] == [{**{k: 0 for k in
                                              rec_r["launches_per_sync"][0]},
                                           kern: 7 + 8}] * 2
    dense = 32.0 * rec_r["n_params"] * rec_r["kind"].count("sync")
    assert 0 < rec_r["bits_down"][-1] < dense / 10
    # the whole master: every leaf at its full shape
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config("gemma3-1b", smoke=True)
    like = get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")
    master = checkpoint.restore(str(tmp_path / "ck"), like)
    assert sum(x.numel() for x in tree_leaves(master)) == rec_r["n_params"]
