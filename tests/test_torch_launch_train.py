"""The port's training launcher (``repro_torch.launch.train``) and its
checkpoints, on the CPU.

``repro``'s own launcher does not run on jax 0.9.0 (it fails inside
``shard_map``, ROADMAP queue 3), so its log is no oracle here:
the launcher is held to ``repro``'s log format and to itself across the
two wires (R = 1, the same selection, so the same losses and bits) and
across the two runtimes (``--runtime round``, the default, against
``--runtime step``: the same log lines and record), its parts to
``repro`` in ``test_torch_distributed.py`` / ``test_torch_lm.py``.
Checkpoints cross between the packages bit for bit in both directions.
"""

import re

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.core import policy as pol
from repro_torch.launch import train as lt
from repro_torch.train import checkpoint

SMOKE = ["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--device",
         "cpu", "--steps", "4", "--H", "2", "--policy", "preset:arch",
         "--dispatch", "kernel"]
STEP = re.compile(r"^step +(\d+) \[(sync |local)\] loss (\S+) bits up (\S+) "
                  r"down (\S+)( launches/round \[(.*)\])?$")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke launcher on both wires, with its stdout and checkpoint."""
    import contextlib
    import io
    out = {}
    for name, extra in (("dense_psum", []), ("sparse_allgather", []),
                        ("step", ["--runtime", "step"])):
        wire = "sparse_allgather" if name == "step" else name
        ckpt = tmp_path_factory.mktemp(name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec = lt.main(SMOKE + ["--wire", wire, "--ckpt", str(ckpt)]
                          + extra)
        out[name] = (rec, buf.getvalue(), ckpt)
    return out


@pytest.mark.parametrize("wire", ["dense_psum", "sparse_allgather"])
def test_log_lines(runs, wire):
    rec, text, ckpt = runs[wire]
    lines = text.strip().splitlines()
    assert lines[0] == ("policy: ln|norm|bias|scale|gate_bias->identity;"
                        "embed|head->qsgd:s=15;topk:k=0.01")
    assert lines[1] == "runtime: round (fused)"
    lines = lines[:1] + lines[2:]
    steps = [STEP.match(ln) for ln in lines[1:5]]
    assert all(steps), lines[1:5]
    assert [m.group(2) for m in steps] == ["local", "sync ", "local", "sync "]
    kernel = "topk_compact" if wire == "sparse_allgather" else "topk_compress"
    for m in steps:
        if m.group(2) == "sync ":
            # the 7 Top_k stacks of lm_hetero, one launch each
            assert m.group(7) == f"{kernel}=7"
    assert lines[5] == ""
    assert re.match(r"^4 steps in \S+s \(\S+ it/s\); R=1 workers, 2 sync "
                    r"rounds, \S+ uplink \+ \S+ downlink = \S+ wire bits$",
                    lines[6]), lines[6]
    assert lines[-1] == f"checkpoint saved to {ckpt}"
    assert np.all(np.isfinite(rec["loss"])) and rec["kind"] == [
        "local", "sync", "local", "sync"]
    assert rec["launches_per_sync"] == [dict(
        {k: 0 for k in rec["launches_per_sync"][0]}, **{kernel: 7})] * 2


def test_round_runtime_equals_step_runtime(runs):
    """The default round runtime logs what ``--runtime step`` logs, step
    by step: losses, kinds, both ledgers (a mid-round step reports the
    round before's bits), launches per sync, the final checkpoint."""
    rnd, rnd_text, rnd_ckpt = runs["sparse_allgather"]
    stp, stp_text, stp_ckpt = runs["step"]
    steps = [ln for ln in stp_text.splitlines() if STEP.match(ln)]
    assert steps == [ln for ln in rnd_text.splitlines() if STEP.match(ln)]
    assert len(steps) == 4 and "runtime:" not in stp_text
    for k in ("loss", "kind", "bits_up", "bits_down", "launches_per_sync",
              "rounds", "R", "n_params"):
        assert rnd[k] == stp[k], k
    assert rnd["runtime"] == "round" and stp["runtime"] == "step"
    assert len(rnd["round_ms"]) == 2 and len(rnd["ms"]) == 4
    assert rnd["captures"] == 0 and "round_ms" not in stp
    for x, y in zip(_leaves(checkpoint.restore(str(rnd_ckpt), _like())),
                    _leaves(checkpoint.restore(str(stp_ckpt), _like()))):
        assert torch.equal(x, y)


def test_scenario_log_line_and_partial_syncs(capsys):
    """``--scenario`` runs the scenario's mask on the mesh
    (``partial=True``): ``repro``'s log line word for word, the syncs
    where the mask has any worker (here one of the fixed schedule's two
    is dropped), 7 ``topk_compact`` launches a sync; the round runtime
    against the steps under a mask is ``test_torch_scenarios.py``'s."""
    from repro_torch.core import scenarios as scn
    spec = "participation=0.5,seed=1"
    rec = lt.main(SMOKE + ["--wire", "sparse_allgather", "--scenario", spec,
                           "--aggregate", "mean_S"])
    m = scn.parse(spec).mask(4, 1, 2)
    assert (f"scenario: {spec} (participation "
            f"{scn.participation_of(m):.2f}, 1 sync steps)"
            ) in capsys.readouterr().out
    assert rec["kind"] == ["sync" if r.any() else "local" for r in m] == [
        "local", "sync", "local", "local"]
    assert rec["rounds"] == 1
    assert [c["topk_compact"] for c in rec["launches_per_sync"]] == [7]


def test_wires_agree(runs):
    dense, sparse = runs["dense_psum"][0], runs["sparse_allgather"][0]
    assert dense["bits_up"] == sparse["bits_up"]
    assert dense["bits_down"] == sparse["bits_down"]
    assert dense["bits_up"][-1] > 0
    np.testing.assert_allclose(sparse["loss"], dense["loss"], rtol=1e-6)
    a = checkpoint.restore(str(runs["dense_psum"][2]), _like())
    b = checkpoint.restore(str(runs["sparse_allgather"][2]), _like())
    for x, y in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def _like():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    return tf.init_params(torch.Generator().manual_seed(9),
                          get_config("gemma3-1b", smoke=True), device="cpu")


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def test_launcher_checkpoint_reads_in_repro(runs):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import transformer as jtf
    from repro.train import checkpoint as jck
    ckpt = str(runs["sparse_allgather"][2])
    like = jax.eval_shape(lambda: jtf.init_params(
        jax.random.PRNGKey(0), jget("gemma3-1b", smoke=True)))
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), like)
    got = jax.tree_util.tree_leaves(jck.restore(ckpt, like))
    mine = _leaves(checkpoint.restore(ckpt, _like()))
    assert len(got) == len(mine)
    for g, m in zip(got, mine):
        np.testing.assert_array_equal(np.asarray(g), m.numpy())
    assert jck.load_policy(ckpt).to_string() == \
        checkpoint.load_policy(ckpt).to_string()


def mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16),
        "layers": {"b": rng.standard_normal(7).astype(np.float32),
                   "s": np.arange(4, dtype=np.int32)},
        "e": rng.standard_normal(3).astype(ml_dtypes.float8_e4m3fn),
    }


def test_checkpoints_cross_bit_for_bit(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.train import checkpoint as jck
    tree = mixed_tree()
    # repro writes, the port reads
    jck.save(str(tmp_path / "j"), jax.tree_util.tree_map(jax.numpy.asarray,
                                                         tree), step=3)
    like = {"w": torch.zeros((6, 5), dtype=torch.bfloat16),
            "layers": {"b": torch.zeros(7),
                       "s": torch.zeros(4, dtype=torch.int32)},
            "e": torch.zeros(3, dtype=torch.float8_e4m3fn)}
    got = checkpoint.restore(str(tmp_path / "j"), like)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  tree["w"].view(np.int16))
    np.testing.assert_array_equal(got["e"].view(torch.uint8).numpy(),
                                  tree["e"].view(np.uint8))
    np.testing.assert_array_equal(got["layers"]["b"].numpy(),
                                  tree["layers"]["b"])
    np.testing.assert_array_equal(got["layers"]["s"].numpy(),
                                  tree["layers"]["s"])
    # the port writes, repro reads
    policy = pol.parse("norm->identity;.*->topk:k=0.01")
    checkpoint.save(str(tmp_path / "t"), got, step=3,
                    policy=policy.to_dict())
    back = jck.restore(str(tmp_path / "t"), tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the same manifest entries (names, paths, dtype names) either way
    import json
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("j", "t")]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert checkpoint.load_policy(str(tmp_path / "t")).to_string() \
        == jck.load_policy(str(tmp_path / "t")).to_string() \
        == policy.to_string()


@pytest.mark.parametrize("flags,item", [
    (["--faults", "preset:chaos"], "queue 1 item 10"),
    (["--tune"], "queue 1 item 11"),
    (["--zero1"], "queue 1 item 12"),
    (["--downlink", "topk"], "queue 1 item 12"),
    (["--policy", "topk:k=0.01 >> topk:k=0.05"], "queue 1 item 12"),
    (["--mesh", "1x2"], "queue 1 item 12"),
])
def test_unported_flags_raise(flags, item):
    argv = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu"] + (
        [] if "--mesh" in flags else ["--mesh", "1x1"]) + flags
    with pytest.raises(NotImplementedError, match=item):
        lt.main(argv)


def test_mesh_must_match_the_world():
    with pytest.raises(ValueError, match="world size is 1"):
        lt.main(["--arch", "gemma3-1b", "--smoke", "--mesh", "2x1",
                 "--device", "cpu"])
