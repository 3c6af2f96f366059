"""The trainer under faults, and crash-consistent resume (DESIGN.md §9).

* ``RunConfig(faults="preset:chaos", staleness_weight="damped")``
  against ``repro``'s ``History`` on the softmax problem: steps, bits
  and rounds exact, smoothed losses to rtol 1e-4 (XLA's fused
  multiply-adds over a few steps); the round runtime equal to the step
  runtime bit for bit (History, ``round_blocks`` against ``repro``'s
  ``fault_replay``, the final state with its queue);
* ``faults="preset:none"`` (with any fault seed) is the fault-free run
  bit for bit; a fleet dead all run records empty rounds;
* resume: a run restarted from an early ``full_step_<N>`` snapshot
  (payloads in flight, QSGD drawing from the restored generator) ends
  in the uninterrupted run's state, with its History tail, on both
  runtimes;
* a full snapshot's ``state`` written by either package restores in the
  other (the key cannot cross frameworks).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng, operators as jops
from repro.data import worker_batches as j_batches
from repro.models import softmax as jsoft
from repro.optim import inverse_time as j_inverse_time, sgd as j_sgd
from repro.train import RunConfig as JRun, checkpoint as jckpt, train as jtrain
from repro_torch.core import engine as teng, operators as tops
from repro_torch.core import scenarios as scn
from repro_torch.data import mnist_like, worker_batches
from repro_torch.models import softmax as tsoft
from repro_torch.optim import inverse_time, momentum_sgd, sgd
from repro_torch.train import RunConfig, checkpoint, train
from repro_torch.tree import tree_leaves, value_and_grad

R, T, B, N = 4, 16, 8, 400


@pytest.fixture(scope="module")
def data():
    return mnist_like(N, seed=0)


def port_train(data, op=None, smooth=20, **kw):
    x, y = data
    cfg = tsoft.SoftmaxConfig(l2=1.0 / N)
    grad = value_and_grad(lambda p, b: tsoft.loss_fn(p, b, cfg)[0])
    run = RunConfig(**{**dict(total_steps=T, R=R, H=4, log_every=4), **kw})
    return train(grad, tsoft.init_params(cfg, device="cpu"), sgd(),
                 op or tops.TopK(k=0.05), inverse_time(60.0, 100.0),
                 worker_batches(x, y, R, B, T, seed=1), run, smooth=smooth,
                 device="cpu")


def same_state(a, b) -> None:
    for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


HIST = ("steps", "loss", "bits", "bits_down", "rounds")


def test_trainer_faults_match_repro(data):
    x, y = data
    kw = dict(total_steps=T, R=R, H=4, log_every=4, faults="preset:chaos",
              staleness_weight="damped", aggregate="mean_S")
    cfg_j = jsoft.SoftmaxConfig(l2=1.0 / N)

    def grad_j(p, batch):
        return jax.value_and_grad(
            lambda pp: jsoft.loss_fn(pp, batch, cfg_j)[0])(p)

    sj, hj = jtrain(grad_j, jsoft.init_params(jax.random.PRNGKey(0), cfg_j),
                    j_sgd(), jops.TopK(k=0.05), j_inverse_time(60.0, 100.0),
                    j_batches(x, y, R, B, T, seed=1),
                    JRun(runtime="step", **kw))
    runs = {rt: port_train(data, runtime=rt, **kw) for rt in ("round",
                                                               "step")}
    (st, ht), (ss, hs) = runs["round"], runs["step"]
    for f in HIST:
        assert getattr(ht, f) == getattr(hs, f), f
    same_state(st, ss)
    assert ht.steps == hj.steps and ht.rounds == hj.rounds
    assert ht.bits == hj.bits and ht.bits_down == hj.bits_down
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=1e-4)
    np.testing.assert_array_equal(st.arrive_at, np.asarray(sj.arrive_at))
    np.testing.assert_allclose(st.master["x"].numpy(),
                               np.asarray(sj.master["x"]), rtol=1e-4,
                               atol=1e-6)
    # rounds close at event steps; n_synced is what each tail applied
    tables = scn.parse_faults("preset:chaos").tables(T, R)
    mask = np.broadcast_to(
        (np.arange(T) % 4 == 3)[:, None] | (np.arange(T) == T - 1)[:, None],
        (T, R))
    _, arrivals, events = scn.fault_replay(mask, tables)
    assert [s + L - 1 for s, L, _ in ht.round_blocks] == list(
        np.flatnonzero(events))
    assert [n for *_, n in ht.round_blocks] == [
        int(arrivals[t].sum()) for t in np.flatnonzero(events)]


def test_trainer_preset_none_bit_exact(data):
    for rt in ("round", "step"):
        s0, h0 = port_train(data, runtime=rt)
        s1, h1 = port_train(data, runtime=rt, faults="preset:none",
                            fault_seed=3)
        for f in HIST:
            assert getattr(h0, f) == getattr(h1, f), f
        same_state(s0, s1[:len(s0)])
        assert h0.round_blocks == h1.round_blocks


def test_trainer_dead_fleet_records_empty_rounds(data):
    dead = "crash=" + "+".join(f"{r}@0-64" for r in range(R))
    st, h = port_train(data, faults=dead)
    assert not st.master["x"].any()
    assert h.bits[-1] == 0.0 and h.rounds[-1] == 0
    assert h.round_blocks and all(n == 0 for *_, n in h.round_blocks)


@pytest.mark.parametrize("runtime,faults", [
    ("round", "preset:crashy"), ("step", "preset:crashy"), ("round", None)])
def test_trainer_crash_consistent_resume(tmp_path, data, runtime, faults):
    """Restart from the earliest full snapshot (payloads in flight, the
    generator mid-stream): the same final state, History tail and
    ledgers as the uninterrupted run, with and without faults."""
    d = str(tmp_path / "ckpt")
    kw = dict(runtime=runtime, faults=faults, log_every=1,
              op=tops.QSGDQuantizer(s=15), smooth=1)
    sa, ha = port_train(data, ckpt_dir=d, ckpt_every=5, **kw)
    fulls = sorted(int(n.rsplit("_", 1)[1]) for n in os.listdir(d)
                   if n.startswith("full_step_"))
    assert len(fulls) >= 2 and fulls[-1] >= T - 5
    for n in fulls[1:]:
        shutil.rmtree(os.path.join(d, f"full_step_{n}"))
    start = checkpoint.latest_full(d)
    assert 0 < start < T
    info = checkpoint.restore_train_state(
        f"{d}/full_step_{start}",
        teng.init(tsoft.init_params(tsoft.SoftmaxConfig(), device="cpu"),
                  sgd(), R, device="cpu",
                  queue_depth=3 if faults else None),
        torch.Generator())[2]
    assert info == {"cursor": start, "faults": faults and scn.parse_faults(
        faults).to_string(), "staleness_weight": "uniform"}
    sb, hb = port_train(data, ckpt_dir=d, resume=True, **kw)
    same_state(sa, sb)
    k = ha.steps.index(start + 1)
    for f in HIST:
        assert getattr(ha, f)[k:] == getattr(hb, f), f
    with pytest.raises(ValueError, match="fault spec mismatch"):
        port_train(data, ckpt_dir=d, resume=True,
                   **{**kw, "faults": "preset:lossy"})


def test_snapshot_state_crosses_packages(tmp_path):
    """``save_train_state``'s ``state`` subtree, written by either
    package, restores in the other leaf for leaf (the host counters and
    queue tags as int32 on both sides); the key stays behind."""
    spec = scn.parse_faults("preset:chaos")
    rng = np.random.RandomState(0)
    params = {"b": rng.randn(3).astype(np.float32),
              "w": rng.randn(5, 3).astype(np.float32)}
    like_t = teng.init({k: torch.from_numpy(v) for k, v in params.items()},
                       momentum_sgd(0.9), R, device="cpu",
                       queue_depth=spec.depth, leaf_ledger=True)
    state_t = teng.EngineState(*[
        x if x is None else y for x, y in zip(like_t, teng.EngineState(
            *[None] * 5, step=11, bits=torch.tensor(123.0), rounds=7,
            bits_down=torch.tensor(9.0), leaf_bits=torch.tensor([1., 2.]),
            leaf_bits_down=torch.tensor([3., 4.]),
            arrive_at=np.array([[12, -1, 13, -1]] * R, np.int32),
            inflight_tau=np.array([[1, 0, 2, 0]] * R, np.int32)))])
    state_t = state_t._replace(**{
        f: {k: torch.randn(v.shape, generator=torch.Generator()
                           .manual_seed(i)) for k, v in getattr(
                               like_t, f).items()}
        for i, f in enumerate(("master", "master_view", "local", "memory",
                               "inflight"))},
        inner={"mu": {k: torch.randn(v.shape) for k, v in
                      like_t.inner["mu"].items()}})
    gen = torch.Generator().manual_seed(5)
    checkpoint.save_train_state(str(tmp_path / "t"), state_t, key=gen,
                                cursor=11, faults=spec.to_string())
    like_j = jeng.init({k: jnp.asarray(v) for k, v in params.items()},
                       __import__("repro.optim", fromlist=["x"])
                       .momentum_sgd(0.9), R, queue_depth=spec.depth,
                       leaf_ledger=True)
    sj, _, info = jckpt.restore_train_state(str(tmp_path / "t"), like_j,
                                            jax.random.PRNGKey(0))
    assert info["cursor"] == 11 and info["faults"] == spec.to_string()
    lt, lj = tree_leaves(tuple(state_t)), jax.tree_util.tree_leaves(sj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(
            a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
            np.asarray(b))
    jckpt.save_train_state(str(tmp_path / "j"), sj, key=jax.random.PRNGKey(3),
                           cursor=11, faults=spec.to_string())
    back, key, info = checkpoint.restore_train_state(str(tmp_path / "j"),
                                                     like_t)
    assert key is None and info["cursor"] == 11
    same_state(back, state_t)
    assert isinstance(back.step, int) and back.arrive_at.dtype == np.int32
    with pytest.raises(ValueError, match="torch.Generator"):
        checkpoint.restore_train_state(str(tmp_path / "j"), like_t,
                                       torch.Generator())
    g2 = torch.Generator()
    checkpoint.restore_train_state(str(tmp_path / "t"), like_t, g2)
    assert torch.equal(torch.rand(4, generator=g2),
                       torch.rand(4, generator=gen))


def test_fault_options_refused(data):
    with pytest.raises(ValueError, match="staleness"):
        port_train(data, faults="preset:none", staleness_weight="inverse")
    with pytest.raises(ValueError, match="fault injection"):
        port_train(data, faults="preset:none", overlap=True)
    with pytest.raises(ValueError, match="ckpt_dir"):
        port_train(data, resume=True)
