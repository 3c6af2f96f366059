"""Tensor parallelism of the RWKV-6 and Zamba2 families (``models.rwkv6``
and ``models.zamba2`` under a policy; ``sharding/collectives.py``'s
``split_features`` and ``gather_whole``; ``launch.train
--mesh DxM`` and the dry run for the two families) against ``repro``
and against the port's own ``Dx1`` runs, on the CPU.

One spawn of four gloo ranks (``RANK_CODE``: no JAX in the ranks) runs
every multi-rank case on sub-meshes of its world, while the in-process
tests run:

* (a) ``loss_fn(policy=)`` on each rank's shards of the rwkv6-3b and
  zamba2-7b smoke models at M = 2 and M = 4 (whole heads a rank), and
  with heads that straddle ranks at M = 4: RWKV-6 at ``d_model`` 96 (6
  heads of 16: r / k / v gathered whole, every head on every rank) and
  Zamba2 at ``d_model`` 96 with heads of 32 (6 SSD heads: x gathered
  whole), each config built the same way in both packages; the
  gradients gathered whole against ``repro``'s ``loss_fn`` under
  ``jax.value_and_grad`` on the same weights and tokens: the loss within
  1e-5 relative, each gradient leaf within 1e-4 of its largest entry
  (tests/test_torch_tp.py's tolerances);
* (b) every leaf whole on every rank of the group (the norms, the
  token-shift mixes, RWKV-6's decay LoRA and ``ln_x``, Zamba2's B / C
  projections and convolutions, a bonus or SSD head leaf the group does
  not divide) gets a gradient equal bit for bit on every rank: the
  engine counts such a leaf once (``ModelShards`` "local");
* (c) the launcher under ``preset:arch``: each family ``1x2 --zero1``
  against ``1x1 --zero1`` on both wires and ``2x2`` against ``2x1`` on
  one (RWKV-6 the dense wire, Zamba2 the sparse): launches a sync, step
  kinds and rounds equal, every loss within 1e-5 relative, each sync's
  bits up and down equal but in at most one sync, by at most one
  survivor's field (``TIE_BITS``); each final master leaf within
  ``MASTER_RTOL`` of the twin's (relative L2) but at most one, the leaf
  whose survivors parted, within ``PARTED_MASTER``.  A sync's delta is
  the difference of two float32 iterates, which keeps ~17 significant
  bits where the update is small beside the weight: a leaf that starts
  at zero (the norm gains, ``bonus``) is all update and carries that
  precision (``MASTER_RTOL``), and two entries of a SignTop_k row can
  sit within it of each other at the k-th magnitude, where the twin's
  sums in another order pick the other one or make a tie that keeps
  both (ROADMAP queue 3 has the entries' bits: rwkv6 ``cr``, the same
  count; zamba2 ``conv_x``, one survivor more).  The survivor swapped
  is one update, so its leaf's master parts by it.

* (d) the dry run of both smoke models at ``train_4k`` on ``4x2`` is
  ``ok`` with model-group all-reduces and all-gathers (on ranks 2 and
  3, which have the lighter launcher runs).

In process (``repro``'s side of (a) in a thread beside them): a model
group of one leaves both losses bit for bit as without a policy; the
specs equal ``repro``'s.
"""

import dataclasses
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import NO_SHARDING
from repro_torch.launch.mesh import Mesh, run_local_ranks
from repro_torch.models import get_model
from repro_torch.sharding import specs as sp
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, value_and_grad

from test_torch_tp import _json, _npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RWKV, ZAMBA = "rwkv6-3b", "zamba2-7b"
#: configs past the smoke ones: heads that straddle four ranks
STRADDLE = {RWKV: {"d_model": 96}, ZAMBA: {"d_model": 96,
                                           "ssm_head_dim": 32}}
#: (a)'s cases: (arch, mesh, straddled)
LOSS_CASES = [(RWKV, "1x2", False), (RWKV, "1x4", False),
              (RWKV, "1x4", True), (ZAMBA, "1x2", False),
              (ZAMBA, "1x4", False), (ZAMBA, "1x4", True)]
#: (c)'s launcher pairs: (arch, mesh, its twin's, wire, flags), each
#: family on both wires; a run is compared with the run of the same
#: name at the twin's mesh
WIRES = ("dense_psum", "sparse_allgather")
PAIRS = ([(a, "1x2", "1x1", w, ["--zero1"]) for a in (RWKV, ZAMBA)
          for w in WIRES]
         + [(RWKV, "2x2", "2x1", "dense_psum", []),
            (ZAMBA, "2x2", "2x1", "sparse_allgather", [])])
#: (c)'s runs: name -> (arch, mesh, its first world rank, flags), as
#: tests/test_torch_ep.py lays them out: the ``2x2`` runs take the four
#: ranks first; then ranks 0-1 run the ``1x2`` runs while ranks 2-3 run
#: the ``2x1`` ones and split the ``1x1`` ones
FIRST = {"2x2": 0, "1x2": 0, "2x1": 2}
RUNS, TWINS = {}, []
for _arch, _m, _twin, _w, _flags in PAIRS:
    _tag = f"{_arch}/{_w}{''.join(_flags)}"
    for _mesh in (_m, _twin):
        _first = FIRST.get(_mesh, 2 + len(TWINS) % 2)
        RUNS[f"{_mesh}/{_tag}"] = (_arch, _mesh, _first,
                                   ["--wire", _w] + _flags)
    TWINS.append((_m, _twin, _tag))
RUNS = dict(sorted(RUNS.items(), key=lambda kv: kv[1][1] != "2x2"))
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "4", "--H", "2",
          "--seq", "16", "--dispatch", "kernel", "--policy", "preset:arch"]
#: (d)'s dry runs: (arch, mesh), on ranks 2 and 3
DRY_CASES = [(a, m) for a in (RWKV, ZAMBA) for m in ("4x2", "4x1")]
#: (c): the bits by which one sync's ledger may part from the twin's: a
#: survivor kept or dropped, a field of 32 value bits and the index of a
#: row of the smoke models' widest (512: the vocab) (read: 3, zamba2
#: ``1x2 --zero1``; 0 elsewhere)
TIE_BITS = 32 + 9
#: (c): each master leaf against the twin's, relative L2 (read: at most
#: 1.9e-5, rwkv6 ``2x2``'s ``ln1``, every survivor equal)
MASTER_RTOL = 5e-5
#: (c): the one leaf whose survivors parted (read: at most 1.04e-4,
#: zamba2 ``1x2 --zero1``'s ``conv_x``; rwkv6's ``cr`` 1.0e-4)
PARTED_MASTER = 3e-4

RANK_CODE = r"""
import dataclasses, json, math, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as ms
from repro_torch.launch import train as lt
from repro_torch.models import get_model
from repro_torch.sharding import specs as sp
from repro_torch.tree import tree_flatten_with_path, tree_leaves, value_and_grad

OUT = {out!r}
LOSS_CASES, STRADDLE = {cases!r}, {straddle!r}
RUNS, LAUNCH, DRY_CASES = {runs!r}, {launch!r}, {dry!r}
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", rank=rank, world_size=world)


def sub(text, first=0):
    # the mesh over world ranks first .. first + n - 1 (None on the
    # others; a model group only from rank 0); every rank makes every
    # group, in one order
    dims, names = ms.parse_mesh(text)
    n = math.prod(dims)
    ranks = list(range(first, first + n))
    group = (dist.group.WORLD if n == world
             else dist.new_group(ranks) if n > 1 else None)
    mesh = ms.Mesh(dims, names, rank=rank - first if rank in ranks else 0,
                   world_size=n, backend="gloo", group=group)
    if n > 1 and dims[-1] > 1:
        assert first == 0
        mesh.groups = ms._subgroups(mesh)
    return mesh if rank in ranks else None


MESHES = {{(t, f): sub(t, f) for t, f in (
    ("1x2", 0), ("1x4", 0), ("2x2", 0), ("2x1", 2), ("1x1", 2), ("1x1", 3))}}

# (a) the loss and its gradients on model shards; (b) the whole leaves'
# gradients on every rank
for arch, text, straddled in LOSS_CASES:
    mesh = MESHES[text, 0]
    if mesh is None:
        continue
    cfg = get_config(arch, smoke=True)
    if straddled:
        cfg = dataclasses.replace(cfg, **STRADDLE[arch])
    model = get_model(cfg)
    whole = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
    batch = {{"tokens": torch.from_numpy(toks)}}
    layout = sp.shard_layout(sp.param_specs(cfg), whole, mesh)
    policy = sp.activation_policy(cfg, mesh)
    fn = value_and_grad(lambda p, b: model.loss_fn(p, b, cfg, loss_chunk=16,
                                                   policy=policy)[0])
    loss, grads = fn(sp.shard_tree(whole, layout), batch)
    paths = [".".join(map(str, p)) for p, _ in
             tree_flatten_with_path(whole)[0]]
    same = {{}}
    for path, g, ax in zip(paths, tree_leaves(grads), layout.axes):
        if ax is None:
            every = mesh.all_gather(g, over="model")
            same[path] = all(torch.equal(every[0], x) for x in every[1:])
    grads = sp.gather_tree(grads, layout, mesh)
    if rank == 0:
        tag = f"{{arch}}_{{text}}_{{int(straddled)}}"
        np.savez(os.path.join(OUT, f"grads_{{tag}}.npz"),
                 *[t.numpy() for t in tree_leaves(grads)])
        with open(os.path.join(OUT, f"loss_{{tag}}.json"), "w") as f:
            json.dump({{"loss": float(loss), "whole_equal": same}}, f)

# (c) the launcher on sub-meshes
for name, (arch, text, first, flags) in RUNS.items():
    mesh = MESHES[text, first]
    if mesh is None:
        continue
    tag = name.replace("/", "_")
    argv = LAUNCH + ["--arch", arch, "--mesh", text, "--json",
                     os.path.join(OUT, f"rec_{{tag}}.json"),
                     "--ckpt", os.path.join(OUT, f"ck_{{tag}}")] + flags
    args = lt.parser().parse_args(argv)
    lt._run(args, lt.resolve_policy_arg(args), mesh)

# (d) the dry run on a model axis, on the ranks with the lighter runs
for arch, m in DRY_CASES:
    if rank == 2 + DRY_CASES.index((arch, m)) % 2:
        rec = dr.run_one(arch, shape=InputShape("train_4k", 32, 4, "train"),
                         smoke=True, mesh=m)
        with open(os.path.join(OUT, f"dry_{{arch}}_{{m}}.json"), "w") as f:
            json.dump({{**rec, "pending": dr.pending(rec)}}, f)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The four ranks and ``repro``'s side of (a), started as the
    module's tests start (they run while the in-process tests do): (the
    directory rank 0 writes, the spawn's future, the future of
    :func:`_repro_losses`)."""
    out = str(tmp_path_factory.mktemp("tp_ssm"))
    code = RANK_CODE.format(src=os.path.join(REPO, "src"), out=out,
                            cases=LOSS_CASES, straddle=STRADDLE, runs=RUNS,
                            launch=LAUNCH, dry=DRY_CASES)
    env = dict(os.environ, OMP_NUM_THREADS="1")   # four ranks share cores
    env.pop("PYTHONPATH", None)
    with ThreadPoolExecutor(2) as pool:
        yield (out, pool.submit(run_local_ranks, [sys.executable, "-c", code],
                                4, env=env, timeout=300),
               pool.submit(_repro_losses))


@pytest.fixture(scope="module")
def ranks(spawned):
    """The four ranks' results: a directory rank 0 wrote."""
    out, future, _ = spawned
    for r, (rc, _out, err) in enumerate(future.result()):
        assert rc == 0, f"rank {r}: {err[-4000:]}"
    return out


def _jax():
    import types
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import rwkv6 as jrw
    from repro.models import zamba2 as jza
    from repro.sharding import specs as jsp
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=jget, sp=jsp,
                                 models={RWKV: jrw, ZAMBA: jza})


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    return _jax()


def _config(arch, straddled=False, get=get_config):
    cfg = get(arch, smoke=True)
    return dataclasses.replace(cfg, **STRADDLE[arch]) if straddled else cfg


def _tag(arch, mesh, straddled):
    return f"{arch}_{mesh}_{int(straddled)}"


# ---------------------------------------------------------------------------
# in process: a group of one, the specs; (d) the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_model_group_of_one_is_the_plain_loss(arch):
    """No policy, ``NO_SHARDING`` and a one-rank model group run the same
    operations: the loss and gradients bit for bit."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
    batch = {"tokens": torch.from_numpy(toks)}
    outs = []
    for policy in (None, NO_SHARDING, sp.activation_policy(
            cfg, Mesh((1, 1), ("data", "model")))):
        fn = value_and_grad(lambda p, b: model.loss_fn(
            p, b, cfg, loss_chunk=16, policy=policy)[0])
        loss, grads = fn(params, batch)
        outs.append([loss] + tree_leaves(grads))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_specs_match_repro(jx, arch):
    for smoke in (True, False):
        cfg, jcfg = get_config(arch, smoke=smoke), jx.get(arch, smoke=smoke)
        got = tree_leaves(sp.param_specs(cfg), is_leaf=sp.is_spec)
        want = jx.jax.tree_util.tree_leaves(
            jx.sp.param_specs(jcfg),
            is_leaf=lambda z: isinstance(z, jx.jax.sharding.PartitionSpec))
        assert got == [tuple(p) for p in want]
        for m in (2, 16):
            assert sp.head_divisibility_note(cfg, m) == \
                jx.sp.head_divisibility_note(jcfg, m) == "clean"


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_dry_run_on_a_model_axis(ranks, arch):
    """(d): both smoke models at a small training shape on ``4x2`` (whole
    heads a rank) are ``ok``: a rank holds about half of the ``4x1``
    record's arguments, and its model group runs all-reduces and
    all-gathers in both steps."""
    tp, dp = (_json(ranks, f"dry_{arch}_{m}") for m in ("4x2", "4x1"))
    for rec in (tp, dp):
        assert rec["status"] == "ok", rec.get("error")
    assert tp["model_axis"] == 2 and not tp["pending"]
    for name in ("sync_step", "local_step"):
        model = tp["steps"][name]["collectives_by_group"]["model"]
        assert model["all-reduce"] > 0 and model["all-gather"] > 0, model
        a = dp["steps"][name]["memory"]["argument_bytes"]
        b = tp["steps"][name]["memory"]["argument_bytes"]
        assert a / 2 < b < 0.6 * a, (name, a, b)


# ---------------------------------------------------------------------------
# (a) the loss and gradients, (b) whole leaves
# ---------------------------------------------------------------------------


def _repro_losses():
    """``repro``'s loss and gradients by (arch, straddled), on the weights
    the ranks draw (``init_params`` from one torch seed) and their
    tokens."""
    jx, out = _jax(), {}
    for arch, _, straddled in LOSS_CASES:
        if (arch, straddled) in out:
            continue
        cfg, jcfg = _config(arch, straddled), _config(arch, straddled,
                                                      jx.get)
        jm = jx.models[arch]
        whole = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                           cfg, "cpu")
        params = jx.jax.tree_util.tree_unflatten(
            jx.jax.tree_util.tree_structure(jx.jax.eval_shape(
                lambda c=jcfg, m=jm: m.init_params(jx.jax.random.PRNGKey(0),
                                                   c))),
            [jx.jnp.asarray(t.numpy()) for t in tree_leaves(whole)])
        toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
        batch = {"tokens": jx.jnp.asarray(toks.astype(np.int32))}
        lj, gj = jx.jax.jit(jx.jax.value_and_grad(
            lambda p, b, c=jcfg, m=jm: m.loss_fn(p, b, c,
                                                 loss_chunk=16)[0]))(
            params, batch)
        out[arch, straddled] = float(lj), [
            np.asarray(g) for g in jx.jax.tree_util.tree_leaves(gj)]
    return out


@pytest.fixture(scope="module")
def repro_losses(jx, spawned):
    """:func:`_repro_losses`, computed beside the module's other tests."""
    return spawned[2].result()


@pytest.mark.parametrize("arch,mesh,straddled", LOSS_CASES)
def test_loss_and_grads_match_repro(repro_losses, ranks, arch, mesh,
                                    straddled):
    lj, gj = repro_losses[arch, straddled]
    tag = _tag(arch, mesh, straddled)
    np.testing.assert_allclose(_json(ranks, f"loss_{tag}")["loss"], lj,
                               rtol=1e-5)
    gt = _npz(ranks, f"grads_{tag}")
    assert [g.shape for g in gt] == [g.shape for g in gj]
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


@pytest.mark.parametrize("arch,mesh,straddled", LOSS_CASES)
def test_whole_leaves_have_one_gradient(ranks, arch, mesh, straddled):
    same = _json(ranks, f"loss_{_tag(arch, mesh, straddled)}")["whole_equal"]
    assert same and all(same.values()), same
    # the leaves a straddled head count leaves whole, with the norms
    want = {(RWKV, True): "layers.bonus", (ZAMBA, True): "layers.A_log",
            (RWKV, False): "layers.w0", (ZAMBA, False): "layers.w_B"}
    assert want[arch, straddled] in same


# ---------------------------------------------------------------------------
# (c) the launcher against its Dx1 twin
# ---------------------------------------------------------------------------


def _record(ranks, name):
    return _json(ranks, "rec_" + name.replace("/", "_"))


def _per_sync(rec, key) -> np.ndarray:
    return np.diff([0.0] + rec[key])


@pytest.mark.parametrize("tp,twin,run", TWINS,
                         ids=[f"{a}/{r}" for a, _, r in TWINS])
def test_launcher_equals_its_dx1_twin(ranks, tp, twin, run):
    a, b = _record(ranks, f"{tp}/{run}"), _record(ranks, f"{twin}/{run}")
    M = int(tp.split("x")[1])
    assert (a["model_axis"], b["model_axis"]) == (M, 1)
    assert a["fused"] is False
    for key in ("kind", "launches_per_sync", "rounds", "n_params", "R"):
        assert a[key] == b[key], key
    assert a["bits_up"][-1] > 0
    gaps = np.concatenate([
        np.abs(_per_sync(a, key) - _per_sync(b, key))
        for key in ("bits_up", "bits_down")])
    assert np.count_nonzero(gaps) <= 1 and gaps.max() <= TIE_BITS, (
        a["bits_up"], b["bits_up"], a["bits_down"], b["bits_down"])
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)


@pytest.mark.parametrize("tp,twin,run", TWINS,
                         ids=[f"{a}/{r}" for a, _, r in TWINS])
def test_launcher_masters_match_the_dx1_twin(ranks, tp, twin, run):
    cfg = get_config(run.split("/")[0], smoke=True)
    like = get_model(cfg).init_params(None, cfg, "meta")
    tag = lambda m: "ck_" + f"{m}/{run}".replace("/", "_")  # noqa: E731
    ma = checkpoint.restore(os.path.join(ranks, tag(tp)), like, device="cpu")
    mb = checkpoint.restore(os.path.join(ranks, tag(twin)), like,
                            device="cpu")
    gaps = [float(torch.linalg.vector_norm(x - y)
                  / torch.linalg.vector_norm(y))
            for x, y in zip(tree_leaves(ma), tree_leaves(mb))]
    parted = [g for g in gaps if g > MASTER_RTOL]
    assert len(parted) <= 1 and max(gaps) <= PARTED_MASTER, gaps
