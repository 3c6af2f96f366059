"""Expert parallelism of the MoE family (``models.moe``: ``_EPApply``,
``_expert_bwd_local``, ``moe_ffn`` / ``loss_fn`` under a policy;
``launch.train --mesh DxM`` and the dry run for the family) against
``repro`` and against the port's own ``Dx1`` runs, on the CPU.

In process:

* (a) each shard's ``_expert_compute_local`` and ``_expert_bwd_local``
  (qwen3-moe smoke shapes at M = 2 and M = 4, a capacity that drops
  assignments) against ``repro``'s, called directly with the shard's
  ``e_start``, ``E_loc`` and the global ``C``: outputs within 1e-5 of
  their largest entry, ``dropped`` equal; the shards' partials summed
  and the experts' gradients joined equal to the whole (``e_start`` 0,
  E) within the same tolerance;
* (b) ``_EPApply``'s hand-written backward against plain autograd of
  ``_expert_compute_local``, and a float64 ``gradcheck``, on tiny
  shapes (a whole shard and a part of the experts);
* a model group of one leaves the MoE loss bit for bit as without a
  policy;
* ``_moe_specs`` equal to ``repro``'s leaf by leaf;
* the dry run of qwen3-moe smoke at ``train_4k`` on ``4x2``: ``ok``,
  its model group's all-reduce bytes equal to the count from the shapes
  (the formula in ``test_dry_run_counts_the_expert_collectives``).

One spawn of four gloo ranks (``RANK_CODE``: no JAX in the ranks) runs
every multi-rank case on sub-meshes of its world:

* (c) ``moe.loss_fn(policy=)`` on each rank's shards, gathered whole,
  against ``repro``'s ``loss_fn`` under ``jax.value_and_grad`` (qwen3-moe
  smoke at M = 2 and 4, at a capacity that drops; llama4 smoke at M = 2:
  interleave 2, a shared expert, top-1): the loss within 1e-5 relative,
  each gradient leaf within 1e-4 of its largest entry, ``dropped``
  equal, ``aux_loss`` within 1e-6; and each rank's ``ep_apply`` on the
  whole region's inputs equal to the whole region within 1e-5;
* (d) ``preset:uniform_topk``'s uplink per shard at M = 2 (Top_k on the
  4-D expert shards, each rank its rows; the survivor counts summed
  over the group) against the whole tree on the same delta, a delta of
  two float32 iterates whose rows tie at the k-th magnitude: both
  forms' bits and the gathered output equal, bit for bit;
* (e) the launcher under ``preset:arch`` (the experts Identity, as in
  ``repro``) and ``preset:uniform_topk`` (Top_k on the expert shards)
  on both wires: qwen3-moe ``2x2`` against ``2x1``, ``1x2 --zero1``
  against ``1x1 --zero1``, llama4 ``1x2`` against ``1x1``: launches a
  sync, step kinds and rounds equal, each sync's bits up and down equal
  but for tied survivors (at most ``TIE_SURVIVORS``, the fields of the
  widest row each); losses within 1e-5 relative and final masters
  within 1e-5 of their largest entry, but where a sync's bits part:
  from it on the losses within ``PARTED_LOSS_RTOL`` and each master
  leaf within ``PARTED_MASTER`` (relative L2).  The ledgers part by
  ties: a sync's delta is the difference of two float32 iterates, which
  keeps ~17 significant bits where the update is small beside the
  weight, so a row's k-th and (k+1)-th magnitudes can be equal, and a
  tie keeps every tied survivor; the twin's sums in another order make
  or break such a tie (qwen3-moe smoke ``1x2 --zero1`` under ``preset:arch``,
  layer 0's wv row 52: 0x1.1f4b7p-9 / 0x1.1f4b8p-9 at ``1x1``, tied at
  0x1.1f4b8p-9 at ``1x2``: one survivor, 39 bits).  Per shard against
  the whole tree on one delta the ledger is exact ((d)).
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
from repro_torch.launch import dryrun as dr
from repro_torch.launch import train as lt
from repro_torch.launch.mesh import Mesh, dry_mesh, run_local_ranks
from repro_torch.models import moe
from repro_torch.sharding import specs as sp
from repro_torch.train import checkpoint
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              value_and_grad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN, LLAMA = "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"
#: a capacity factor at which the smoke models drop assignments
DROP_CF = 0.3
#: (c)'s cases: (arch, mesh, capacity factor)
LOSS_CASES = [(QWEN, "1x2", DROP_CF), (QWEN, "1x4", DROP_CF),
              (LLAMA, "1x2", None)]
#: (e)'s launcher runs: name -> (arch, mesh, its first world rank,
#: flags); a run is compared with the run of the same name at its twin
#: mesh.  The ``2x2`` runs take the four ranks first; then ranks 0-1 run
#: the ``1x2`` runs while ranks 2-3 run the ``2x1`` ones and split the
#: ``1x1`` ones, each rank the runs of the meshes it is in, in order
WIRES = ("dense_psum", "sparse_allgather")
POLICIES = ("preset:arch", "preset:uniform_topk")
PAIRS = [(QWEN, "2x2", "2x1", []), (QWEN, "1x2", "1x1", ["--zero1"]),
         (LLAMA, "1x2", "1x1", [])]
FIRST = {"2x2": 0, "1x2": 0, "2x1": 2}
RUNS, TWINS = {}, []
for _arch, _m, _twin, _flags in PAIRS:
    for _w in WIRES:
        for _p in POLICIES:
            _tag = f"{_arch}/{_w}/{_p[len('preset:'):]}{''.join(_flags)}"
            for _mesh in (_m, _twin):
                _first = FIRST.get(_mesh, 2 + len(RUNS) % 2)
                RUNS[f"{_mesh}/{_tag}"] = (_arch, _mesh, _first,
                                           ["--wire", _w, "--policy", _p]
                                           + _flags)
            TWINS.append((_m, _twin, _tag))
RUNS = dict(sorted(RUNS.items(), key=lambda kv: kv[1][1] != "2x2"))
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "4", "--H", "2",
          "--seq", "16", "--dispatch", "kernel"]
#: (e): tied survivors by which a sync's bits may part from the twin's,
#: each at most a field of 32 value bits and the index of a row of the
#: smoke models' widest (512: the vocab)
TIE_SURVIVORS = 2
TIE_BITS = TIE_SURVIVORS * (32 + 9)
#: (e): the losses after a sync parted by a tie, relative (1.1e-5 read
#: on the CPU after one tied survivor)
PARTED_LOSS_RTOL = 1e-4
#: (e): each master leaf after such a sync, relative L2 (at most 2.0e-4
#: read: the tied entry, then every leaf's updates from the steps after)
PARTED_MASTER = 1e-3

RANK_CODE = r"""
import dataclasses, json, math, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config, get_policy_preset
from repro_torch.core import policy as pol
from repro_torch.core.distributed import ModelShards, ShardCompressor
from repro_torch.launch import mesh as ms
from repro_torch.launch import train as lt
from repro_torch.models import moe
from repro_torch.sharding import specs as sp
from repro_torch.tree import tree_leaves, tree_map, value_and_grad

OUT = {out!r}
LOSS_CASES, RUNS, LAUNCH = {cases!r}, {runs!r}, {launch!r}
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


def save(name, tree):
    np.savez(os.path.join(OUT, name + ".npz"),
             *[t.detach().numpy() for t in tree_leaves(tree)])


def config(arch, cf):
    cfg = get_config(arch, smoke=True)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


# (c) the loss and its gradients on model shards; the EP region against
# the whole region on the same inputs
for arch, text, cf in LOSS_CASES:
    mesh = MESHES[text, 0]
    if mesh is None:
        continue
    cfg = config(arch, cf)
    whole = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
    batch = {{"tokens": torch.from_numpy(toks)}}
    layout = sp.shard_layout(sp.param_specs(cfg), whole, mesh)
    policy = sp.activation_policy(cfg, mesh)
    mine = sp.shard_tree(whole, layout)
    fn = value_and_grad(lambda p, b: moe.loss_fn(p, b, cfg, loss_chunk=16,
                                                 policy=policy)[0])
    loss, grads = fn(mine, batch)
    _, metrics = moe.loss_fn(mine, batch, cfg, loss_chunk=16, policy=policy)
    grads = sp.gather_tree(grads, layout, mesh)
    # the first MoE layer's region on x drawn alike on every rank
    x = torch.from_numpy(np.random.RandomState(2).randn(
        48, cfg.d_model).astype(np.float32))
    wp = {{k: v[0] for k, v in whole["layers"]["moe"].items()
          if k != "shared"}}
    mp = {{k: v[0] for k, v in mine["layers"]["moe"].items()
          if k != "shared"}}
    eids, w, _ = moe._route(x, wp["router"], cfg)
    C = moe._capacity(eids.numel(), cfg.n_experts, cfg.capacity_factor)
    out, dropped = moe.ep_apply(x, eids, w, mp["w1"], mp["w3"], mp["w2"],
                                policy, C)
    want, want_dropped = moe._expert_compute_local(
        x, eids, w, wp["w1"], wp["w3"], wp["w2"], 0, cfg.n_experts, C)
    if rank == 0:
        save(f"grads_{{arch}}_{{text}}", grads)
        with open(os.path.join(OUT, f"loss_{{arch}}_{{text}}.json"), "w") as f:
            json.dump({{"loss": float(loss),
                       "aux_loss": float(metrics["aux_loss"]),
                       "dropped": float(metrics["dropped"]),
                       "region_gap": float((out - want).abs().max()
                                           / want.abs().max()),
                       "region_dropped": [int(dropped),
                                          int(want_dropped)]}}, f)

# (d) uniform_topk's uplink per shard against the whole tree on one delta
mesh = MESHES["1x2", 0]
if mesh is not None:
    cfg = get_config("{qwen}", smoke=True)
    gen = torch.Generator().manual_seed(7)
    whole = moe.init_params(gen, cfg, "cpu")
    # two float32 iterates a small update apart: rows that tie
    delta = tree_map(lambda x: x - (x - 1e-3 * torch.randn(
        x.shape, generator=gen) * x.abs().mean()), whole)
    comp = ShardCompressor.from_spec(pol.as_channel_spec(
        get_policy_preset("uniform_topk")).uplink, delta, dispatch="kernel")
    specs = sp.param_specs(cfg)
    layout = sp.shard_layout(specs, delta, mesh)
    mine = sp.shard_tree(delta, layout)
    shards = ModelShards(layout, mesh)
    q_mine, bits_mine = comp(mine, specs, shards=shards)
    cbits_mine = comp.compact(mine, specs, shards=shards)[2]
    q_whole, bits_whole = comp(delta, specs)
    cbits_whole = comp.compact(delta, specs)[2]
    q_mine = sp.gather_tree(q_mine, layout, mesh)
    if rank == 0:
        save("comp_mine", q_mine)
        save("comp_whole", q_whole)
        with open(os.path.join(OUT, "comp_bits.json"), "w") as f:
            json.dump({{"mine": [float(bits_mine), float(cbits_mine)],
                       "whole": [float(bits_whole), float(cbits_whole)],
                       "split": [ax is not None for ax in layout.axes]}}, f)

# (e) the launcher on sub-meshes
for name, (arch, text, first, flags) in RUNS.items():
    mesh = MESHES[text, first]
    if mesh is None:
        continue
    tag = name.replace("/", "_").replace(":", "_")
    argv = LAUNCH + ["--arch", arch, "--mesh", text, "--json",
                     os.path.join(OUT, f"rec_{{tag}}.json"),
                     "--ckpt", os.path.join(OUT, f"ck_{{tag}}")] + flags
    args = lt.parser().parse_args(argv)
    lt._run(args, lt.resolve_policy_arg(args), mesh)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The four ranks, started as the module's tests start (they run
    while the in-process tests do): (the directory rank 0 writes, the
    spawn's future)."""
    out = str(tmp_path_factory.mktemp("ep"))
    code = RANK_CODE.format(src=os.path.join(REPO, "src"), out=out,
                            cases=LOSS_CASES, runs=RUNS, launch=LAUNCH,
                            qwen=QWEN)
    env = dict(os.environ, OMP_NUM_THREADS="1")   # four ranks share cores
    env.pop("PYTHONPATH", None)
    with ThreadPoolExecutor(1) as pool:
        yield out, pool.submit(run_local_ranks, [sys.executable, "-c", code],
                               4, env=env, timeout=300)


@pytest.fixture(scope="module")
def ranks(spawned):
    """The four ranks' results: a directory rank 0 wrote."""
    out, future = spawned
    for r, (rc, _out, err) in enumerate(future.result()):
        assert rc == 0, f"rank {r}: {err[-4000:]}"
    return out


def _npz(ranks, name) -> list:
    with np.load(os.path.join(ranks, name + ".npz")) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _json(ranks, name):
    with open(os.path.join(ranks, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.sharding import specs as jsp
    import types
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=jget, moe=jmoe,
                                 sp=jsp)


def _config(arch, cf=None, jx=None):
    get = get_config if jx is None else jx.get
    cfg = get(arch, smoke=True)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# (a) each shard against repro's
# ---------------------------------------------------------------------------


def _region(seed=0, T=48, cf=DROP_CF):
    """qwen3-moe smoke's expert region on numpy draws: x [T, d], the
    router's eids and weights, the whole expert stacks, dout, C."""
    cfg = _config(QWEN, cf)
    rng = np.random.RandomState(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    x = rng.randn(T, d).astype(np.float32)
    router = (0.5 * rng.randn(d, E)).astype(np.float32)
    w = {k: (rng.randn(*s) / np.sqrt(s[1])).astype(np.float32)
         for k, s in (("w1", (E, d, ff)), ("w3", (E, d, ff)),
                      ("w2", (E, ff, d)))}
    eids, weights, _ = moe._route(torch.from_numpy(x),
                                  torch.from_numpy(router), cfg)
    C = moe._capacity(eids.numel(), E, cfg.capacity_factor)
    dout = rng.randn(T, d).astype(np.float32)
    return cfg, x, eids.numpy(), weights.numpy(), w, dout, C


@pytest.mark.parametrize("M", [2, 4])
def test_each_shard_matches_repro(jx, M):
    cfg, x, eids, weights, w, dout, C = _region()
    E = cfg.n_experts
    E_loc = E // M
    T = torch.from_numpy
    J = jx.jnp.asarray
    whole = moe._expert_compute_local(T(x), T(eids), T(weights), T(w["w1"]),
                                      T(w["w3"]), T(w["w2"]), 0, E, C)
    whole_bwd = moe._expert_bwd_local(
        T(x), T(eids), T(weights), T(w["w1"]), T(w["w3"]), T(w["w2"]), 0,
        E, C, T(dout))
    assert int(whole[1]) > 0          # the capacity drops assignments
    parts, bwds, dropped = [], [], 0
    for m in range(M):
        sl = slice(m * E_loc, (m + 1) * E_loc)
        args = (x, eids, weights, w["w1"][sl], w["w3"][sl], w["w2"][sl])
        out, drop = moe._expert_compute_local(*map(T, args), m * E_loc,
                                              E_loc, C)
        jout, jdrop = jx.moe._expert_compute_local(*map(J, args), m * E_loc,
                                                   E_loc, C)
        _close(out.numpy(), jout)
        assert int(drop) == int(jdrop)
        bwd = moe._expert_bwd_local(*map(T, args), m * E_loc, E_loc, C,
                                    T(dout))
        jbwd = jx.moe._expert_bwd_local(*map(J, args), m * E_loc, E_loc, C,
                                        J(dout))
        for a, b in zip(bwd, jbwd):
            assert a.dtype == torch.float32
            _close(a.numpy(), b)
        parts.append(out)
        bwds.append(bwd)
        dropped += int(drop)
    assert dropped == int(whole[1])
    _close(sum(parts).numpy(), whole[0].numpy())
    for i in (0, 1):                  # dx and dweights: partial sums
        _close(sum(b[i] for b in bwds).numpy(), whole_bwd[i].numpy())
    for i in (2, 3, 4):               # the experts' own: joined
        _close(torch.cat([b[i] for b in bwds]).numpy(),
               whole_bwd[i].numpy())


# ---------------------------------------------------------------------------
# (b) the hand-written backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e_start,E_loc", [(0, 3), (1, 1)])
def test_ep_backward_is_the_vjp(e_start, E_loc):
    """``_EPApply`` on a group of one (its collectives the identity)
    against plain autograd of ``_expert_compute_local``, and its
    backward against finite differences, in float64 on tiny shapes with
    an assignment dropped."""
    g = torch.Generator().manual_seed(0)
    Tn, d, ff, E, K, C = 6, 4, 3, 3, 2, 2
    x = torch.randn((Tn, d), generator=g, dtype=torch.float64)
    eids = torch.stack([torch.randperm(E, generator=g)[:K]
                        for _ in range(Tn)])
    wts = torch.rand((Tn, K), generator=g, dtype=torch.float64)
    sl = slice(e_start, e_start + E_loc)
    ws = [torch.randn(s, generator=g, dtype=torch.float64)[sl]
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    assert int(moe._expert_compute_local(x, eids, wts, *ws, e_start, E_loc,
                                         C)[1]) > 0
    mesh = Mesh((1, 1), ("data", "model"))
    inputs = [t.clone().requires_grad_() for t in [x, wts] + ws]

    def ep(x_, w_, a, b, c):
        return moe._EPApply.apply(x_, eids, w_, a, b, c, mesh, e_start,
                                  E_loc, C)[0]

    dout = torch.randn((Tn, d), generator=g, dtype=torch.float64)
    got = torch.autograd.grad(ep(*inputs), inputs, dout)
    plain = moe._expert_compute_local(inputs[0], eids, inputs[1],
                                      *inputs[2:], e_start, E_loc, C)[0]
    want = torch.autograd.grad(plain, inputs, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(ep, inputs)


# ---------------------------------------------------------------------------
# (c) the loss and gradients on model shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repro_losses(jx):
    """``repro``'s loss, metrics and gradients by (arch, capacity
    factor), on the weights the ranks draw and their tokens."""
    out = {}
    for arch, _, cf in LOSS_CASES:
        if (arch, cf) in out:
            continue
        cfg, jcfg = _config(arch, cf), _config(arch, cf, jx)
        whole = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        params = jx.jax.tree_util.tree_unflatten(
            jx.jax.tree_util.tree_structure(jx.jax.eval_shape(
                lambda c=jcfg: jx.moe.init_params(jx.jax.random.PRNGKey(0),
                                                  c))),
            [jx.jnp.asarray(t.numpy()) for t in tree_leaves(whole)])
        toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
        batch = {"tokens": jx.jnp.asarray(toks.astype(np.int32))}
        (lj, mj), gj = jx.jax.jit(jx.jax.value_and_grad(
            lambda p, b, c=jcfg: jx.moe.loss_fn(p, b, c, loss_chunk=16),
            has_aux=True))(params, batch)
        out[arch, cf] = (float(lj), {k: float(v) for k, v in mj.items()},
                         [np.asarray(x) for x in
                          jx.jax.tree_util.tree_leaves(gj)])
    return out


@pytest.mark.parametrize("arch,mesh,cf", LOSS_CASES)
def test_loss_and_grads_match_repro(repro_losses, ranks, arch, mesh, cf):
    lj, mj, gj = repro_losses[arch, cf]
    got = _json(ranks, f"loss_{arch}_{mesh}")
    np.testing.assert_allclose(got["loss"], lj, rtol=1e-5)
    assert got["dropped"] == mj["dropped"]
    if cf is not None:
        assert got["dropped"] > 0
    np.testing.assert_allclose(got["aux_loss"], mj["aux_loss"], rtol=1e-6)
    gt = _npz(ranks, f"grads_{arch}_{mesh}")
    assert [g.shape for g in gt] == [g.shape for g in gj]
    for a, b in zip(gt, gj):
        _close(a, b, 1e-4)
    # the EP region against the whole region on the same inputs
    assert got["region_gap"] <= 1e-5
    assert got["region_dropped"][0] == got["region_dropped"][1]


# ---------------------------------------------------------------------------
# (d) the compressor per shard, (e) the launcher against its Dx1 twin
# ---------------------------------------------------------------------------


def test_compressor_per_shard_equals_whole(ranks):
    got = _json(ranks, "comp_bits")
    assert got["mine"] == got["whole"]
    assert got["mine"][0] == got["mine"][1]
    assert sum(got["split"]) == 9      # embed, head, 4 attn, 3 experts
    for a, b in zip(_npz(ranks, "comp_mine"), _npz(ranks, "comp_whole")):
        np.testing.assert_array_equal(a, b)


def _record(ranks, name):
    return _json(ranks, "rec_" + name.replace("/", "_").replace(":", "_"))


def _per_sync(rec, key) -> list:
    return list(np.diff([0.0] + rec[key]))


@pytest.mark.parametrize("ep,twin,run", TWINS,
                         ids=[f"{a}/{r}" for a, _, r in TWINS])
def test_launcher_equals_its_dx1_twin(ranks, ep, twin, run):
    """Equal to the twin within rounding, but where a sync's delta ties
    (the module's docstring, (e)): from the first sync whose bits part
    by tied survivors the runs have applied updates that differ in the
    tied entries, so the later losses are held within
    ``PARTED_LOSS_RTOL`` and each master leaf within ``PARTED_MASTER``
    of the twin's (relative L2)."""
    a, b = _record(ranks, f"{ep}/{run}"), _record(ranks, f"{twin}/{run}")
    M = int(ep.split("x")[1])
    assert (a["model_axis"], b["model_axis"]) == (M, 1)
    assert a["fused"] is False
    for key in ("kind", "launches_per_sync", "rounds", "n_params", "R"):
        assert a[key] == b[key], key
    assert a["bits_up"][-1] > 0
    first = len(a["loss"])
    syncs = [i for i, k in enumerate(a["kind"]) if k == "sync"]
    for key in ("bits_up", "bits_down"):
        gaps = [abs(x - y) for x, y in zip(_per_sync(a, key),
                                           _per_sync(b, key))]
        assert max(gaps) <= TIE_BITS, (key, a[key], b[key])
        for step, gap in enumerate(gaps):
            if gap and step in syncs:
                first = min(first, step + 1)
    np.testing.assert_allclose(a["loss"][:first], b["loss"][:first],
                               rtol=1e-5)
    np.testing.assert_allclose(a["loss"][first:], b["loss"][first:],
                               rtol=PARTED_LOSS_RTOL)
    arch = run.split("/")[0]
    like = moe.init_params(None, get_config(arch, smoke=True), "meta")
    tag = lambda m: "ck_" + f"{m}/{run}".replace("/", "_").replace(":", "_")
    ma = checkpoint.restore(os.path.join(ranks, tag(ep)), like, device="cpu")
    mb = checkpoint.restore(os.path.join(ranks, tag(twin)), like,
                            device="cpu")
    for x, y in zip(tree_leaves(ma), tree_leaves(mb)):
        if first == len(a["loss"]):
            torch.testing.assert_close(
                x, y, rtol=0, atol=1e-5 * float(y.abs().max()) + 1e-12)
        else:
            gap = torch.linalg.vector_norm(x - y)
            assert gap <= PARTED_MASTER * torch.linalg.vector_norm(y)


def test_refusals_that_stand():
    """The mesh fault runtime and serving above one model rank still
    raise, naming their items; the other families now take a policy of
    the model group's size (item 12c)."""
    mesh = dry_mesh("4x2")
    for arch in (QWEN, LLAMA):
        cfg = get_config(arch, smoke=True)
        assert sp.activation_policy(cfg, mesh).ep_axis == "model"
        with pytest.raises(sp.PendingPort, match="item 12d"):
            sp.activation_policy(cfg, mesh, for_serving=True)
    with pytest.raises(sp.PendingPort, match="item 12e"):
        lt.main(["--arch", QWEN, "--smoke", "--device", "cpu", "--mesh",
                 "1x2", "--faults", "preset:lossy"])
    assert sp.activation_policy(get_config("zamba2-7b", smoke=True),
                                mesh).size == 2


# ---------------------------------------------------------------------------
# no model group, the specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [QWEN, LLAMA])
def test_model_group_of_one_is_the_plain_loss(arch):
    """No policy, ``NO_SHARDING`` and a one-rank model group run the same
    operations: the loss, metrics and gradients bit for bit."""
    cfg = _config(arch, DROP_CF)
    params = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
    batch = {"tokens": torch.from_numpy(toks)}
    outs = []
    for policy in (None, NO_SHARDING, sp.activation_policy(
            cfg, Mesh((1, 1), ("data", "model")))):
        fn = value_and_grad(lambda p, b: moe.loss_fn(
            p, b, cfg, loss_chunk=16, policy=policy)[0])
        loss, grads = fn(params, batch)
        _, metrics = moe.loss_fn(params, batch, cfg, loss_chunk=16,
                                 policy=policy)
        outs.append([loss, metrics["aux_loss"], metrics["dropped"]]
                    + tree_leaves(grads))
    assert float(outs[0][2]) > 0
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [QWEN, LLAMA])
def test_moe_specs_match_repro(jx, arch):
    for smoke in (True, False):
        cfg, jcfg = get_config(arch, smoke=smoke), jx.get(arch, smoke=smoke)
        got = tree_leaves(sp.param_specs(cfg), is_leaf=sp.is_spec)
        want = jx.jax.tree_util.tree_leaves(
            jx.sp.param_specs(jcfg),
            is_leaf=lambda z: isinstance(z, jx.jax.sharding.PartitionSpec))
        assert got == [tuple(p) for p in want]
        assert sp.param_specs(cfg)["layers"]["moe"]["w1"] == (
            None, "model", None, None)


def test_layout_splits_the_experts():
    """At 16 model ranks qwen3-moe's 128 experts are 8 a rank on axis 1
    of each expert stack (compressed along their last axis, each rank
    its rows); a group that does not divide E leaves them whole."""
    cfg = get_config(QWEN)
    tree = moe.init_params(None, cfg, "meta")
    specs = sp.param_specs(cfg)
    layout = sp.shard_layout(specs, tree, dry_mesh("16x16"))
    paths = [".".join(map(str, p)) for p, _ in
             tree_flatten_with_path(tree)[0]]
    axes = dict(zip(paths, layout.axes))
    for k in ("w1", "w2", "w3"):
        assert axes[f"layers.moe.{k}"] == 1
    assert axes["layers.moe.router"] is None
    mine = dict(zip(paths, tree_leaves(sp.shard_tree(tree, layout))))
    assert tuple(mine["layers.moe.w1"].shape) == (48, 8, 2048, 768)
    odd = sp.shard_layout(specs, tree, dry_mesh("1x3"))
    assert dict(zip(paths, odd.axes))["layers.moe.w1"] is None


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dry_run_counts_the_expert_collectives():
    """qwen3-moe smoke at ``train_4k`` (global batch 256, S 4096) on
    ``4x2``: ``ok``, and the model group's all-reduce bytes a step equal
    the count from the shapes.  A rank's batch is B = 256 / 4 rows, T =
    B S tokens of d, K experts each, L MoE layers (every layer one),
    the head in n = S / c chunks of c = min(1024, S) tokens; every
    period and every head chunk is checkpointed and its recompute
    replays its forward's collectives.  Float32 (4 bytes):

    * [B, S, d]: the vocab-parallel embedding's sum, each layer's wo
      partial sums (forward and recompute) and the gradient into its
      attention (backward), the gradient into the head's chunks:
      (1 + 3 L + 1) B S d;
    * [T, d]: each MoE layer's expert partials (forward, recompute) and
      dx (backward): 3 L T d; [T, K]: the routing weights' gradient:
      L T K;
    * [B, c] a chunk: the vocab-parallel loss's max, sum and gold logit,
      forward and recompute: 6 n B c;

    int64 (8 bytes): each MoE layer's dropped count (forward, recompute),
    2 L; the sync step adds each leaf compressed by its rows on the
    rank (the survivor counts: embed, head, wq, wk, wv, wo, w1, w2,
    w3), 9."""
    rec = dr.run_one(QWEN, "train_4k", smoke=True, mesh="4x2")
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config(QWEN, smoke=True)
    S, B = 4096, 256 // 4
    T, d, K, L = B * S, cfg.d_model, cfg.moe_top_k, cfg.n_layers
    c = min(1024, S)
    n = S // c
    f32 = (4 * ((1 + 3 * L + 1) * B * S * d + 3 * L * T * d + L * T * K
                + 6 * n * B * c))
    want = {"local_step": f32 + 8 * 2 * L,
            "sync_step": f32 + 8 * (2 * L + 9)}
    for name, total in want.items():
        got = rec["steps"][name]["collectives_by_group"]["model"]
        assert got == {"all-reduce": total, "total": total}, name
