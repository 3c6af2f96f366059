"""Tensor parallelism of the dense family (``sharding/collectives.py``,
the ``model`` group of ``launch/mesh.py``, the engine on model shards,
``launch.train --mesh DxM``) against ``repro`` and against the port's
own ``Dx1`` runs, on the CPU.

One spawn of four gloo ranks (``RANK_CODE``: no JAX in the ranks) runs
every multi-rank case on sub-meshes of its world, and the tests read
what rank 0 wrote:

* (a) ``transformer.loss_fn`` on each rank's model shards at M = 2 and
  M = 4 (the gemma3-1b smoke model: 4 query heads, one 32-wide kv head,
  so k / v shards hold part of a head at both sizes and q's at M = 4
  one head), and the internvl2-26b smoke model at M = 2 (whole heads on
  every rank, an untied head, prefix embeddings), the gradients gathered
  whole, against ``repro``'s ``loss_fn`` under ``jax.value_and_grad`` on
  the same weights and tokens: the loss within 1e-5 relative, each
  gradient leaf within 1e-4 of its largest entry (tests/test_torch_lm.py's
  tolerances: float32 sums in another order, here also split over the
  ranks' partial sums);
* (b) ``ShardCompressor`` per shard at M = 2, gathered, against
  ``repro``'s on the whole leaves with the same specs: equal values,
  equal float32 bits (one leaf's counted bits pass 2^24, where summing
  the shards' float bits would round otherwise; one leaf is split on
  its only axis and is compressed whole); a QSGD policy per shard equal
  to the port's whole-leaf compression bit for bit;
* (c) the launcher at ``2x2`` against ``2x1`` on both wires and under
  ``--scenario preset:dropout``, ``1x2 --zero1`` against ``1x1 --zero1``
  on both wires, and a compressed downlink at ``1x2`` against ``1x1``:
  ledgers (bits up and down, launches a sync) equal exactly, losses
  within 1e-5 relative, the final masters within 1e-5 of their largest
  entry (the model's float32 rounding, carried through 4 steps);
* (d) the ``1x2`` run's ``--ckpt`` holds the whole master, loads in
  ``repro`` equal to the port's restore, and ``--resume`` from it at
  ``1x1`` and at ``1x2`` gives equal ledgers and losses within 1e-5.

In-process cases: the specs' placement functions against ``repro``'s, the
policy's refusals, and a model group of one leaving the loss bit for bit
as without a policy.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import NO_SHARDING, ShardingPolicy
from repro_torch.core import policy as pol
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import Mesh, dry_mesh, run_local_ranks
from repro_torch.models import transformer as tf
from repro_torch.sharding import specs as sp
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (a)'s cases: (arch, mesh)
LOSS_CASES = [("gemma3-1b", "1x2"), ("gemma3-1b", "1x4"),
              ("internvl2-26b", "1x2")]
#: (b)'s leaves: shape and spec
LEAVES = {"big": ((1024, 512), (None, "model")),
          "w": ((16, 24), (None, "model")),
          "v": ((12, 8), ("model", None)),
          "b": ((32,), ("model",)),
          "r": ((6, 10), (None, None))}
QSGD_POLICY = "r->identity;w->qsgd:s=15;.*->topk:k=0.25"
#: (c)'s launcher runs: name -> (mesh, flags); a run is compared with
#: the run of the same name at the twin mesh
WIRES = ("dense_psum", "sparse_allgather")
BIDIR = "ln|norm->identity;.*->topk:k=0.01 >> ln|norm->identity;.*->topk:k=0.05"
RUNS = {}
for _w in WIRES:
    for _m in ("2x2", "2x1"):
        RUNS[f"{_m}/{_w}"] = (_m, ["--wire", _w])
    for _m in ("1x2", "1x1"):
        RUNS[f"{_m}/zero1/{_w}"] = (_m, ["--wire", _w, "--zero1"])
for _m in ("2x2", "2x1"):
    RUNS[f"{_m}/scenario"] = (_m, ["--scenario", "preset:dropout"])
for _m in ("1x2", "1x1"):
    # a Top_k downlink after a Top_k uplink: QSGD's levels (with ties
    # after it) would make the counts hang on the last bit of the inputs
    RUNS[f"{_m}/bidir"] = (_m, ["--policy", BIDIR,
                                "--wire", "sparse_allgather"])
TWINS = [("2x2", "2x1", f"/{w}") for w in WIRES] + [
    ("1x2", "1x1", f"/zero1/{w}") for w in WIRES] + [
    ("2x2", "2x1", "/scenario"), ("1x2", "1x1", "/bidir")]
LAUNCH = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
          "--steps", "4", "--H", "2", "--seq", "16",
          "--policy", "preset:arch", "--dispatch", "kernel"]

RANK_CODE = r"""
import json, math, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.core import policy as pol
from repro_torch.launch import mesh as ms
from repro_torch.launch import train as lt
from repro_torch.models import transformer as tf
from repro_torch.sharding import specs as sp
from repro_torch.tree import tree_leaves, value_and_grad

OUT = {out!r}
LOSS_CASES, LEAVES, QSGD_POLICY = {cases!r}, {leaves!r}, {qsgd!r}
RUNS, LAUNCH = {runs!r}, {launch!r}
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", rank=rank, world_size=world)


def sub(text):
    # the mesh over world ranks 0 .. n - 1 (None on the others); every
    # rank makes every group, in one order
    dims, names = ms.parse_mesh(text)
    n = math.prod(dims)
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))) if n > 1 else None)
    mesh = ms.Mesh(dims, names, rank=rank if rank < n else 0,
                   world_size=n, backend="gloo", group=group)
    if n > 1:
        mesh.groups = ms._subgroups(mesh)
    return mesh if rank < n else None


MESHES = {{t: sub(t) for t in ("1x2", "1x4", "2x2", "2x1", "1x1")}}


def save(name, tree):
    np.savez(os.path.join(OUT, name + ".npz"),
             *[t.detach().numpy() for t in tree_leaves(tree)])


def inputs(cfg):
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
    batch = {{"tokens": torch.from_numpy(toks)}}
    if cfg.modality:
        batch["prefix_embeds"] = torch.from_numpy(0.02 * np.random.RandomState(
            2).randn(2, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32))
    return batch


# (a) the loss and its gradients on model shards
for arch, text in LOSS_CASES:
    mesh = MESHES[text]
    if mesh is None:
        continue
    cfg = get_config(arch, smoke=True)
    whole = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    layout = sp.shard_layout(sp.param_specs(cfg), whole, mesh)
    policy = sp.activation_policy(cfg, mesh)
    fn = value_and_grad(lambda p, b: tf.loss_fn(p, b, cfg, loss_chunk=16,
                                                policy=policy)[0])
    loss, grads = fn(sp.shard_tree(whole, layout), inputs(cfg))
    grads = sp.gather_tree(grads, layout, mesh)
    if rank == 0:
        save(f"grads_{{arch}}_{{text}}", grads)
        with open(os.path.join(OUT, f"loss_{{arch}}_{{text}}.json"), "w") as f:
            json.dump(float(loss), f)

# (b) the compressor on model shards
mesh = MESHES["1x2"]
if mesh is not None:
    rng = np.random.default_rng(0)
    whole, specs = {{}}, {{}}
    for k, (shape, spec) in LEAVES.items():
        d = int(np.prod(shape))
        mags = np.linspace(0.05, 4.0, d, dtype=np.float32)
        signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
        whole[k] = torch.from_numpy(
            (mags * signs)[rng.permutation(d)].reshape(shape))
        specs[k] = tuple(spec)
    layout = sp.shard_layout(specs, whole, mesh)
    mine = sp.shard_tree(whole, layout)
    shards = D.ModelShards(layout, mesh)
    comps = {{"topk": D.ShardCompressor("topk", 0.9, dispatch="kernel"),
             "signtopk": D.ShardCompressor("signtopk", 0.05,
                                           dispatch="kernel"),
             "qsgd": D.ShardCompressor.from_spec(
                 pol.parse(QSGD_POLICY), whole, dispatch="kernel")}}
    out = {{}}
    for kind, comp in comps.items():
        gen = torch.Generator().manual_seed(5)
        q, bits = comp(mine, specs, rng=gen, shards=shards)
        gen = torch.Generator().manual_seed(5)
        pays, _, cbits, mem = comp.compact(mine, specs, rng=gen,
                                           shards=shards)
        dec = [pl[1] if pl[0] == "dense" else D._decoded(
            pl, D._densify(pl[1], pl[2], pl[4], pl[3])) for pl in pays]
        dec = dict(zip(sorted(whole), dec))
        for name, tree in (("q", q), ("dec", dec), ("mem", mem)):
            tree = sp.gather_tree(tree, layout, mesh)
            if rank == 0:
                save(f"comp_{{kind}}_{{name}}", tree)
        out[kind] = [float(bits), float(cbits)]
    if rank == 0:
        with open(os.path.join(OUT, "comp_bits.json"), "w") as f:
            json.dump(out, f)

# (c) / (d) the launcher on sub-meshes
def launch(name, text, flags):
    mesh = MESHES[text]
    if mesh is None:
        return
    tag = name.replace("/", "_")
    argv = LAUNCH + ["--mesh", text, "--json",
                     os.path.join(OUT, f"rec_{{tag}}.json"),
                     "--ckpt", os.path.join(OUT, f"ck_{{tag}}")] + flags
    args = lt.parser().parse_args(argv)
    lt._run(args, lt.resolve_policy_arg(args), mesh)


for name, (text, flags) in RUNS.items():
    launch(name, text, flags)
start = os.path.join(OUT, "ck_1x2_zero1_sparse_allgather")
for text in ("1x2", "1x1"):
    launch(f"{{text}}/resume", text, ["--resume", start, "--steps", "2",
                                      "--wire", "sparse_allgather"])
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results: a directory rank 0 wrote."""
    out = str(tmp_path_factory.mktemp("tp"))
    code = RANK_CODE.format(
        src=os.path.join(REPO, "src"), out=out, cases=LOSS_CASES,
        leaves={k: (list(s), list(p)) for k, (s, p) in LEAVES.items()},
        qsgd=QSGD_POLICY, runs=RUNS, launch=LAUNCH)
    env = dict(os.environ, OMP_NUM_THREADS="1")   # four ranks share cores
    env.pop("PYTHONPATH", None)
    res = run_local_ranks([sys.executable, "-c", code], 4, env=env,
                          timeout=300)
    for r, (rc, _out, err) in enumerate(res):
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
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as jget
    from repro.configs.base import NO_SHARDING as JNO
    from repro.core import distributed as jd
    from repro.models import transformer as jtf
    from repro.sharding import specs as jsp
    from repro.train import checkpoint as jck
    import types
    return types.SimpleNamespace(jax=jax, jnp=jnp, P=P, get=jget, NO=JNO,
                                 D=jd, tf=jtf, sp=jsp, ck=jck)


# ---------------------------------------------------------------------------
# (a) the loss and gradients
# ---------------------------------------------------------------------------


def _inputs(cfg):
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 41))
    batch = {"tokens": toks.astype(np.int32)}
    if cfg.modality:
        batch["prefix_embeds"] = (0.02 * np.random.RandomState(2).randn(
            2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def repro_losses(jx):
    """``repro``'s loss and gradients by arch, on the weights the ranks
    draw (``init_params`` from one torch seed) and (a)'s inputs."""
    out = {}
    for arch in sorted({a for a, _ in LOSS_CASES}):
        cfg, jcfg = get_config(arch, smoke=True), jx.get(arch, smoke=True)
        whole = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        params = jx.jax.tree_util.tree_unflatten(
            jx.jax.tree_util.tree_structure(jx.tf.init_params(
                jx.jax.random.PRNGKey(0), jcfg)),
            [jx.jnp.asarray(t.numpy()) for t in tree_leaves(whole)])
        batch = {k: jx.jnp.asarray(v) for k, v in _inputs(cfg).items()}
        lj, gj = jx.jax.jit(jx.jax.value_and_grad(
            lambda p, b, c=jcfg: jx.tf.loss_fn(p, b, c, jx.NO,
                                               loss_chunk=16)[0]))(
            params, batch)
        out[arch] = float(lj), [np.asarray(g) for g in
                                jx.jax.tree_util.tree_leaves(gj)]
    return out


@pytest.mark.parametrize("arch,mesh", LOSS_CASES)
def test_loss_and_grads_match_repro(ranks, repro_losses, arch, mesh):
    lj, gj = repro_losses[arch]
    lt = _json(ranks, f"loss_{arch}_{mesh}")
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    gt = _npz(ranks, f"grads_{arch}_{mesh}")
    assert [g.shape for g in gt] == [g.shape for g in gj]
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_model_group_of_one_is_the_plain_loss():
    """A policy with no model group (or a one-rank mesh) runs the exact
    operations of no policy: the loss and gradients bit for bit."""
    cfg = get_config("gemma3-1b", smoke=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    outs = []
    for policy in (None, NO_SHARDING, sp.activation_policy(
            cfg, Mesh((1, 1), ("data", "model")))):
        fn = value_and_grad(lambda p, b: tf.loss_fn(
            p, b, cfg, loss_chunk=16, policy=policy)[0])
        loss, grads = fn(params, batch)
        outs.append([loss] + tree_leaves(grads))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (b) the compressor per shard
# ---------------------------------------------------------------------------


def _leaves_np():
    rng = np.random.default_rng(0)
    out = {}
    for k, (shape, _) in LEAVES.items():
        d = int(np.prod(shape))
        mags = np.linspace(0.05, 4.0, d, dtype=np.float32)
        signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
        out[k] = (mags * signs)[rng.permutation(d)].reshape(shape)
    return out


@pytest.mark.parametrize("kind,k_frac", [("topk", 0.9), ("signtopk", 0.05)])
def test_compressor_per_shard_matches_repro(ranks, jx, kind, k_frac):
    whole = _leaves_np()
    jspecs = {k: jx.P(*p) for k, (_, p) in LEAVES.items()}
    gj = {k: jx.jnp.asarray(v) for k, v in whole.items()}
    cj = jx.D.ShardCompressor(kind, k_frac, dispatch="kernel")
    from repro.compat import set_mesh
    auto = (jx.jax.sharding.AxisType.Auto,) * 2
    with set_mesh(jx.jax.make_mesh((1, 1), ("data", "model"),
                                   axis_types=auto)):
        qj, bj = jx.jax.jit(lambda g: cj(g, jspecs))(gj)

    def compact(g):
        pays, _, b, m = cj.compact(g, jspecs)
        return [pl[1:3] if pl[0] == "sparse" else pl[1:2] for pl in pays], \
            b, m

    pays, cbj, mj = jx.jax.jit(compact)(gj)
    meta = cj.leaf_meta(gj, jspecs)
    bits = _json(ranks, "comp_bits")[kind]
    assert bits == [float(bj), float(cbj)]
    if kind == "topk":
        # the big leaf's counted bits pass 2^24: float32 sums of the
        # shards' bits would not be exact
        assert float(bj) > 2 ** 24
    tol = dict(rtol=1e-6 if kind == "signtopk" else 0, atol=0)
    names = sorted(whole)
    for a, b in zip(_npz(ranks, f"comp_{kind}_q"), [qj[k] for k in names]):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    dec = [np.asarray(pl[0]) if kind_ == "dense" else np.asarray(
        jx.D._densify(pl[0], pl[1], tuple(moved), ax))
        for pl, (kind_, ax, moved) in zip(pays, meta)]
    for a, b in zip(_npz(ranks, f"comp_{kind}_dec"), dec):
        np.testing.assert_allclose(a, b, **tol)
    for a, b in zip(_npz(ranks, f"comp_{kind}_mem"), [mj[k] for k in names]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol["rtol"],
                                   atol=1e-6 if kind == "signtopk" else 0)


def test_compressor_policy_per_shard_equals_whole(ranks):
    """A QSGD leaf split over the group is quantized whole (one norm and
    one draw stream over the leaf) and each rank keeps its slice: the
    gathered result is the whole-leaf compression's, bit for bit."""
    whole = {k: torch.from_numpy(v) for k, v in _leaves_np().items()}
    specs = {k: tuple(p) for k, (_, p) in LEAVES.items()}
    comp = D.ShardCompressor.from_spec(pol.parse(QSGD_POLICY), whole,
                                       dispatch="kernel")
    q, bits = comp(whole, specs, rng=torch.Generator().manual_seed(5))
    pays, _, cbits, mem = comp.compact(
        whole, specs, rng=torch.Generator().manual_seed(5))
    dec = [pl[1] if pl[0] == "dense" else D._densify(pl[1], pl[2], pl[4],
                                                     pl[3]) for pl in pays]
    assert _json(ranks, "comp_bits")["qsgd"] == [float(bits), float(cbits)]
    for name, want in (("q", tree_leaves(q)), ("dec", dec),
                       ("mem", tree_leaves(mem))):
        for a, b in zip(_npz(ranks, f"comp_qsgd_{name}"), want):
            np.testing.assert_array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# (c) the launcher against its Dx1 twin, (d) checkpoints
# ---------------------------------------------------------------------------


def _record(ranks, name):
    return _json(ranks, "rec_" + name.replace("/", "_"))


def _master(name):
    return name.replace("/", "_")


@pytest.mark.parametrize("tp,twin,run", TWINS,
                         ids=[f"{a}{r}" for a, _, r in TWINS])
def test_launcher_equals_its_dx1_twin(ranks, tp, twin, run):
    a, b = _record(ranks, tp + run), _record(ranks, twin + run)
    M = int(tp.split("x")[1])
    assert (a["model_axis"], b["model_axis"]) == (M, 1)
    assert a["fused"] is False
    for key in ("bits_up", "bits_down", "kind", "launches_per_sync",
                "rounds", "n_params", "R"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    like = tf.init_params(None, get_config("gemma3-1b", smoke=True), "meta")
    ma = checkpoint.restore(os.path.join(ranks, "ck_" + _master(tp + run)),
                            like, device="cpu")
    mb = checkpoint.restore(os.path.join(ranks, "ck_" + _master(twin + run)),
                            like, device="cpu")
    for x, y in zip(tree_leaves(ma), tree_leaves(mb)):
        torch.testing.assert_close(
            x, y, rtol=0, atol=1e-5 * float(y.abs().max()) + 1e-12)


def test_checkpoint_loads_in_repro_and_resumes(ranks, jx):
    ck = os.path.join(ranks, "ck_1x2_zero1_sparse_allgather")
    like = tf.init_params(None, get_config("gemma3-1b", smoke=True), "meta")
    mine = tree_leaves(checkpoint.restore(ck, like, device="cpu"))
    jlike = jx.tf.init_params(jx.jax.random.PRNGKey(0),
                              jx.get("gemma3-1b", smoke=True))
    theirs = jx.jax.tree_util.tree_leaves(jx.ck.restore(ck, jlike))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert jx.ck.load_policy(ck).to_string() == \
        checkpoint.load_policy(ck).to_string()
    a, b = _record(ranks, "1x2/resume"), _record(ranks, "1x1/resume")
    assert a["bits_up"] == b["bits_up"] and a["bits_down"] == b["bits_down"]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    # the resumed run starts from the checkpoint: its first loss is the
    # trained model's, below the seed's first loss
    first = _record(ranks, "1x2/zero1/sparse_allgather")["loss"][0]
    assert b["loss"][0] < first


# ---------------------------------------------------------------------------
# the specs' placement functions (in process)
# ---------------------------------------------------------------------------


def test_head_divisibility_and_batch_specs_match_repro(jx):
    for arch in sorted(ARCHS):
        for m in (1, 2, 16):
            assert sp.head_divisibility_note(get_config(arch), m) == \
                jx.sp.head_divisibility_note(jx.get(arch), m), (arch, m)
    for kind in ("train", "decode"):
        for axes in (("data",), ("pod", "data")):
            want = jx.sp.batch_specs(kind, axes)
            got = sp.batch_specs(kind, axes)
            assert {k: tuple(v) for k, v in want.items()} == got


def test_layout_and_shards_on_a_mesh():
    """``shard_layout`` splits each leaf where ``sanitize_spec`` keeps its
    ``model`` entry (internvl2-26b's 92553-row vocab stays whole at 16)
    and ``shard_tree`` keeps a rank's slice of it."""
    cfg = get_config("internvl2-26b")
    mesh = dry_mesh("16x16")
    tree = tf.init_params(None, cfg, "meta")
    layout = sp.shard_layout(sp.param_specs(cfg), tree, mesh)
    flat = dict(zip(
        ["embed", "final_norm", "head", "wk", "wo", "wq", "wv", "ln1",
         "ln2", "w1", "w2", "w3"], layout.axes))
    assert flat["embed"] is None and flat["final_norm"] is None
    assert flat["head"] is None          # 92553 !% 16: whole
    assert (flat["wq"], flat["wo"], flat["w1"], flat["w2"]) == (2, 1, 2, 1)
    assert layout.numel() == sum(t.numel() for t in tree_leaves(tree))
    mine = sp.shard_tree(tree, layout)
    got = dict(zip(flat, [tuple(t.shape) for t in tree_leaves(mine)]))
    assert got["wq"] == (48, 6144, 6144 // 16)
    assert got["w2"] == (48, 16384 // 16, 6144)
    assert got["head"] == (6144, 92553)
    with pytest.raises(ValueError, match="'model' only"):
        sp.model_axis((("data", "model"), None), (512, 4), mesh)


def test_policy_refusals():
    mesh = dry_mesh("4x2")
    # RWKV-6 and Zamba2 train on the model group (item 12c)
    for arch in ("rwkv6-3b", "zamba2-7b"):
        policy = sp.activation_policy(get_config(arch, smoke=True), mesh)
        assert (policy.size, policy.ep_axis) == (2, None)
    # the MoE family trains expert-parallel on the model group (item 12b)
    moe_policy = sp.activation_policy(
        get_config("qwen3-moe-30b-a3b", smoke=True), mesh)
    assert (moe_policy.size, moe_policy.ep_axis) == (2, "model")
    cfg = get_config("yi-6b", smoke=True)
    with pytest.raises(sp.PendingPort, match="item 12d"):
        sp.activation_policy(cfg, mesh, for_serving=True)
    policy = sp.activation_policy(cfg, mesh)
    assert policy.size == 2 and policy.splits(512) and not policy.splits(7)
    assert sp.activation_policy(cfg, dry_mesh("8x1")) == ShardingPolicy()
    assert sp.activation_policy(get_config("qwen3-moe-30b-a3b"),
                                dry_mesh("8x1")).ep_axis == "model"


def test_mesh_coordinates_and_groups():
    mesh = Mesh((2, 3, 4), ("pod", "data", "model"), rank=17,
                world_size=24)
    assert mesh.coords() == {"pod": 1, "data": 1, "model": 1}
    assert (mesh.worker, mesh.model_rank, mesh.workers) == (4, 1, 6)
    assert [mesh.size(g) for g in ("data", "model", "world")] == [6, 4, 24]
    dm = dry_mesh("2x16x16")
    assert dm.world_size == 512 and dm.workers == 32
    x = torch.empty((3, 5), device="meta")
    assert tuple(dm.all_gather(x, over="model").shape) == (16, 3, 5)
    dm.all_reduce_sum(x)
    assert [e[3] for e in dm.events] == ["model", "data"]


@pytest.mark.parametrize("compact", [True, False])
def test_tune_plans_are_the_shards(compact):
    """``--tune``'s work list above one model rank: the launches a rank
    makes on its own rows, gemma3-1b's full config at ``1x2`` on
    ``meta`` under ``preset:arch`` (QSGD on the embedding, Top_k on the
    seven stacks): half of each stack's rows, k = 12 of 1152."""
    from repro_torch.configs import get_policy_preset
    cfg = get_config("gemma3-1b")
    whole = tf.init_params(None, cfg, "meta")
    spec = pol.as_channel_spec(get_policy_preset("arch", arch="gemma3-1b"))
    comp = D.ShardCompressor.from_spec(spec.uplink, whole)
    mesh = dry_mesh("1x2")
    layout = sp.shard_layout(sp.param_specs(cfg), whole, mesh)
    keys = comp.launch_plans(sp.shard_tree(whole, layout),
                             sp.param_specs(cfg), compact=compact,
                             shards=D.ModelShards(layout, mesh))
    kernel = "topk_compact" if compact else "topk_compress"
    assert sorted((k.kernel, k.rows, k.row_len, k.k) for k in keys) == [
        (kernel, rows, 1152, 12) for rows in (3328, 13312, 89856)]
