"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the
twins of ``tests/test_dryrun.py`` and the kernels' ``meta`` route.

* ``repro``'s eight smoke combos at ``8x1`` with its reduced shapes:
  ``ok`` with FLOPs, storage and collectives (``yi-34b x long_500k``
  skipped); the sparse wire; a ``model`` axis above 1 recorded as an
  error naming its ROADMAP item where it is not ported (the other
  families' training, serving); the CLI writing its records.
* The eight kernel wrappers on ``meta`` tensors: the plain versions'
  output shapes and dtypes, one count each in ``LAUNCHES``, the
  launch's ``roofline.kernel_cost`` in the measured step, and no call
  into the kernel library or the tuning table.
* The counts: the dense smoke transformer's FLOPs against an analytic
  count of its products; a step's FLOPs and launches on the CPU equal to
  the dry run's on meta; the storage meter on a known allocation
  pattern; the parameter counts of all ten full configs.
* The collectives: one spawn of two gloo ranks, each wire's sync step
  profiled, equal by kind and in total to the dry run at ``2x1``.
"""

import json
import os
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import _build
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import qsgd as qk
from repro_torch.kernels import sparse_gemm as sg
from repro_torch.kernels import topk_compress as tk
from repro_torch.kernels.launch_stats import (LAUNCHES, TUNE_CACHE,
                                              reset_launches,
                                              reset_tune_cache)
from repro_torch.launch import dryrun as dr
from repro_torch.sharding import specs as sp
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import dry_mesh, run_local_ranks
from repro_torch.models import get_model
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")

#: tests/test_dryrun.py's reduced shapes and combos
SHAPES = {
    "train_4k": InputShape("train_4k", 64, 8, "train"),
    "prefill_32k": InputShape("prefill_32k", 64, 4, "prefill"),
    "decode_32k": InputShape("decode_32k", 64, 8, "decode"),
    "long_500k": InputShape("long_500k", 128, 1, "decode"),
}
COMBOS = [
    ("yi-6b", "train_4k"), ("yi-6b", "decode_32k"),
    ("gemma3-1b", "long_500k"),
    ("qwen3-moe-30b-a3b", "train_4k"),
    ("rwkv6-3b", "long_500k"),
    ("zamba2-7b", "train_4k"),
    ("musicgen-medium", "prefill_32k"),
    ("yi-34b", "long_500k"),          # must be skipped
]


@pytest.fixture(autouse=True)
def _launches():
    reset_launches()
    yield
    reset_launches()


# ---------------------------------------------------------------------------
# the dry run (twins of tests/test_dryrun.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_dryrun_smoke_path(arch, shape):
    rec = dr.run_one(arch, shape, shape=SHAPES[shape], smoke=True,
                     mesh="8x1")
    if (arch, shape) == ("yi-34b", "long_500k"):
        assert rec["status"] == "skipped", rec
        return
    assert rec["status"] == "ok", (arch, shape, rec.get("error"),
                                   rec.get("traceback"))
    assert rec["mesh"] == "8x1" and rec["n_devices"] == 8
    assert rec["n_workers"] == 8 and rec["model_axis"] == 1
    names = ({"sync_step", "local_step"} if SHAPES[shape].kind == "train"
             else {SHAPES[shape].kind})
    assert set(rec["steps"]) == names
    for step in rec["steps"].values():
        assert step["flops"] > 0
        assert step["memory"]["temp_bytes"] >= 0
        assert step["memory"]["argument_bytes"] > 0
        assert "collectives" in step and "total" in step["collectives"]
        assert step["bytes_accessed"] > 0
    assert rec["fits"] and rec["dtype"] == "float32"
    if SHAPES[shape].kind == "train":
        sync = rec["steps"]["sync_step"]
        # the dense wire's all-reduces, the loss's mean among them
        assert sync["collectives"]["all-reduce"] > 0
        assert rec["steps"]["local_step"]["collectives"] == {
            "all-reduce": 4, "total": 4}
        assert sync["launches"].get("topk_compress", 0) > 0
        assert rec["device_batch"] == 1
    else:
        assert rec["steps"][SHAPES[shape].kind]["collectives"] == {
            "total": 0}


def test_prefill_cache_length():
    """``max_len`` sizes a prefill's cache past its prompt (as a server
    does for the tokens it will add): the outputs grow by exactly the
    longer cache's blocks; a cache shorter than the prompt is an error
    record."""
    shape = SHAPES["prefill_32k"]
    cfg = get_config("yi-6b", smoke=True)
    recs = {n: dr.run_one("yi-6b", "prefill_32k", shape=shape, smoke=True,
                          mesh="8x1", max_len=n)
            for n in (None, shape.seq_len + 24)}
    assert recs[None]["max_len"] == shape.seq_len
    assert recs[shape.seq_len + 24]["max_len"] == shape.seq_len + 24

    def cache_blocks(n):
        cache = dr.cache_shardings(cfg, dr.dry_mesh("8x1"),
                                   shape.global_batch, n)
        return sum(dr._blocks(t.untyped_storage().nbytes())
                   for t in tree_leaves(cache))

    out = [recs[n]["steps"]["prefill"]["memory"]["output_bytes"]
           for n in (None, shape.seq_len + 24)]
    assert out[1] - out[0] == (cache_blocks(shape.seq_len + 24)
                               - cache_blocks(shape.seq_len)) > 0
    bad = dr.run_one("yi-6b", "prefill_32k", shape=shape, smoke=True,
                     mesh="8x1", max_len=shape.seq_len - 1)
    assert bad["status"] == "error" and "max_len" in bad["error"]


def test_dryrun_sparse_allgather():
    rec = dr.run_one("yi-6b", "train_4k", shape=SHAPES["train_4k"],
                     smoke=True, mesh="8x1", aggregate="sparse_allgather")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["aggregate"] == "sparse_allgather"
    sync = rec["steps"]["sync_step"]
    assert sync["flops"] > 0
    assert sync["collectives"]["all-gather"] > 0
    assert set(sync["launches"]) == {"topk_compact"}


#: the records a model axis above 1 refuses, by case: serving (item
#: 12d), for a family that trains on the model axis (rwkv6-3b, item 12c,
#: its train_4k record computed) and for the dense family
UNPORTED_TP = {"train_4k": ("rwkv6-3b", "prefill_32k", "12d"),
               "decode_32k": ("yi-6b", "decode_32k", "12d")}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_model_axis_is_an_error_record(shape):
    arch, refused, item = UNPORTED_TP[shape]
    if shape == "train_4k":
        rec = dr.run_one(arch, shape, shape=SHAPES[shape], smoke=True,
                         mesh="4x2")
        assert rec["status"] == "ok", rec.get("error")
    rec = dr.run_one(arch, refused, shape=SHAPES[refused], smoke=True,
                     mesh="4x2")
    assert rec["status"] == "error"
    assert rec["error"].startswith("PendingPort")
    assert f"ROADMAP queue 1 item {item}" in rec["error"]
    assert rec["mesh"] == "4x2" and rec["pending"] and dr.pending(rec)


@pytest.mark.parametrize("exc, pending", [
    (sp.PendingPort("not ported (ROADMAP queue 1 item 12c)"), True),
    (NotImplementedError("not ported (ROADMAP queue 1 item 12c)"), False)])
def test_pending_is_the_refusal_type(exc, pending, monkeypatch):
    """A record is pending (no failure of the CLI) by the type of its
    refusal, ``PendingPort``, not by its text."""
    def refuse(*args, **kw):
        raise exc

    monkeypatch.setattr(dr, "lower_train", refuse)
    rec = dr.run_one("yi-6b", "train_4k", shape=SHAPES["train_4k"],
                     smoke=True, mesh="8x1")
    assert rec["status"] == "error" and "item 12c" in rec["error"]
    assert dr.pending(rec) is pending


def test_tensor_parallel_records(tmp_path, monkeypatch):
    """With no ``--mesh`` a training shape runs on ``dp256`` and on
    ``repro``'s production mesh ``16x16``: the dense family's record is
    ``ok``, its rank holding 1/16 of each split leaf (the arguments: the
    step's state, within the few small leaves a model group keeps whole,
    the norms, and the batch), its tensor-parallel collectives apart
    from the data group's; so is RWKV-6's, its 8 heads straddling the
    16 ranks (gathered whole)."""
    monkeypatch.chdir(tmp_path)
    recs = dr.main(["--arch", "yi-6b", "--shape", "train_4k", "--smoke"],
                   shapes=SHAPES)
    assert [r["mesh"] for r in recs] == ["dp256", "16x16"]
    dp, tp = recs
    assert tp["status"] == "ok", tp.get("error")
    assert (tp["model_axis"], tp["n_workers"], tp["n_devices"]) == (
        16, 16, 256)
    assert tp["head_divisibility_note"] == "clean"
    for name in ("sync_step", "local_step"):
        a = dp["steps"][name]["memory"]["argument_bytes"]
        b = tp["steps"][name]["memory"]["argument_bytes"]
        assert a / 16 < b < 1.1 * a / 16, (name, a, b)
        groups = tp["steps"][name]["collectives_by_group"]
        assert groups["model"]["all-reduce"] > 0
        assert groups["model"]["all-gather"] > 0   # 8 heads on 16 ranks
        assert groups["data"]["total"] > 0
        assert (groups["model"]["total"] + groups["data"]["total"]
                == tp["steps"][name]["collectives"]["total"])
        assert set(dp["steps"][name]["collectives_by_group"]) == {"data"}
    recs = dr.main(["--arch", "rwkv6-3b", "--shape", "train_4k",
                    "--smoke", "--mesh", "16x16"], shapes=SHAPES)
    assert recs[0]["status"] == "ok", recs[0].get("error")
    groups = recs[0]["steps"]["sync_step"]["collectives_by_group"]
    assert groups["model"]["all-gather"] > 0   # 8 heads on 16 ranks


def test_default_meshes():
    rec = dr.run_one("gemma3-1b", "long_500k", smoke=True)
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["mesh"], rec["n_devices"], rec["n_workers"]) == (
        "dp256", 256, 256)
    rec = dr.run_one("gemma3-1b", "long_500k", smoke=True, multi_pod=True)
    assert (rec["mesh"], rec["n_devices"], rec["n_workers"]) == (
        "dp2x128", 256, 256)
    assert rec["device_batch"] == 1


def test_main_writes_records(tmp_path, monkeypatch, capsys):
    """The CLI over every arch and shape (the reduced shapes: the smoke
    configs' 32-wide query chunks make the full ones' hundreds of
    thousands of meta ops) writes a record each, and the roofline report
    reads them.  ``--all`` runs over one arch here, with a shape it
    skips: the combos above drive every family's steps."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dr, "ARCHS", {"yi-34b": ARCHS["yi-34b"]})
    recs = dr.main(["--all", "--smoke", "--mesh", "8x1"], shapes=SHAPES)
    files = sorted(os.listdir(tmp_path / "artifacts" / "dryrun"))
    assert len(files) == len(recs) == 4
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    assert sum(r["status"] == "skipped" for r in recs) == 1
    assert "[ok     ] yi-34b x train_4k x 8x1" in capsys.readouterr().out
    with open(tmp_path / "artifacts" / "dryrun" / files[0]) as f:
        assert json.load(f) == recs[0]
    table = rl.main(["--art-dir", str(tmp_path / "artifacts" / "dryrun"),
                     "--out", str(tmp_path / "roofline.md")])
    assert table.count("\n") == 1 + sum(r["status"] == "ok" for r in recs)


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)
    acc = torch.randn((4, 256), generator=g)
    u = torch.rand((4, 256), generator=g)
    x = torch.randn((3, 256), generator=g)
    idx = torch.full((5, 128), 256, dtype=torch.int32)
    idx[:, :4] = torch.arange(4, dtype=torch.int32) * 7
    val = torch.randn((5, 128), generator=g) * (idx < 256)
    lv = torch.randint(-15, 16, (5, 256), generator=g, dtype=torch.int8)
    scale = torch.rand((5, 1), generator=g)
    q = torch.randn((1, 16, 4, 32), generator=g)
    k = torch.randn((1, 16, 2, 32), generator=g)
    qd = torch.randn((2, 1, 4, 32), generator=g)
    kd = torch.randn((2, 20, 2, 32), generator=g)
    valid = torch.arange(20)[None, :] < torch.tensor([[9], [20]])
    kp = torch.randn((6, 4, 2, 32), generator=g)
    ks = torch.rand((6, 4), generator=g)
    tables = torch.tensor([[0, 2, -1], [1, 3, 4]], dtype=torch.int32)
    lengths = torch.tensor([6, 11], dtype=torch.int32)
    return [
        ("topk_compress", lambda a: tk.topk_compress(a, 8), (acc,)),
        ("topk_compact", lambda a: tk.topk_compact(a, 8, 128), (acc,)),
        ("qsgd", lambda a, b: qk.qsgd_quantize(a, b, 15), (acc, u)),
        ("sparse_gemm", lambda *a: sg.sparse_gemm(*a, 256), (x, idx, val)),
        ("sparse_gemm", lambda *a: sg.sparse_gemm_route(*a, 256, "decode"),
         (x, idx, val)),
        ("qdq_gemm", sg.qdq_gemm, (x, lv, scale)),
        ("flash_attention", lambda *a: fa.flash_attention_fwd(*a, window=8),
         (q, k, k.clone())),
        ("flash_decode", fa.flash_decode, (qd, kd, kd, valid)),
        ("paged_decode", pa.paged_decode,
         (qd, kp, kp, ks, ks, tables, lengths)),
    ]


CASES = _wrapper_cases()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_meta_branch_shapes(case, monkeypatch):
    """A wrapper given meta tensors: the plain version's output shapes
    and dtypes, one launch counted, its kernel_cost in the measured step,
    and no call into the kernel library."""
    name, call, args = CASES[case]
    want = call(*args)
    assert LAUNCHES[name] == 1
    monkeypatch.setattr(_build, "load", lambda: pytest.fail(
        "a meta launch called the kernel library"))
    margs = tuple(a.to(META) for a in args)
    got, step = dr.measure(call, margs)
    assert LAUNCHES[name] == 2 and step["launches"] == {name: 1}
    want_t, got_t = dr._tensors(want), dr._tensors(got)
    assert [(t.shape, t.dtype) for t in got_t] == [
        (t.shape, t.dtype) for t in want_t]
    assert all(t.device.type == "meta" for t in got_t)
    assert step["kernel_flops"] > 0 and step["flops"] == step[
        "kernel_flops"]


def test_meta_kernel_cost_reaches_the_step():
    acc = torch.empty((6, 1152), device=META)
    _, step = dr.measure(lambda a: tk.topk_compact(a, 12, 128), (acc,))
    nbytes, ops, _ = rl.kernel_cost("topk_compact", rows=6, n=1152,
                                    kcap=128)
    assert step["kernel_flops"] == ops
    assert step["bytes_accessed"] == nbytes     # empty outputs move none


def test_dispatch_routes_meta_to_the_kernels():
    """"auto" takes meta for the card: the Top_k leaves go to the
    wrappers' meta branches, with no tuning-table lookup."""
    assert dsp.DispatchConfig().kernels_enabled(META)
    assert not dsp.DispatchConfig(mode="reference").kernels_enabled(META)
    assert not dsp.DispatchConfig().kernels_enabled("cpu")
    from repro_torch.core.operators import TopK
    grads = {"w": torch.empty((512, 256), device=META),
             "b": torch.empty((8,), device=META)}
    reset_tune_cache()
    out, bits = dsp.compress_tree(TopK(k=0.01), None, grads)
    assert LAUNCHES["topk_compress"] == 1 and TUNE_CACHE == {"hit": 0,
                                                             "miss": 0}
    assert out["w"].device.type == "meta" and out["w"].shape == (512, 256)
    assert bits.device.type == "meta"


def test_meta_branch_keeps_the_checks():
    with pytest.raises(ValueError):
        tk.topk_compress(torch.empty((2, 64), device=META), 65)
    with pytest.raises(ValueError):
        tk.topk_compress(torch.empty((2, 64), device=META), 4, cluster=8)
    q = torch.empty((1, 1, 4, 12), device=META)
    with pytest.raises(ValueError):      # the card's head-width rule
        fa.flash_decode(q, torch.empty((1, 8, 2, 12), device=META),
                        torch.empty((1, 8, 2, 12), device=META),
                        torch.ones(8, dtype=torch.bool, device=META))
    assert LAUNCHES["topk_compress"] == LAUNCHES["flash_decode"] == 0
    with pytest.raises(ValueError):
        _build.device_of(torch.empty(1), torch.empty(1, device=META))


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------


def test_flops_match_an_analytic_count():
    """The dense smoke transformer's step: every product of the forward
    (projections, SwiGLU, the two attention einsums over every (query,
    key) pair of a chunk, the tied head), twice that in the backward,
    and the layers' and loss chunks' recompute under remat, which ends
    at the last op whose output the backward keeps (a layer's w2 product
    is not recomputed: torch.utils.checkpoint stops early)."""
    cfg = get_config("gemma3-1b", smoke=True)
    sh = InputShape("t", 64, 16, "train")
    rec = dr.run_one("gemma3-1b", shape=sh, smoke=True, mesh="8x1")
    B, S = 2, sh.seq_len
    T = B * S
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ff, V, L = cfg.d_ff, cfg.vocab, cfg.n_layers
    w2 = 2 * T * ff * d
    layer = (2 * T * d * H * hd + 2 * 2 * T * d * KV * hd
             + 2 * T * H * hd * d + 2 * 2 * T * d * ff + w2
             + 2 * 2 * B * S * S * H * hd)
    fwd = L * layer + 2 * T * d * V
    want = fwd + 2 * fwd + (fwd - L * w2)
    for name, step in rec["steps"].items():
        assert step["flops"] - step["kernel_flops"] == want, name
        assert step["flops_by_dtype"] == {"float32": want}
    assert rec["steps"]["local_step"]["kernel_flops"] == 0
    assert rec["steps"]["sync_step"]["kernel_flops"] > 0


@pytest.mark.parametrize("wire", ["dense_psum", "sparse_allgather"])
def test_cpu_step_counts_equal_the_dry_run(wire):
    """The card check's twin: the same job on the CPU (a real one-rank
    mesh; dispatch "kernel", the kernels' plain versions through their
    wrappers) counts the FLOPs of the job on meta exactly, makes its
    launches and takes its arguments' bytes."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("gemma3-1b", smoke=True)
    sh = InputShape("cell", 32, 2, "train")
    runs = {}
    for dev, mesh in (("meta", dry_mesh("1x1")),
                      ("cpu", Mesh((1, 1), ("data", "model")))):
        job = dr.build_train("gemma3-1b", cfg, mesh, sh, aggregate=wire,
                             policy="preset:arch", device=dev,
                             dispatch="kernel")
        state = dr.steady_state(job.init_fn(job.params))
        runs[dev] = {name: dr.measure(job.steps[name], (state, job.batch),
                                      mesh)[1]
                     for name in ("sync_step", "local_step")}
    for name, want in runs["meta"].items():
        got = runs["cpu"][name]
        assert got["flops"] == want["flops"], name
        assert got["launches"] == want["launches"], name
        assert got["memory"]["argument_bytes"] == want["memory"][
            "argument_bytes"]
    kern = "topk_compact" if wire == "sparse_allgather" else "topk_compress"
    assert set(runs["meta"]["sync_step"]["launches"]) == {kern}


def test_step_meter_storage():
    """Arguments counted once (views share storage), temporaries from
    creation to death in whole 512-byte blocks, outputs that are an
    argument's storage as aliases."""
    x = torch.empty((1000,), device=META)

    def step(a, view):
        b = a * 2.0                      # 4000 -> 4096 live
        c = b + 1.0                      # 8192
        del b                            # 4096
        d = torch.empty((10,), device=META)   # 4608
        e = c.reshape(10, 100) @ torch.empty((100, 3), device=META)  # 6656
        return c, a, d, e

    _, st = dr.measure(step, (x, x[:10]))
    mem = st["memory"]
    assert mem["argument_bytes"] == 4096
    assert mem["temp_bytes"] == 4096 * 2
    assert mem["alias_bytes"] == 4096
    assert mem["output_bytes"] == 4096 + 4096 + 512 + 512
    assert st["flops"] == 2 * 10 * 100 * 3


def test_params_of_every_full_config():
    """``params`` is ``cfg.param_count()`` (``repro``'s analytic count)
    and ``tree_params`` the meta tree's, for all ten full configs; they
    agree but for RWKV-6 and Zamba2, whose analytic counts are
    ``repro``'s approximations.  A full-size record carries them (one
    arch: a full config's meta step costs seconds, and the combos and
    the card's full-size dry runs drive the steps)."""
    gaps = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        tree = get_model(cfg).init_params(None, cfg, device=META)
        numel = sum(t.numel() for t in tree_leaves(tree))
        fields = dr.param_fields(cfg)
        assert fields["params"] == cfg.param_count()
        assert fields["tree_params"] == numel
        assert fields["active_params"] == cfg.active_param_count()
        if numel != cfg.param_count():
            gaps[arch] = numel - cfg.param_count()
    assert gaps == {"rwkv6-3b": 430_243_840, "zamba2-7b": 36_589_264}
    rec = dr.run_one("rwkv6-3b", shape=InputShape("tiny", 8, 256, "decode"))
    assert rec["status"] == "ok", rec.get("error")
    assert {k: rec[k] for k in fields} == dr.param_fields(
        get_config("rwkv6-3b"))


# ---------------------------------------------------------------------------
# the collectives of two gloo ranks
# ---------------------------------------------------------------------------

RANK_CODE = r"""
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh("2x1", device="cpu", backend="gloo")
try:
    out = dryrun.profile_sync_collectives(
        "gemma3-1b", get_config("gemma3-1b", smoke=True), mesh,
        InputShape("ranks", 32, 2, "train"),
        ("dense_psum", "sparse_allgather"), "cpu")
    if mesh.rank == 0:
        print("COLLECTIVES " + json.dumps(out))
finally:
    mesh.close()
"""


def test_gloo_collectives_equal_the_dry_run():
    env = dict(os.environ, OMP_NUM_THREADS="1")   # two ranks share cores
    env.pop("PYTHONPATH", None)
    ranks = run_local_ranks(
        [sys.executable, "-c",
         RANK_CODE.format(src=os.path.join(REPO, "src"))], 2, env=env,
        timeout=120)
    for rc, _out, err in ranks:
        assert rc == 0, err[-3000:]
    line = next(l for l in ranks[0][1].splitlines()
                if l.startswith("COLLECTIVES "))
    got = json.loads(line[len("COLLECTIVES "):])
    for wire in ("dense_psum", "sparse_allgather"):
        rec = dr.run_one("gemma3-1b", shape=InputShape("ranks", 32, 2,
                                                       "train"),
                         smoke=True, mesh="2x1", aggregate=wire)
        assert rec["status"] == "ok", rec.get("error")
        want = rec["steps"]["sync_step"]["collectives"]
        assert got[wire] == want, wire
        assert want["total"] > 0
    assert "all-gather" in got["sparse_allgather"]
