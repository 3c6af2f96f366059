"""The launch-geometry autotuner of the port (``repro_torch.kernels.
autotune``), on the CPU: a twin of ``tests/test_autotune.py``.

* The table: round trip, a missing table that stays silent, corrupt /
  stale / foreign tables that load as empty with one warning, malformed
  entries skipped one by one, the LRU and its ``TUNE_CACHE`` counters,
  the card kind's name, a save through a temporary file of the process.
* Resolution: an explicit ``DispatchConfig.block_rows`` beats the table
  beats the kernel's own pick, at every launch site of the dispatcher
  (the geometry each wrapper is handed is recorded); a value the
  launch's kernel cannot take raises, an entry it cannot take is passed
  over.
* ``tune`` on the CPU (``device="cpu"``: the plain versions timed)
  measures, caches and re-measures; ``tune_for_run`` covers
  ``launch_plans``, which equals ``repro``'s on numpy-made trees; the
  CLI smoke runs twice.
* The repaired reductions: ``ref.qsgd_cluster_ref`` and the cluster
  SignTop_k scale of ``ref.topk_threshold_levels_ref`` give one float at
  every cluster size the kernels take, bit for bit, on hypothesis rows
  (the tolerance against the plain versions and ``repro`` is held in
  ``test_torch_qsgd_cluster.py`` / ``test_torch_topk_levels.py``).
* Whole runs: ``RunConfig(tune=True)`` gives the untuned History; the
  launcher's ``--tune`` prints its line and keeps its log.

The ``gpu`` cases run each kernel at every geometry the card takes, bit
for bit against the kernel's own pick and against the models, which
they compute on the card: torch's CPU float32 ``sqrt`` is not correctly
rounded near a tie, the card's and the kernels' are.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import autotune as at
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels import launch_stats as ls
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import qsgd as qk
from repro_torch.kernels import ref
from repro_torch.kernels import topk_compress as tk
from repro_torch.kernels.launch_stats import TUNE_CACHE, reset_tune_cache
from test_torch_topk_levels import ROW_KINDS, make_row

KCFG = dict(mode="kernel")   # the kernel path (the plain versions here)
CPU = "cpu"                  # every table here is the CPU's, card or not


@pytest.fixture(autouse=True)
def isolated_table(tmp_path):
    """A throwaway table directory for every test, the default after."""
    at.configure(str(tmp_path))
    reset_tune_cache()
    yield
    at.configure(at.DEFAULT_TABLE_DIR)


def _entry(br, us=12.5):
    return at.TunedEntry(br, None, us)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


def test_table_roundtrip():
    k1 = at.ShapeKey("topk_compress", 4, 16384, 16, False)
    k2 = at.ShapeKey("topk_compact", 2, 256, 8, True)
    assert k1.as_str() == "topk_compress|f32|4|16384|16|0"
    path = at.save_table({k1.as_str(): _entry(16)}, device=CPU)
    assert at.load_table(path, CPU)[k1.as_str()].block_rows == 16
    at.save_table({k2.as_str(): _entry(2)}, device=CPU)   # merges
    loaded = at.load_table(path, CPU)
    assert set(loaded) == {k1.as_str(), k2.as_str()}
    assert loaded[k2.as_str()] == _entry(2)
    at.clear_cache()
    assert at.lookup("topk_compact", 2, 256, 8, True,
                     device=CPU) == loaded[k2.as_str()]
    assert json.load(open(path))["device_kind"] == at.device_kind(CPU) == \
        "cpu"


def test_missing_table_is_empty_and_silent():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert at.load_table(device=CPU) == {}
        assert at.lookup("topk_compress", 1, 256, 8, False,
                         device=CPU) is None


@pytest.mark.parametrize("payload,reason", [
    ("{not json", "corrupt"),
    (json.dumps({"version": 999, "entries": {}}), "stale"),
    (json.dumps([1, 2, 3]), "stale"),
    (None, "tuned for"),   # another card kind's table, written below
])
def test_bad_tables_load_safe(payload, reason):
    path = at.table_path(device=CPU)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if payload is None:
        payload = json.dumps({
            "version": at.TABLE_VERSION,
            "device_kind": "nvidia_h100_80gb_hbm3",
            "entries": {"qsgd|f32|1|4096|15|0": {"block_rows": 2}}})
    with open(path, "w") as f:
        f.write(payload)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        assert at.load_table(device=CPU) == {}
        assert at.load_table(device=CPU) == {}    # warned once
    assert len(wlog) == 1, [str(w.message) for w in wlog]
    assert reason in str(wlog[0].message)
    assert at.lookup("qsgd", 1, 4096, 15, False, device=CPU) is None


def test_malformed_entries_skipped_individually():
    good = at.ShapeKey("qsgd", 4, 8192, 15, False)
    path = at.table_path(device=CPU)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "version": at.TABLE_VERSION, "device_kind": at.device_kind(CPU),
            "entries": {
                good.as_str(): {"block_rows": 4, "chunk": None, "us": 1.0},
                "nonsense-key": {"block_rows": 4},
                "flash_decode|f32|1|256|8|0": {"block_rows": 1},
                "qsgd|f32|1|256|8|0": {"block_rows": "eight"},
                "qsgd|f32|2|256|8|0": {"block_rows": 0},
                "qsgd|f32|3|256|8|0": {"block_rows": True},
                # the port derives every chunk from the geometry
                "topk_compact|f32|1|256|8|0": {"block_rows": 1,
                                               "chunk": 128},
            }}, f)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        loaded = at.load_table(device=CPU)
    assert set(loaded) == {good.as_str()}
    assert len(wlog) == 1   # once a file, not once an entry


def test_lookup_lru_counters(monkeypatch):
    key = at.ShapeKey("qsgd", 4, 8192, 15, False)
    at.save_table({key.as_str(): _entry(4)}, device=CPU)
    at.clear_cache()
    reset_tune_cache()
    assert at.lookup(*key[:5], device=CPU).block_rows == 4
    assert TUNE_CACHE == {"hit": 0, "miss": 1}
    assert at.lookup(*key[:5], device=CPU).block_rows == 4
    assert TUNE_CACHE == {"hit": 1, "miss": 1}
    assert at.lookup("qsgd", 1, 256, 7, False, device=CPU) is None  # cached
    assert at.lookup("qsgd", 1, 256, 7, False, device=CPU) is None
    assert TUNE_CACHE == {"hit": 2, "miss": 2}
    reset_tune_cache()
    assert TUNE_CACHE == {"hit": 0, "miss": 0}
    monkeypatch.setattr(at, "_LRU_MAX", 3)
    for rows in range(10):
        at.lookup("qsgd", rows, 256, 7, False, device=CPU)
    assert len(at._lru) == 3


def test_launch_stats_helpers():
    before = dict(ls.LAUNCHES)
    try:
        ls.reset_launches()
        ls.LAUNCHES["qsgd"] += 2
        ls.LAUNCHES["topk_compact"] += 3
        assert ls.total_launches() == 5
    finally:
        ls.LAUNCHES.update(before)


def test_device_kind_normalises_the_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert at.device_kind(torch.device("cuda", 0)) == "nvidia_h100_80gb_hbm3"
    assert at.device_kind("cpu") == "cpu"


def test_save_goes_through_a_temporary_file_of_the_process(monkeypatch):
    moved = []
    real = os.replace
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (moved.append((a, b)), real(a, b)))
    path = at.save_table({"qsgd|f32|1|4096|15|0": _entry(2)}, device=CPU)
    assert moved == [(f"{path}.{os.getpid()}.tmp", path)]
    assert not os.path.exists(moved[0][0])


def _card_host(monkeypatch):
    """Make this process look like a card host: the default device is an
    H100 (nothing is launched on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    return torch.device("cuda", 0)


def test_one_table_per_device_kind(monkeypatch):
    card = _card_host(monkeypatch)
    key = at.ShapeKey("qsgd", 4, 8192, 15, False)
    p_cpu = at.save_table({key.as_str(): _entry(2)}, device=CPU)
    p_card = at.save_table({key.as_str(): _entry(8)}, device=card)
    assert os.path.basename(p_cpu) == "cpu.json"
    assert os.path.basename(p_card) == "nvidia_h100_80gb_hbm3.json"
    assert at.table_path() == p_card              # the default device's
    at.clear_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # neither is foreign
        for _ in range(2):
            assert at.lookup(*key[:5], device=CPU).block_rows == 2
            assert at.lookup(*key[:5], device=card).block_rows == 8
            assert at.lookup(*key[:5]).block_rows == 8
    assert TUNE_CACHE == {"hit": 4, "miss": 2}
    assert set(at._tables) == {"cpu", "nvidia_h100_80gb_hbm3"}
    # a CPU launch on a card host resolves through the CPU's table
    assert dsp._geometry(dsp.DispatchConfig(**KCFG), *key[:5],
                         torch.device("cpu")) == 2


def test_cpu_tuning_on_a_card_host_writes_the_cpu_table(monkeypatch):
    card = _card_host(monkeypatch)
    key = at.ShapeKey("topk_compact", 4, 256, 8, False)
    fresh = at.tune([key], iters=1, device=CPU)
    assert set(fresh) == {key.as_str()}
    assert os.path.exists(at.table_path(device=CPU))
    assert not os.path.exists(at.table_path(device=card))
    assert at.lookup(*key[:5], device=card) is None
    assert at.tune([key], iters=1, device=CPU) == {}
    assert at.tune.last_cached == 1


@pytest.mark.parametrize("samples,default,want", [
    ({8: [10.0, 10.5], 16: [9.9, 10.2]}, 8, 8),   # within the spread
    ({8: [10.0, 10.2], 16: [8.0, 8.1]}, 8, 16),   # a win past the spread
    ({8: [10.0, 14.0], 16: [8.0, 8.1]}, 8, 8),    # the default's spread
    ({8: [10.0, 10.1], 16: [8.0, 11.0]}, 8, 8),   # the winner's spread
    ({8: [10.0, 10.1], 16: [9.0, 9.1]}, 16, 16),  # the default wins
    ({1: [3.0, 3.0], 2: [2.0, 2.0]}, None, 2),    # no default: the fastest
    ({None: [5.0]}, None, None),                  # one geometry
])
def test_pick_keeps_the_default_within_the_spread(samples, default, want):
    assert at.pick(samples, default) == want


def test_time_samples_on_the_cpu():
    calls = []
    out = at.time_samples(lambda: calls.append(1), CPU, iters=4)
    assert len(out) == 4 and all(t >= 0.0 for t in out)
    assert len(calls) == 5                         # one warm-up
    assert at.batch_size(lambda: None, CPU) == 1
    samples = at.time_candidates(at.ShapeKey("topk_compact", 4, 256, 8,
                                             False), iters=2, device=CPU)
    assert sorted(samples) == [1, 2, 4, 8] and all(
        len(v) == 2 for v in samples.values())


# ---------------------------------------------------------------------------
# resolution at every launch site
# ---------------------------------------------------------------------------


@pytest.fixture
def seen(monkeypatch):
    """The geometry every kernel wrapper is handed: {kernel: [value]}."""
    got = {}

    def spy(name, fn, kw):
        def wrapped(*a, **k):
            got.setdefault(name, []).append(k.get(kw))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tk, "topk_compress",
                        spy("topk_compress", tk.topk_compress, "cluster"))
    monkeypatch.setattr(tk, "topk_compact",
                        spy("topk_compact", tk.topk_compact, "group"))
    monkeypatch.setattr(qk, "qsgd_quantize",
                        spy("qsgd", qk.qsgd_quantize, "cluster"))
    monkeypatch.setattr(pa, "paged_decode",
                        spy("paged_decode", pa.paged_decode,
                            "pages_per_block"))
    return got


def _rows(rows, n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, n), dtype=np.float32))


def test_resolution_order(seen):
    long_key = at.ShapeKey("topk_compress", 3, 16384, 16, True)
    at.save_table({long_key.as_str(): _entry(16)}, device=CPU)
    at.clear_cache()
    x = _rows(3, 16384)
    tuned = dsp.DispatchConfig(**KCFG)
    out_t = dsp.topk_rows(x, 16, sign=True, cfg=tuned)          # the table
    out_e = dsp.topk_rows(x, 16, sign=True,
                          cfg=dsp.DispatchConfig(block_rows=8, **KCFG))
    out_d = dsp.topk_rows(_rows(2, 16384), 16, sign=True, cfg=tuned)
    assert seen["topk_compress"] == [16, 8, None]   # untuned: its own pick
    for a, b in zip(out_t, out_e):
        assert torch.equal(a, b)
    assert dsp._geometry(tuned, *long_key[:5], CPU) == 16
    # an entry the launch cannot take (another build's) is passed over
    at.save_table({at.ShapeKey("qsgd", 1, 40, 15, False).as_str():
                   _entry(16)}, device=CPU)
    at.clear_cache()
    assert dsp._geometry(tuned, "qsgd", 1, 40, 15, False, CPU) is None
    assert out_d[0].shape == (2, 16384)


@pytest.mark.parametrize("call,match", [
    # a long row takes a cluster of 8 or 16
    (lambda c: dsp.topk_rows(_rows(2, 16384), 8, cfg=c), "cluster=3"),
    # short rows have no geometry to set
    (lambda c: dsp.topk_rows(_rows(2, 4096), 8, cfg=c), "cluster=3"),
    (lambda c: dsp.compact_rows(_rows(2, 4096), 8, 128, cfg=c), "group=3"),
    (lambda c: dsp.sparse_gemm(torch.zeros(2, 256), torch.zeros(
        4, 16, dtype=torch.int32), torch.zeros(4, 16), 256, c), "sparse_gemm"),
    (lambda c: dsp.qdq_gemm(torch.zeros(2, 256), torch.zeros(
        4, 256, dtype=torch.int8), torch.zeros(4, 1), c), "qdq_gemm"),
])
def test_explicit_geometry_the_kernel_cannot_take_raises(call, match):
    with pytest.raises(ValueError, match=match):
        call(dsp.DispatchConfig(block_rows=3, **KCFG))


def test_explicit_geometry_reaches_every_site(seen):
    """The eight launch sites of the dispatcher hand the wrappers the
    explicit value (or the table's): none ignores it."""
    from repro_torch.core.operators import (QSGDQuantizer, RowSignTopK,
                                            SignSparsifier, TopK)
    rng = torch.Generator().manual_seed(0)
    acc = {"a": _rows(2, 8192, 1), "b": _rows(4, 4096, 2)}
    for pack in (True, False):
        cfg = dsp.DispatchConfig(block_rows=2, pack=pack, **KCFG)
        dsp.channel_compress_tree(QSGDQuantizer(s=15), rng, acc, cfg)
        cfg = dsp.DispatchConfig(block_rows=16, pack=pack, **KCFG)
        dsp.channel_compress_tree(TopK(k=0.01), rng, acc, cfg)
    assert seen["qsgd"] == [2, 2, 2]         # packed: one bucket
    assert seen["topk_compress"] == [16, 16, 16]
    cfg = dsp.DispatchConfig(block_rows=4, **KCFG)
    dsp.compact_rows(_rows(3, 1024), 8, 128, cfg=cfg)
    dsp.compact_compress(RowSignTopK(k=0.05, row_len=1024), None,
                         _rows(2, 1024).reshape(-1), cfg)
    assert seen["topk_compact"] == [4, 4]
    cfg = dsp.DispatchConfig(block_rows=16, **KCFG)
    dsp.topk_rows(_rows(2, 20000), 9, sign=True, cfg=cfg)
    dsp.compress_tree(SignSparsifier(k=0.01, m=2), rng,
                      {"w": _rows(1, 30000)}, cfg)
    assert seen["topk_compress"][3:] == [16, 16]
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(6, 4, 2, 16)
    sc = torch.ones(6, 4)
    tables = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    lengths = torch.tensor([12, 5], dtype=torch.int32)
    dsp.paged_decode(q, pool, pool, sc, sc, tables, lengths,
                     dsp.DispatchConfig(block_rows=9, **KCFG))
    key = at.ShapeKey("paged_decode", 3, 4, 16, False)
    at.save_table({key.as_str(): _entry(2)}, device=CPU)
    at.clear_cache()
    dsp.paged_decode(q, pool, pool, sc, sc, tables, lengths,
                     dsp.DispatchConfig(**KCFG))
    assert seen["paged_decode"] == [3, 2]   # clamped to the table width
    with pytest.raises(ValueError, match="at least one page"):
        dsp.paged_geometry(dsp.DispatchConfig(block_rows=0), 3)


def test_wrappers_check_geometry_on_the_cpu():
    x = _rows(2, 16384)
    assert tk.cluster_sizes(16384) == (8, 16)
    assert tk.cluster_sizes(tk.SHORT_ROW) == ()
    for cs in (8, 16):
        for a, b in zip(tk.topk_compress(x, 20, sign=True, cluster=cs),
                        tk.topk_compress(x, 20, sign=True)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cluster=4"):
        tk.topk_compress(x, 20, cluster=4)
    assert tk.compact_groups(1152, 128) == (1, 2, 4, 8)
    assert tk.compact_groups(4096, 128) == ()
    with pytest.raises(ValueError, match="group=16"):
        tk.topk_compact(_rows(2, 256), 4, 128, group=16)
    assert qk.qsgd_clusters(7936) == (1, 2, 4, 8, 16)
    assert qk.qsgd_clusters(40) == (1, 2, 4)    # 8 and 16 leave blocks empty
    with pytest.raises(ValueError, match="cluster sizes"):
        qk.qsgd_quantize(_rows(2, 40), _rows(2, 40).abs(), 15, cluster=16)


# ---------------------------------------------------------------------------
# candidates, tune, launch plans
# ---------------------------------------------------------------------------


def test_candidates_on_the_cpu():
    cands = at.block_row_candidates
    assert cands(at.ShapeKey("topk_compress", 16, 524288, 5243, False),
                 "cpu") == [8, 16]
    assert cands(at.ShapeKey("topk_compress", 49312, 4096, 41, True),
                 "cpu") == []
    assert cands(at.ShapeKey("topk_compact", 179712, 1152, 12, True),
                 "cpu") == [1, 2, 4, 8]
    assert cands(at.ShapeKey("topk_compact", 4, 8192, 12, True), "cpu") == []
    assert cands(at.ShapeKey("qsgd", 16, 524288, 15, False),
                 "cpu") == [1, 2, 4, 8, 16]
    assert cands(at.ShapeKey("qsgd", 15, 7936, 15, False), "cpu") == [1, 2]
    assert cands(at.ShapeKey("paged_decode", 32, 16, 128, True),
                 "cpu") == [1, 2, 4, 8, 16, 32]
    assert cands(at.ShapeKey("paged_decode", 5, 16, 128, True),
                 "cpu") == [1, 2, 4, 5]
    assert cands(at.ShapeKey("sparse_gemm", 8, 256, 16, False), "cpu") == []
    assert at.default_geometry(
        at.ShapeKey("topk_compact", 179712, 1152, 12, True), "cpu") == 8
    assert at.default_geometry(
        at.ShapeKey("paged_decode", 3, 16, 128, False), "cpu") == 3


def test_tune_measures_caches_and_leaves_the_launch_counts():
    keys = [at.ShapeKey("topk_compress", 2, 16384, 8, True),
            at.ShapeKey("topk_compact", 4, 256, 8, False)]
    before = dict(ls.LAUNCHES)
    fresh = at.tune(keys, iters=1, device="cpu")
    assert ls.LAUNCHES == before             # measurement is not the run's
    assert set(fresh) == {k.as_str() for k in keys}
    assert fresh[keys[0].as_str()].block_rows in (8, 16)
    assert fresh[keys[1].as_str()].block_rows in (1, 2, 4, 8)
    assert all(np.isfinite(e.us) for e in fresh.values())
    assert os.path.exists(at.table_path(device=CPU))
    assert at.tune(keys, iters=1, device="cpu") == {}
    assert at.tune.last_cached == 2
    assert set(at.tune(keys, iters=1, retune=True, device="cpu")) == set(
        fresh)


def test_tune_for_run_covers_launch_plans():
    from repro_torch.core import policy as pol
    params = {"w": torch.zeros(256, 128), "b": torch.zeros(128)}
    up, _ = pol.as_channel_spec("topk:k=0.05").resolve(params)
    cfg = dsp.DispatchConfig(**KCFG)
    want = {k.as_str() for k in dsp.launch_plans(up, params, cfg,
                                                 workers=4)}
    assert want == {"topk_compress|f32|4|32768|1638|0",
                    "topk_compress|f32|4|128|6|0"}
    fresh = at.tune_for_run(up, params, cfg, iters=1, workers=4,
                            device="cpu")
    assert set(fresh) == want
    at.clear_cache()
    for ks in want:
        assert at.lookup(*at.parse_key(ks)[:5], device=CPU) is not None
    assert dsp.launch_plans(up, params, dsp.DispatchConfig()) == []  # auto


PLAN_TREE = {"w1": (256, 128), "w2": (64, 384), "w3": (256, 128),
             "b": (128,), "conv": (3, 3, 8, 16), "emb": (1000, 64),
             "big": (1200, 512)}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("policy", [
    "topk:k=0.05", "qsgd:s=15", "signtopk:k=0.05,m=2",
    "row_signtopk:k=0.05,row_len=128"])
def test_launch_plans_equal_repro(policy, pack, compact):
    from repro.core import policy as jpol
    from repro.kernels import dispatch as jdsp
    from repro_torch.core import policy as pol
    params = {k: np.zeros(s, np.float32) for k, s in PLAN_TREE.items()}
    want = jdsp.launch_plans(
        jpol.as_channel_spec(policy).resolve(params)[0], params,
        jdsp.DispatchConfig(mode="kernel", pack=pack), compact=compact)
    got = dsp.launch_plans(
        pol.as_channel_spec(policy).resolve(params)[0], params,
        dsp.DispatchConfig(mode="kernel", pack=pack), compact=compact)
    assert want, "the policy must launch kernels"
    assert [k.as_str() for k in got] == [k.as_str() for k in want]


def test_cli_smoke_twice(capsys):
    assert at.main(["--smoke", "--iters", "1", "--device", "cpu"]) == 0
    out1 = capsys.readouterr().out
    assert f"(tuned {len(at.SMOKE_KEYS)}, cached 0)" in out1
    assert os.path.exists(at.table_path(device=CPU))
    assert at.main(["--smoke", "--iters", "1", "--device", "cpu"]) == 0
    out2 = capsys.readouterr().out
    assert f"(tuned 0, cached {len(at.SMOKE_KEYS)})" in out2


# ---------------------------------------------------------------------------
# the repaired reductions: one float at every cluster size
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(rows=st.integers(1, 3), n=st.integers(1, 9000),
       s=st.sampled_from([1, 15, 255]), seed=st.integers(0, 2 ** 31 - 1))
def test_qsgd_model_bit_for_bit_at_every_cluster_size(rows, n, s, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, n), dtype=np.float32))
    u = torch.from_numpy(rng.random((rows, n), dtype=np.float32))
    tree = ref.tree_sq_ref(x)
    want = ref.qsgd_cluster_ref(x, u, s, 1)
    for cs in qk.qsgd_clusters(n):
        for threads in (256, 512):
            assert torch.equal(ref.cluster_sq_ref(x, cs, threads), tree)
        assert torch.equal(ref.qsgd_cluster_ref(x, u, s, cs), want)


@settings(max_examples=12, deadline=None)
@given(n=st.sampled_from([12289, 16384, 30001, 70000]),
       kinds=st.lists(st.sampled_from(ROW_KINDS), min_size=1, max_size=2),
       k=st.integers(1, 400), seed=st.integers(0, 2 ** 31 - 1))
def test_sign_scale_model_bit_for_bit_at_every_cluster_size(n, kinds, k,
                                                            seed):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(np.stack([make_row(rng, kind, n)
                                     for kind in kinds]))
    outs = [ref.topk_threshold_levels_ref(acc, k, sign=True, levels=3,
                                          clusters=cs)
            for cs in tk.cluster_sizes(n)]
    assert len(outs) == 2
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def test_tuned_run_equals_untuned():
    from repro_torch.core import operators as tops
    from repro_torch.data import mnist_like, worker_batches
    from repro_torch.models import softmax as tsoft
    from repro_torch.optim import inverse_time, sgd
    from repro_torch.train import RunConfig, train
    from repro_torch.tree import value_and_grad
    x, y = mnist_like(96, seed=0)
    cfg = tsoft.SoftmaxConfig()
    grad = value_and_grad(lambda p, b: tsoft.loss_fn(p, b, cfg)[0])

    def run(**kw):
        return train(grad, tsoft.init_params(cfg, device="cpu"), sgd(),
                     tops.QSGDQuantizer(s=15), inverse_time(1.0, 10.0),
                     worker_batches(x, y, 3, 4, 4, seed=0),
                     RunConfig(total_steps=4, R=3, H=2, dispatch="kernel",
                               **kw), device="cpu")[1]

    plain = run()
    tuned = run(tune=True)
    path = at.table_path(device=CPU)
    assert at.tune.last_cached == 0 and os.path.exists(path)
    assert json.load(open(path))["entries"].keys() == {
        "qsgd|f32|3|7936|15|0", "qsgd|f32|3|128|15|0"}
    again = run(tune=True, retune=True)
    for h in (tuned, again):
        assert h.loss == plain.loss and h.bits == plain.bits
    with pytest.raises(ValueError, match="tune=True"):
        run(retune=True)


def test_launcher_tune_prints_its_line(capsys):
    from repro_torch.launch import train as lt
    argv = ["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--device",
            "cpu", "--steps", "2", "--H", "2", "--seq", "16",
            "--policy", "preset:arch", "--wire", "sparse_allgather",
            "--dispatch", "kernel"]
    plain = lt.main(argv)
    capsys.readouterr()
    tuned = lt.main(argv + ["--tune"])
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("tune:")]
    assert line == [
        f"tune: 3 measured, 0 cached -> {at.table_path(device=CPU)}"]
    assert tuned["loss"] == plain["loss"]
    with pytest.raises(SystemExit):
        lt.main(argv + ["--retune"])


@pytest.mark.parametrize("wire", ["sparse_allgather", "dense_psum"])
def test_launcher_plans_are_the_launches_it_makes(monkeypatch, wire):
    """The keys ``--tune`` measures (``ShardCompressor.launch_plans``) are
    the signatures the step's launches resolve through the table."""
    from repro_torch.launch import train as lt
    launched = set()
    real = dsp._geometry

    def spy(cfg, kernel, rows, n, k, sign, device=None):
        launched.add(at.ShapeKey(kernel, rows, n, k, sign).as_str())
        return real(cfg, kernel, rows, n, k, sign, device)

    monkeypatch.setattr(dsp, "_geometry", spy)
    lt.main(["--arch", "gemma3-1b", "--smoke", "--mesh", "1x1", "--device",
             "cpu", "--steps", "2", "--H", "2", "--seq", "16",
             "--policy", "preset:arch", "--wire", wire,
             "--dispatch", "kernel", "--tune"])
    tuned = json.load(open(at.table_path(device=CPU)))["entries"].keys()
    assert launched and launched == set(tuned)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(3, 12289), (2, 16384), (4, 70001),
                                    (16, 524288), (1, 1 << 21)])
def test_cluster_topk_one_output_at_every_geometry_on_card(cuda, rows, n):
    """The long-row kernel at every cluster size the card schedules: the
    same outputs bit for bit, plain and SignTop_k, and the SignTop_k
    values bit for bit the model's (its tree order) on the smaller rows
    (the longer ones against the model's threshold and counts only)."""
    x = torch.randn((rows, n), generator=torch.Generator(
        device=cuda).manual_seed(n), device=cuda)
    sizes = at.block_row_candidates(
        at.ShapeKey("topk_compress", rows, n, 50, True), cuda)
    assert 8 in sizes
    for sign in (False, True):
        outs = [tk.topk_compress(x, 50, sign=sign, cluster=cs)
                for cs in sizes]
        for out in outs[1:]:
            for a, b in zip(out, outs[0]):
                assert torch.equal(a, b), (sign, sizes)
        if n <= 70001:
            *want, _ = ref.topk_threshold_levels_ref(
                x, 50, sign=sign, levels=3, clusters=8)
            for a, b in zip(outs[0], want):
                assert torch.equal(a, b), sign


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(16, 524288), (56, 65536), (15, 7936),
                                    (3, 65537)])
def test_qsgd_one_output_at_every_cluster_size_on_card(cuda, rows, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((rows, n), generator=g, device=cuda)
    u = torch.rand((rows, n), generator=g, device=cuda)
    want = ref.qsgd_cluster_ref(x, u, 15, 1)    # the model, on the card
    for cs in qk.qsgd_clusters(n):
        assert torch.equal(qk.qsgd_quantize(x, u, 15, cluster=cs), want), cs


@pytest.mark.gpu
def test_compact_one_output_at_every_group_on_card(cuda):
    x = torch.randn((4099, 1152), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    for sign in (False, True):
        outs = [tk.topk_compact(x, 12, 128, sign=sign, group=g)
                for g in tk.compact_groups(1152, 128)]
        for out in outs[1:]:
            for a, b in zip(out, outs[0]):
                assert torch.equal(a, b)


@pytest.mark.gpu
def test_tune_and_cli_on_card(cuda, capsys):
    assert at.main(["--smoke", "--iters", "1"]) == 0
    assert "(tuned 8, cached 0)" in capsys.readouterr().out
    assert at.main(["--smoke", "--iters", "1"]) == 0
    assert "(tuned 0, cached 8)" in capsys.readouterr().out
    assert os.path.basename(at.table_path()) == (
        at.device_kind(cuda) + ".json")
    s = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    key = at.ShapeKey("qsgd", 2, 4096, 15, False)
    x = torch.zeros(8, device=cuda)
    with pytest.raises(RuntimeError, match="captures a CUDA graph"):
        with torch.cuda.graph(graph, stream=s):
            x.add_(1)
            at.tune([key], iters=1)
