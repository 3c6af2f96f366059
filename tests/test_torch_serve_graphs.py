"""The serving engine's step and admission as bodies over static device
buffers (what ``graphs.CudaGraph`` captures on the card), against
``repro``'s jitted ``_step_jit`` / ``_admit_jit``.

On the CPU the engine runs the very bodies a graph captures, eagerly,
so these tests hold the captured code to ``repro``: the static buffers
keep their addresses over whole runs (paged with preemptions and
stalls, contiguous), admissions through the device ``slot`` /
``true_len`` scalars and the device ``page_ids`` leave the caches and
the pool as ``repro``'s ``_admit_fn`` / ``_paged_admit_fn`` leave
theirs, and ``graphs.py``'s counter bookkeeping repeats a capture's
counts at each replay.  The ``gpu`` cases run graphs on the card
(``pytest -m gpu tests/test_torch_serve_graphs.py``; the card has no
JAX, so ``repro`` is imported by the CPU parity tests themselves).

Tolerances: greedy tokens, positions, page tables and counters exact;
prefilled float32 KV within 1e-5 of the largest magnitude (float32 sums
in another order through two layers); bfloat16 KV within 2^-7 of it
(one bfloat16 rounding of a value computed in another order); int8 KV
levels within one level and scales within 1e-5 relative (a level can
round the other way when its value moves by that much).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import POLICY_PRESETS, get_config
from repro_torch.graphs import CudaGraph, add_counts, record
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
from repro_torch.models import transformer as tf
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine

KERNEL = dsp.DispatchConfig(mode="kernel")
POLICY = POLICY_PRESETS["lm_hetero"]
COUNTERS = (LAUNCHES, sc.STATS)


@pytest.fixture(scope="module")
def jx():
    """``repro``'s engine and the shared tie-free weights (JAX on the
    CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.serve import compressed as jsc
    from repro.serve.engine import ServeEngine as JEngine
    from repro_torch.convert import params_from_jax
    from test_torch_serve import tie_free_params

    def model(arch: str, seed: int, compressed: bool, **replace):
        cfg_j = dataclasses.replace(j_get_config(arch, smoke=True),
                                    **replace)
        cfg_t = dataclasses.replace(get_config(arch, smoke=True),
                                    use_pallas=True, **replace)
        tree = tie_free_params(cfg_j, seed)
        pj = jax.tree_util.tree_map(jnp.asarray, tree)
        pt = params_from_jax(tree, device="cpu")
        if compressed:
            pj, pt = jsc.compress_tree(pj, POLICY), sc.compress_tree(pt,
                                                                     POLICY)
        return cfg_j, cfg_t, pj, pt

    return types.SimpleNamespace(JEngine=JEngine, model=model)


def _statics(eng) -> dict:
    names = ["_toks", "_poss", "_active", "logits", "_adm_toks"]
    names += (["_tables", "_adm_page_ids"] if eng.paged
              else ["_adm_slot", "_adm_len"])
    return {n: getattr(eng, n).data_ptr() for n in names}


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


# ---------------------------------------------------------------------------
# whole runs: static buffers, tokens
# ---------------------------------------------------------------------------

RUNS = {
    # paged: a pool of 5 pages of 4 for two slots of 17-18 tokens
    # (preemptions), and 5-6-token prompts that wait for 2 free pages
    # (stalls)
    "paged": (dict(paged=True, page_size=4, kv_pool_pages=5),
              [([1, 2, 3, 4, 5], 12), ([1, 2, 3, 4, 5, 6], 12),
               ([9, 8, 7, 6, 5, 4], 8)]),
    "paged-int8": (dict(paged=True, page_size=4, kv_quant=True),
                   [([5, 6, 7], 6), ([1], 4), ([9, 8, 7, 6, 5], 8),
                    ([3, 3], 5), ([11, 2, 4], 7), ([8], 3)]),
    "contiguous": ({}, [([5, 6, 7], 6), ([1], 4), ([9, 8, 7, 6, 5], 8),
                        ([3, 3], 5), ([11, 2, 4], 7), ([8], 3)]),
}


@pytest.mark.parametrize("layout", sorted(RUNS))
def test_static_buffers_keep_their_address(jx, layout):
    kw, reqs = RUNS[layout]
    kw = {"max_batch": 2, "max_len": 20, "prompt_pad": 6, **kw}
    cfg_j, cfg_t, pj, pt = jx.model("yi-6b", 1, True)
    jeng = jx.JEngine(pj, cfg_j, **kw)
    eng = ServeEngine(pt, cfg_t, dispatch=KERNEL, **kw)
    assert not eng.cuda_graphs
    for e in (jeng, eng):
        for p, n in reqs:
            e.submit(p, n)
    res_j = jeng.run()
    where = _statics(eng)
    while eng.pending:
        eng.step()
        assert _statics(eng) == where
    res_t = eng.run()
    assert res_t["outputs"] == res_j["outputs"]
    assert eng.occupancy == jeng.occupancy
    assert eng.captures == {"decode": 0, "admit": 0}
    if layout == "paged":
        assert eng.preemptions == jeng.preemptions > 0
        assert eng.admission_stalls == jeng.admission_stalls > 0
        assert res_t["pool"] == res_j["pool"]
    # the device state of a finished run: every slot free and parked
    assert not eng._active.any()
    assert eng.logits.shape == (2, cfg_t.vocab) and \
        bool(eng.logits.isfinite().all())


# ---------------------------------------------------------------------------
# admissions
# ---------------------------------------------------------------------------

ADMIT = {
    # arch, scanned, prompts (the smoke gemma3-1b's window is 16 tokens)
    "stacked": ("yi-6b", True, [[5, 6, 7], [1], [9, 8, 7, 6, 5, 4]], 6),
    "unscanned": ("gemma3-1b", False,
                  [list(range(1, 20)), [7], [9, 8] * 9], 20),
}


def _slot_views(eng, jeng, slot):
    """(port, repro) per-layer (k, v, pos) of one slot: the port keeps
    [L, slots, C, ...] stacked / [slots, C, ...] per layer, ``repro`` a
    B = 1 cache stacked on a leading slot axis."""
    out = []
    bigs_t = eng._caches if isinstance(eng._caches, list) else [eng._caches]
    bigs_j = (jeng._caches if isinstance(jeng._caches, list)
              else [jeng._caches])
    for bt, bj in zip(bigs_t, bigs_j):
        if bt.k.dim() == 5:          # stacked: [L, slots, C, KV, hd]
            t = (bt.k[:, slot], bt.v[:, slot], bt.pos[:, slot])
            j = (bj.k[slot][:, 0], bj.v[slot][:, 0], bj.pos[slot])
        else:
            t = (bt.k[slot], bt.v[slot], bt.pos[slot])
            j = (bj.k[slot][0], bj.v[slot][0], bj.pos[slot])
        out.append((t, tuple(np.asarray(a) for a in j)))
    return out


@pytest.mark.parametrize("busy", [(), (0, 2)])
@pytest.mark.parametrize("stack", sorted(ADMIT))
def test_contiguous_admission_matches_repro(jx, stack, busy):
    arch, scanned, prompts, pad = ADMIT[stack]
    cfg_j, cfg_t, pj, pt = jx.model(arch, 3, False, scan_layers=scanned)
    kw = dict(max_batch=5, max_len=pad + 4, prompt_pad=pad)
    jeng = jx.JEngine(pj, cfg_j, **kw)
    eng = ServeEngine(pt, cfg_t, dispatch=KERNEL, **kw)
    for e in (jeng, eng):
        for i in busy:              # occupied: admissions skip them
            e._slots[i] = type(e._slots[i])(rid=100 + i)
        for p in prompts:
            e.submit(p, 3)
        assert e._admit() == len(prompts)
    slots = [i for i in range(5) if i not in busy][:len(prompts)]
    assert eng._adm_slot.dtype == torch.int64 and \
        int(eng._adm_slot[0]) == slots[-1]
    assert int(eng._adm_len) == len(prompts[-1])
    for slot in range(5):
        for (kt, vt, pt_), (kj, vj, pj_) in _slot_views(eng, jeng, slot):
            np.testing.assert_array_equal(pt_.numpy(), pj_)
            _close(kt.numpy(), kj, 1e-5)
            _close(vt.numpy(), vj, 1e-5)
    # each admitted slot holds its prompt's positions, the rest -1
    for slot, p in zip(slots, prompts):
        for (_, _, pos), _ in _slot_views(eng, jeng, slot):
            for row in pos.reshape(-1, pos.shape[-1]):   # each layer
                live = row[row >= 0]
                assert sorted(live.tolist()) == list(
                    range(len(p) - live.numel(), len(p)))


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_admission_matches_repro(jx, pool):
    dtype = ({"act_dtype": "bfloat16", "param_dtype": "bfloat16"}
             if pool == "bfloat16" else {})
    cfg_j, cfg_t, pj, pt = jx.model("yi-6b", 3, False, **dtype)
    # two admission pages of 4; the 3-token prompt leaves its tail page
    # unallocated (the sentinel)
    kw = dict(max_batch=3, max_len=12, prompt_pad=8, paged=True,
              page_size=4, kv_quant=pool == "int8")
    jeng = jx.JEngine(pj, cfg_j, **kw)
    eng = ServeEngine(pt, cfg_t, dispatch=KERNEL, **kw)
    prompts = [[5, 6, 7, 8, 9, 10, 11], [9, 8, 7, 6, 5], [1, 2, 3]]
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, 3)
        assert e._admit() == len(prompts)
    np.testing.assert_array_equal(eng._tables_np, jeng._tables_np)
    last = eng._slots[2].pages
    assert eng._adm_page_ids.tolist() == last + [eng.n_pages] * (
        2 - len(last))
    n = eng.n_pages
    got, want = eng._pool, jeng._pool
    if pool == "int8":
        for lt, lj, st, sj in ((got.k, want.k, got.kscale, want.kscale),
                               (got.v, want.v, got.vscale, want.vscale)):
            diff = lt[:, :n].to(torch.int32).numpy() - np.asarray(lj)
            assert np.abs(diff).max() <= 1
            np.testing.assert_allclose(st[:, :n].numpy(), np.asarray(sj),
                                       rtol=1e-5, atol=0)
        return
    tol = 2.0 ** -7 if pool == "bfloat16" else 1e-5
    assert got.k.dtype == getattr(torch, pool)
    for at, aj in ((got.k, want.k), (got.v, want.v)):
        _close(at[:, :n].float().numpy(), np.asarray(aj, np.float32), tol)
        # the pages no table names stay untouched
        free = sorted(set(range(n)) - set(eng._tables_np.ravel().tolist()))
        assert not at[:, free].any()


# ---------------------------------------------------------------------------
# graphs.py: refusals and the counters
# ---------------------------------------------------------------------------


def _cpu_engine(paged: bool):
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              use_pallas=True)
    params = sc.compress_tree(tf.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"), POLICY)
    layout = {"paged": True, "page_size": 4} if paged else {}
    return ServeEngine(params, cfg, max_batch=2, max_len=16, prompt_pad=6,
                       dispatch=KERNEL, **layout), params, cfg


def test_graphs_refused_off_the_card():
    eng, params, cfg = _cpu_engine(False)
    assert not eng.cuda_graphs     # "auto" on the CPU: the eager bodies
    with pytest.raises(ValueError, match="CUDA device"):
        ServeEngine(params, cfg, dispatch=KERNEL, cuda_graphs=True)
    with pytest.raises(ValueError, match="cuda_graphs must be"):
        ServeEngine(params, cfg, cuda_graphs="on")
    assert not ServeEngine(params, cfg, cuda_graphs=False).cuda_graphs
    with pytest.raises(ValueError, match="CUDA device"):
        CudaGraph(lambda: None, [torch.zeros(2)])
    with pytest.raises(ValueError, match="static tensors"):
        CudaGraph(lambda: None, [])


@pytest.mark.parametrize("paged", [False, True])
def test_counter_bookkeeping(paged):
    eng, _, _ = _cpu_engine(paged)
    for p in ([5, 6, 7], [1, 2]):
        eng.submit(p, 4)
    eng.step()                       # two admissions, one decode step
    for body in (eng._decode_body, eng._admit_body):
        sc.reset_stats()
        reset_launches()
        body()                       # the plain call
        plain = [dict(c) for c in COUNTERS]
        sc.reset_stats()
        reset_launches()
        inc = record(body, COUNTERS)  # what a capture does to them
        assert [dict(c) for c in COUNTERS] == [
            dict.fromkeys(c, 0) for c in COUNTERS]
        assert inc == [{k: v for k, v in c.items() if v} for c in plain]
        assert inc[0]["sparse_gemm"] == 7 * eng.cfg.n_layers
        for replays in (1, 2, 3):
            add_counts(inc, COUNTERS)
            assert [dict(c) for c in COUNTERS] == [
                {k: replays * v for k, v in c.items()} for c in plain]

    def failing():
        LAUNCHES["sparse_gemm"] += 5
        raise RuntimeError("capture failed")

    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="capture failed"):
        record(failing, COUNTERS)
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_replays_a_kernel_body(cuda):
    from repro_torch.kernels.flash_attention import flash_decode
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 1, 8, 64, device=cuda, generator=g)
    k = torch.randn(2, 512, 2, 64, device=cuda, generator=g)
    v = torch.randn(2, 512, 2, 64, device=cuda, generator=g)
    valid = torch.rand(2, 512, device=cuda, generator=g) < 0.7
    out = torch.zeros_like(q)
    calls = torch.zeros((), dtype=torch.int32, device=cuda)

    def body():
        out.copy_(flash_decode(q, k, v, valid))
        calls.add_(1)

    want = flash_decode(q, k, v, valid)
    reset_launches()
    graph = CudaGraph(body, [q, k, v, valid, out, calls])
    for i in range(4):
        out.zero_()
        graph()
        torch.cuda.synchronize()
        assert torch.equal(out, want) and int(calls) == i + 1
        assert LAUNCHES["flash_decode"] == i + 1
    assert graph.captures == 1 and graph.calls == 4


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(RUNS))
def test_graphed_engine_matches_eager(cuda, layout):
    kw, reqs = RUNS[layout]
    kw = {"max_batch": 2, "max_len": 20, "prompt_pad": 6, **kw}
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              use_pallas=True)
    params = sc.compress_tree(tf.init_params(
        torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda),
        POLICY)
    runs = {}
    for graphs in (True, False):
        sc.reset_stats()
        reset_launches()
        eng = ServeEngine(params, cfg, dispatch=KERNEL, cuda_graphs=graphs,
                          **kw)
        for p, n in reqs:
            eng.submit(p, n)
        runs[graphs] = (eng.run()["outputs"], dict(LAUNCHES),
                        dict(sc.STATS), eng.captures)
    assert runs[True][:3] == runs[False][:3]
    assert runs[True][3] == {"decode": 1, "admit": 1}
    assert runs[False][3] == {"decode": 0, "admit": 0}
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        ServeEngine(params, cfg, dispatch=dsp.DispatchConfig(
            mode="reference"), **kw)
