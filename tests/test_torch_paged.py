"""Paged (and int8) KV serving against ``repro``: the decode-attention
kernels' plain versions against ``repro``'s Pallas kernels in interpret
mode and its oracles, the pool writes, the page allocator, and whole
paged ``ServeEngine`` runs (tokens, preemptions, admission stalls).

The port's engine runs the paged-decode kernel path (``use_pallas``,
dispatch "kernel": the plain version on the CPU, counted); ``repro``'s
runs its gather oracle, which its own tests hold to its kernel.
Tolerances: attention outputs within 1e-5 (float32 softmax sums in
another order); a length-0 row exactly zero; int8 levels exact and
scales within 1e-7; pool contents after writes exact; greedy tokens and
the engine's counters exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_decode_fwd
from repro.kernels.paged_attention import paged_decode_fwd
from repro.models import layers as jlayers
from repro.serve import compressed as jsc
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.paging import PagePool as JPagePool
from repro_torch.configs import POLICY_PRESETS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels.flash_attention import flash_decode
from repro_torch.kernels.launch_stats import (LAUNCHES, PAGE_POOL,
                                              reset_launches)
from repro_torch.kernels.paged_attention import paged_decode
from repro_torch.models import layers
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paging import PagePool
from test_torch_serve import tie_free_params

KERNEL = dsp.DispatchConfig(mode="kernel")


def _t(a):
    return torch.from_numpy(np.array(a))


def rand_pool(rng, n_pages, ps, KV, hd, quant):
    if quant:
        kp = rng.randint(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8)
        vp = rng.randint(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8)
        ks = (rng.rand(n_pages, ps) * 0.1).astype(np.float32)
        vs = (rng.rand(n_pages, ps) * 0.1).astype(np.float32)
    else:
        kp = rng.randn(n_pages, ps, KV, hd).astype(np.float32)
        vp = rng.randn(n_pages, ps, KV, hd).astype(np.float32)
        ks = np.zeros((n_pages, ps), np.float32)
        vs = np.zeros((n_pages, ps), np.float32)
    return kp, vp, ks, vs


def rand_tables(rng, B, P, ps, n_pages, lengths):
    """Distinct physical pages per row, -1 beyond each row's need."""
    perm = rng.permutation(n_pages)[:B * P].reshape(B, P)
    tables = np.full((B, P), -1, np.int32)
    for b in range(B):
        need = max(1, -(-int(lengths[b]) // ps))
        tables[b, :need] = perm[b, :need]
    return tables


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,H,KV,hd,ps,P,n_pages", [
    (3, 8, 2, 32, 8, 5, 16),      # free slot / partial / full rows
    (2, 8, 1, 32, 4, 3, 8),       # the smoke model's one kv head
])
def test_paged_decode_plain_matches_repro(quant, B, H, KV, hd, ps, P,
                                          n_pages):
    rng = np.random.RandomState(B * P + quant)
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    pool = rand_pool(rng, n_pages, ps, KV, hd, quant)
    lengths = np.array([0, 7, P * ps][-B:], np.int32)
    lengths[0] = 0
    tables = rand_tables(rng, B, P, ps, n_pages, lengths)
    before = LAUNCHES["paged_decode"]
    out = paged_decode(_t(q), *map(_t, pool), _t(tables),
                       _t(lengths)).numpy()
    assert LAUNCHES["paged_decode"] == before + 1
    args = [jnp.asarray(a) for a in (q, *pool, tables, lengths)]
    np.testing.assert_allclose(
        out, np.asarray(paged_decode_fwd(*args, pages_per_block=2,
                                         interpret=True)), atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jref.paged_decode_ref(*args)),
                               atol=1e-5)
    assert not out[0].any()               # length 0: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_plain_matches_repro(dtype):
    rng = np.random.RandomState(3)
    B, H, KV, hd, C = 3, 8, 2, 32, 24
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    k = rng.randn(B, C, KV, hd).astype(np.float32)
    v = rng.randn(B, C, KV, hd).astype(np.float32)
    valid = rng.rand(B, C) > 0.4
    valid[:, 0] = True
    qt, kt, vt = (_t(a).to(dtype) for a in (q, k, v))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    # one mask for the batch, as repro passes it
    out = flash_decode(qt, kt, vt, _t(valid[1]))
    want = flash_decode_fwd(qj, kj, vj, jnp.asarray(valid[1]),
                            interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol)
    # one mask per row: each row against repro with that row's mask
    out = flash_decode(qt, kt, vt, _t(valid)).float().numpy()
    for b in range(B):
        want = jref.flash_decode_ref(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1],
                                     jnp.asarray(valid[b]))
        np.testing.assert_allclose(out[b:b + 1],
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol)


def test_attention_wrappers_refuse_bad_inputs():
    q = torch.zeros(2, 1, 8, 16)
    kp = torch.zeros(4, 4, 2, 16)
    s = torch.zeros(4, 4)
    tb = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        paged_decode(q, kp.to(torch.bfloat16), kp.to(torch.bfloat16), s, s,
                     tb, ln)
    with pytest.raises(ValueError, match="scales"):
        paged_decode(q, kp, kp, torch.zeros(4, 3), s, tb, ln)
    with pytest.raises(TypeError):
        paged_decode(q, kp, kp, s, s, tb.long(), ln)
    k = torch.zeros(2, 5, 2, 16)
    with pytest.raises(ValueError, match="valid"):
        flash_decode(q, k, k, torch.ones(4, dtype=torch.bool))


def test_dispatch_routes_decode_attention():
    rng = np.random.RandomState(4)
    q = _t(rng.randn(2, 1, 4, 16).astype(np.float32))
    pool = [_t(a) for a in rand_pool(rng, 6, 4, 2, 16, True)]
    lengths = np.array([3, 9], np.int32)
    tables = _t(rand_tables(rng, 2, 3, 4, 6, lengths))
    ref_cfg = dsp.DispatchConfig(mode="reference")
    before = dict(LAUNCHES)
    a = dsp.paged_decode(q, *pool, tables, _t(lengths), ref_cfg)
    assert LAUNCHES == before
    b = dsp.paged_decode(q, *pool, tables, _t(lengths),
                         dsp.DispatchConfig(mode="kernel", block_rows=2))
    assert LAUNCHES["paged_decode"] == before["paged_decode"] + 1
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert dsp.paged_geometry(None, 32) == 4
    assert dsp.paged_geometry(dsp.DispatchConfig(block_rows=9), 5) == 5


# ---------------------------------------------------------------------------
# pool writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_pool_writes_match_repro(quant):
    cfg_j = j_get_config("yi-6b", smoke=True)
    cfg_t = get_config("yi-6b", smoke=True)
    n_pages, ps, L = 6, 4, cfg_t.n_layers
    rng = np.random.RandomState(5)
    pj = jlayers.init_paged_pool(cfg_j, n_pages, ps, stacked=L, quant=quant)
    pt = layers.init_paged_pool(cfg_t, n_pages, ps, stacked=L, quant=quant,
                                device="cpu")
    # a prefill insert with an unallocated tail page (the sentinel drops)
    kv = [rng.randn(L, 2 * ps, cfg_t.n_kv_heads, cfg_t.hd).astype(np.float32)
          for _ in range(2)]
    ids = np.array([3, n_pages], np.int32)
    pj = jlayers.paged_prefill_insert(pj, *map(jnp.asarray, kv),
                                      jnp.asarray(ids))
    layers.paged_prefill_insert(pt, *map(_t, kv), _t(ids))
    # one decode write per row: row 1 inactive, row 2 on a -1 entry
    tables = np.array([[3, 1], [2, -1], [5, -1]], np.int32)
    pos = np.array([5, 2, 4], np.int32)
    act = np.array([True, False, True])
    new = [rng.randn(3, 1, cfg_t.n_kv_heads, cfg_t.hd).astype(np.float32)
           for _ in range(2)]
    for i in range(L):
        lj = jax.tree_util.tree_map(lambda a: a[i], pj)
        lj = jlayers.paged_write(lj, *map(jnp.asarray, new),
                                 jnp.asarray(tables), jnp.asarray(pos),
                                 jnp.asarray(act))
        pj = jax.tree_util.tree_map(lambda a, b: a.at[i].set(b), pj, lj)
        layers.paged_write(layers.layer_pool(pt, i), *map(_t, new),
                           _t(tables), _t(pos), _t(act))
    for name in ("k", "v", "kscale", "vscale"):
        np.testing.assert_array_equal(
            getattr(pt, name)[:, :n_pages].numpy(),
            np.asarray(getattr(pj, name)), err_msg=name)


def test_quantize_kv_matches_repro():
    x = np.random.RandomState(6).randn(5, 3, 2, 32).astype(np.float32)
    x[1] = 0.0
    lj, sj = jlayers.quantize_kv(jnp.asarray(x))
    lt, st = layers.quantize_kv(_t(x))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)
    l2, s2 = layers.quantize_kv(lt.float() * st[..., None, None])
    assert torch.equal(l2, lt)            # requantizing is idempotent


# ---------------------------------------------------------------------------
# the page allocator
# ---------------------------------------------------------------------------


def test_page_pool_trace_matches_repro():
    """The same random alloc / release trace through both allocators:
    the same pages handed out, the same refusals, the same counts."""
    rng = np.random.RandomState(7)
    for n_pages in (1, 5, 16):
        pools = PagePool(n_pages, 4), JPagePool(n_pages, 4)
        held, rid = {}, 0
        for _ in range(80):
            want = 1 + int(rng.randint(0, 30)) % n_pages
            got = []
            for pool in pools:
                try:
                    got.append(pool.alloc(want, rid))
                except MemoryError:
                    got.append(None)
            assert got[0] == got[1]
            if got[0] is not None:
                held[rid] = got[0]
                rid += 1
            if held and rng.rand() < 0.6:
                victim = sorted(held)[int(rng.randint(0, len(held)))]
                pages = held.pop(victim)
                for pool in pools:
                    pool.release(pages, victim)
            state = [(p.used_pages, p.free_pages, p.pages_for(7))
                     for p in pools]
            assert state[0] == state[1]
    for pool in (PagePool(4, 2), JPagePool(4, 2)):
        pages = pool.alloc(2, rid=0)
        with pytest.raises(ValueError, match="owned by"):
            pool.release(pages, rid=1)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

REQS = [([5, 6, 7], 6), ([1], 4), ([9, 8, 7, 6, 5], 8), ([3, 3], 5),
        ([11, 2, 4], 7), ([8], 3)]


@pytest.fixture(scope="module")
def served():
    cfg_j = j_get_config("yi-6b", smoke=True)
    cfg_t = dataclasses.replace(get_config("yi-6b", smoke=True),
                                use_pallas=True)
    tree = tie_free_params(cfg_j, 1)
    policy = POLICY_PRESETS["lm_hetero"]
    comp_j = jsc.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                               policy)
    comp_t = sc.compress_tree(params_from_jax(tree, device="cpu"), policy)
    return cfg_j, cfg_t, comp_j, comp_t


def _both(served, reqs=REQS, **kw):
    cfg_j, cfg_t, comp_j, comp_t = served
    kw = {"max_batch": 2, "max_len": 20, "prompt_pad": 6, **kw}
    ej, et = JEngine(comp_j, cfg_j, **kw), ServeEngine(comp_t, cfg_t,
                                                       dispatch=KERNEL, **kw)
    results = []
    for eng in (ej, et):
        for p, n in reqs:
            eng.submit(p, n)
        if eng is et:
            sc.reset_stats()
            reset_launches()
        results.append(eng.run())
    return ej, et, results[0], results[1]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_engine_matches_repro(served, kv_quant):
    ej, et, rj, rt = _both(served, paged=True, page_size=4,
                           kv_quant=kv_quant)
    assert rt["outputs"] == rj["outputs"]
    assert rt["steps"] == rj["steps"] and et.occupancy == ej.occupancy
    assert rt["pool"] == rj["pool"]
    assert et.pool_alloc.used_pages == 0 and (et._tables_np == -1).all()
    L = served[1].n_layers
    assert LAUNCHES["paged_decode"] == L * et.steps
    assert LAUNCHES["sparse_gemm"] == 7 * L * (et.steps + et.admissions)
    assert LAUNCHES["qdq_gemm"] == et.steps + et.admissions
    assert sc.STATS["densify"] == 0


def test_preemption_matches_repro(served):
    reqs = [([5, 6, 7], 12), ([1, 2, 3, 4], 12), ([9, 8], 12)]
    ej, et, rj, rt = _both(served, reqs, paged=True, page_size=4,
                           kv_pool_pages=6)
    assert et.preemptions == ej.preemptions > 0
    assert PAGE_POOL["preemptions"] == et.preemptions
    assert rt["outputs"] == rj["outputs"]
    assert et.admissions == len(reqs) + et.preemptions


def test_admission_stalls_match_repro(served):
    reqs = [([1, 2, 3, 4, 5, 6], 6), ([7, 8, 9, 10, 11, 12], 6)]
    ej, et, rj, rt = _both(served, reqs, max_len=12, paged=True,
                           page_size=4, kv_pool_pages=3)
    assert et.admission_stalls == ej.admission_stalls > 0
    assert et.preemptions == ej.preemptions == 0
    assert rt["outputs"] == rj["outputs"]
    assert rt["pool"]["admission_stalls"] == et.admission_stalls


def test_paged_engine_rejects_bad_config(served):
    cfg_t, comp_t = served[1], served[3]
    with pytest.raises(ValueError, match="kv_quant requires paged"):
        ServeEngine(comp_t, cfg_t, kv_quant=True)
    with pytest.raises(ValueError, match="cannot hold one"):
        ServeEngine(comp_t, cfg_t, max_len=64, page_size=4, paged=True,
                    kv_pool_pages=2)
    gemma = get_config("gemma3-1b", smoke=True)
    with pytest.raises(ValueError, match="paged KV serving requires"):
        ServeEngine(comp_t, gemma, paged=True)
