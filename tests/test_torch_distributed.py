"""The port's distributed engine against ``repro``.

``repro``'s own multi-device tests do not run on jax 0.9.0 (they fail
inside ``shard_map``), so the port is held part by part,
every ``repro`` function run outside ``shard_map``:

  * ``axis_topk`` / ``axis_topk_compact`` against ``repro``'s on
    tie-free leaves: survivor slots, memory and bits equal;
  * ``ShardCompressor.__call__`` / ``compact`` on the gemma3-1b smoke
    model's gradients against ``repro``'s: the same payload kinds and
    moved shapes, equal bits, arrays within 1e-6;
  * ``make_dist_steps`` against ``repro``'s single-process
    ``qsparse.make_step`` with the column Top_k operator built from
    ``axis_topk`` (the construction of ``tests/test_distributed.py``'s
    ``DIST_MATCHES_REFERENCE``): 32 steps at H = 4, loss within 2e-5
    and master within rtol 1e-4 / atol 1e-5, that test's tolerances (the
    two frameworks round the SGD update and the mean in another order).
    At world size 1 in this process, and at R = 4 gloo ranks spawned on
    the CPU, once for each wire; the wires give equal bits.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core import policy as pol
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.launch.mesh import Mesh, run_local_ranks
from repro_torch.optim import constant, sgd
from repro_torch.sharding import param_specs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.tree import tree_leaves, value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import distributed as jd
    from repro.kernels import dispatch as jdsp
    return types.SimpleNamespace(jax=jax, jnp=jnp, P=P, D=jd, dsp=jdsp)


def tie_free(rng, shape, lo=0.05, hi=4.0):
    d = int(np.prod(shape))
    mags = np.linspace(lo, hi, d, dtype=np.float32)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mags * signs)[rng.permutation(d)].reshape(shape)


@pytest.mark.parametrize("sign", [False, True])
@pytest.mark.parametrize("shape,axis", [((6, 128, 20), 1), ((40, 256), 1),
                                        ((256, 24), 0)])
def test_axis_topk_matches_repro(jx, shape, axis, sign):
    x = tie_free(np.random.default_rng(sum(shape)), shape)
    xj, xt = jx.jnp.asarray(x), torch.from_numpy(x)
    out_j, bits_j = jx.D.axis_topk(xj, 0.05, axis, sign_bits=sign)
    out_t, bits_t = D.axis_topk(xt, 0.05, axis, sign_bits=sign)
    assert float(bits_t) == float(bits_j)
    np.testing.assert_array_equal(out_t.numpy() != 0, np.asarray(out_j) != 0)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-6 if sign else 0,
                               atol=0)
    cfg = D.dsp.DispatchConfig(mode="kernel")
    ij, vj, mj, bj, moved_j = jx.D.axis_topk_compact(
        xj, 0.05, axis, sign_bits=sign,
        dispatch_cfg=jx.dsp.DispatchConfig(mode="kernel"))
    it, vt, mt, bt, moved_t = D.axis_topk_compact(xt, 0.05, axis,
                                                  sign_bits=sign,
                                                  dispatch_cfg=cfg)
    assert moved_t == tuple(moved_j) and float(bt) == float(bj)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-6 if sign else 0,
                               atol=0)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-6 if sign else 0,
                               atol=1e-6 if sign else 0)
    # the compact slots decode to the dense survivors
    np.testing.assert_allclose(D._densify(it, vt, moved_t, axis).numpy(),
                               out_t.numpy(), rtol=1e-6 if sign else 0,
                               atol=0)


def test_pick_axis_follows_the_model_axis(jx):
    for shape, spec in [((26, 1152, 6912), (None, None, "model")),
                        ((26, 6912, 1152), (None, "model", None)),
                        ((262144, 1152), ("model", None)), ((1152,), (None,)),
                        ((4, 1, 8), (None, None, ("pod", "model"))),
                        ((5, 3), None)]:
        jspec = None if spec is None else jx.P(*spec)
        assert D._pick_axis(shape, spec) == jx.D._pick_axis(shape, jspec)


# ---------------------------------------------------------------------------
# ShardCompressor on the gemma3-1b smoke gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma_grads(jx):
    """repro's gemma3-1b smoke gradients (numpy), its params and specs."""
    from repro.configs import get_config as jget
    from repro.configs.base import NO_SHARDING
    from repro.models import transformer as jtf
    from repro.sharding.specs import param_specs as jspecs
    jcfg = jget("gemma3-1b", smoke=True)
    params = jtf.init_params(jx.jax.random.PRNGKey(0), jcfg)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 33))
    grads = jx.jax.grad(lambda p: jtf.loss_fn(
        p, {"tokens": jx.jnp.asarray(toks, jx.jnp.int32)}, jcfg,
        NO_SHARDING)[0])(params)
    as_np = jx.jax.tree_util.tree_map(np.asarray, grads)
    return as_np, jx.jax.tree_util.tree_map(np.asarray, params), jspecs(jcfg)


def _compressors(jx, params_np, kind: str, dispatch: str):
    if kind == "policy":
        text = "ln|norm->identity;.*->topk:k=0.01"
        from repro.core import policy as jpol
        jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, params_np)
        cj = jx.D.ShardCompressor.from_spec(jpol.parse(text), jp,
                                            dispatch=dispatch)
        ct = D.ShardCompressor.from_spec(
            pol.parse(text), params_from_jax(params_np, device="cpu"),
            dispatch=dispatch)
        return cj, ct
    return (jx.D.ShardCompressor(kind, 0.01, dispatch=dispatch),
            D.ShardCompressor(kind, 0.01, dispatch=dispatch))


@pytest.mark.parametrize("kind", ["policy", "signtopk"])
def test_shard_compressor_matches_repro(jx, gemma_grads, kind):
    grads_np, params_np, jspecs = gemma_grads
    cj, ct = _compressors(jx, params_np, kind, "kernel")
    specs = param_specs(get_config("gemma3-1b", smoke=True))
    gj = jx.jax.tree_util.tree_map(jx.jnp.asarray, grads_np)
    gt = params_from_jax(grads_np, device="cpu")
    tol = dict(rtol=1e-6, atol=1e-6 * max(
        float(np.abs(g).max()) for g in jx.jax.tree_util.tree_leaves(
            grads_np)))
    # dense form
    before = dict(LAUNCHES)
    out_t, bits_t = ct(gt, specs)
    # repro pins each dense output to its spec, which needs a mesh in
    # context: one CPU device on (data, model)
    from repro.compat import set_mesh
    auto = (jx.jax.sharding.AxisType.Auto,) * 2
    with set_mesh(jx.jax.make_mesh((1, 1), ("data", "model"),
                                   axis_types=auto)):
        out_j, bits_j = cj(gj, jspecs)
    assert float(bits_t) == float(bits_j)
    for a, b in zip(tree_leaves(out_t), jx.jax.tree_util.tree_leaves(out_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    # compact form
    pay_t, _, cbits_t, mem_t = ct.compact(gt, specs)
    pay_j, _, cbits_j, mem_j = cj.compact(gj, jspecs)
    assert float(cbits_t) == float(cbits_j) == float(bits_t)
    n_sparse = 0
    for pt, pj in zip(pay_t, pay_j):
        assert pt[0] == pj[0]
        if pt[0] == "dense":
            np.testing.assert_allclose(pt[1].numpy(), pj[1], **tol)
            continue
        n_sparse += 1
        assert pt[3] == pj[3] and pt[4] == tuple(pj[4])
        np.testing.assert_array_equal(pt[1].numpy(), pj[1])
        np.testing.assert_allclose(pt[2].numpy(), pj[2], **tol)
    for a, b in zip(tree_leaves(mem_t), jx.jax.tree_util.tree_leaves(mem_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    meta = ct.leaf_meta(gt, specs)
    assert [m[0] for m in meta] == [p[0] for p in pay_t]
    assert meta == [tuple(m) if m[0] == "dense" else (m[0], m[1],
                                                      tuple(m[2]))
                    for m in cj.leaf_meta(gj, jspecs)]
    # one launch per Top_k leaf in each form
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert launched["topk_compress"] == launched["topk_compact"] == n_sparse
    assert ct.gamma() == cj.gamma()


def test_from_spec_identity_and_unported(jx):
    params = {"w": torch.zeros(4, 256), "norm": torch.zeros(256)}
    assert D.ShardCompressor.from_spec("identity", params) is None
    comp = D.ShardCompressor.from_spec(
        pol.parse("norm->identity;.*->topk:k=40"), params)
    # an absolute k becomes the leaf fraction
    assert comp.ops["w"].k == pytest.approx(40 / 1024)
    mesh = Mesh((1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 12"):
        D.make_dist_steps(None, sgd(), comp, constant(0.1), mesh)
    mesh = Mesh((1, 1), ("data", "model"))
    for kw, item in ((dict(zero1=True), "item 12"),
                     (dict(downlink=D.ShardCompressor("topk")), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            D.make_dist_steps(None, sgd(), comp, constant(0.1), mesh, **kw)


# ---------------------------------------------------------------------------
# the engine against repro's single-process qsparse
# ---------------------------------------------------------------------------

D_IN, D_OUT, STEPS, H = 16, 8, 32, 4


def regression_data(R: int):
    """Per-step worker batches [R, 16, d_in] and targets of a fixed
    linear teacher, from numpy."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(D_IN, D_OUT).astype(np.float32)
    xs = [rng.randn(R, 16, D_IN).astype(np.float32) for _ in range(STEPS)]
    return [(x, x @ w_true) for x in xs]


def repro_reference(jx, R: int):
    """repro's qsparse.make_step with the column Top_k operator: losses,
    bits, master w."""
    from repro.core import operators as ops
    from repro.core import qsparse
    from repro.optim import constant as jconst
    from repro.optim import sgd as jsgd
    jnp = jx.jnp

    def grad_fn(p, batch):
        x, y = batch
        return jx.jax.value_and_grad(
            lambda pp: jnp.mean((x @ pp["w"] + pp["b"] - y) ** 2))(p)

    class ColTopK(ops.CompressionOp):
        def __call__(self, key, x):
            if x.size <= 8:
                return x.astype(jnp.float32), jnp.float32(32 * x.size)
            return jx.D.axis_topk(x, 0.25, 0)

        def gamma(self, d):
            return 0.25

    params = {"w": jnp.zeros((D_IN, D_OUT)), "b": jnp.zeros((D_OUT,))}
    state = qsparse.init(params, jsgd(), R)
    step = jx.jax.jit(qsparse.make_step(grad_fn, jsgd(), ColTopK(),
                                        jconst(0.1), R),
                      static_argnames=("sync",))
    losses = []
    for t, (x, y) in enumerate(regression_data(R)):
        state, loss = step(state, (jnp.asarray(x), jnp.asarray(y)),
                           sync=(t + 1) % H == 0,
                           key=jx.jax.random.PRNGKey(t))
        losses.append(float(loss))
    return np.array(losses), float(state.bits), np.asarray(state.master["w"])


def run_port(mesh, wire: str, R: int, rank: int):
    """The port's engine for this rank: losses, bits, master w."""
    specs = {"w": (None, "model"), "b": ("model",)}
    grad_fn = value_and_grad(
        lambda p, b: ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean())
    init, local, sync = D.make_dist_steps(
        grad_fn, sgd(), D.ShardCompressor("topk", 0.25, dispatch="kernel"),
        constant(0.1), mesh, ("data",), specs, wire=wire)
    state = init({"w": torch.zeros(D_IN, D_OUT), "b": torch.zeros(D_OUT)})
    losses = []
    for t, (x, y) in enumerate(regression_data(R)):
        step = sync if (t + 1) % H == 0 else local
        state, loss = step(state, (torch.from_numpy(x[rank]),
                                   torch.from_numpy(y[rank])))
        losses.append(float(loss))
    return np.array(losses), float(state.bits), state.master["w"].numpy()


def assert_matches_reference(port, ref):
    np.testing.assert_allclose(port[0], ref[0], rtol=2e-5, atol=2e-5)
    assert port[1] == ref[1]
    np.testing.assert_allclose(port[2], ref[2], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wire", ["dense_psum", "sparse_allgather"])
def test_engine_matches_reference_world_1(jx, wire):
    mesh = Mesh((1, 1), ("data", "model"))
    before = LAUNCHES["topk_compact"] + LAUNCHES["topk_compress"]
    port = run_port(mesh, wire, 1, 0)
    # w's compression rows (its 16-long axis 0) are not lane-aligned, so
    # even dispatch "kernel" keeps them on the plain path, as repro does
    assert LAUNCHES["topk_compact"] + LAUNCHES["topk_compress"] == before
    assert_matches_reference(port, repro_reference(jx, 1))


def _run_rounds_port(mesh, wire: str, overlap: bool):
    """The round runtime on the same regression: a round of H steps a
    call (or windows of two rounds), losses, bits, master w."""
    from repro_torch.core.engine import stack_block, stack_window
    specs = {"w": (None, "model"), "b": ("model",)}
    grad_fn = value_and_grad(
        lambda p, b: ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean())
    make = D.make_dist_multiround if overlap else D.make_dist_round
    init, fn, fused = make(
        grad_fn, sgd(), D.ShardCompressor("topk", 0.25, dispatch="kernel"),
        constant(0.1), mesh, ("data",), specs, wire=wire)
    state = init({"w": torch.zeros(D_IN, D_OUT), "b": torch.zeros(D_OUT)})
    steps = [(x[0], y[0]) for x, y in regression_data(1)]
    losses = []
    W = 2 if overlap else 1
    for i in range(0, STEPS, W * H):
        chunk = steps[i:i + W * H]
        if overlap:
            state, ls, leds = fn(state, stack_window(chunk, W, H))
            assert leds["rounds"].tolist() == [state.rounds - 1,
                                               state.rounds]
        else:
            state, ls = fn(state, stack_block(chunk))
        losses += ls.reshape(-1).tolist()
    return (np.array(losses), float(state.bits), state.master["w"].numpy(),
            fused)


@pytest.mark.parametrize("wire", ["dense_psum", "sparse_allgather"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_round_runtime_matches_steps_world_1(wire, overlap, fused,
                                            monkeypatch):
    """make_dist_round / make_dist_multiround at R = 1 equal the steps
    bit for bit: one program a round (fused), or the per-step
    composition a gloo mesh of several ranks gets (host blocks moved to
    the device step by step)."""
    mesh = Mesh((1, 1), ("data", "model"))
    want = run_port(mesh, wire, 1, 0)
    if not fused:
        monkeypatch.setattr(D, "round_fused", lambda m: False)
    got = _run_rounds_port(mesh, wire, overlap)
    assert got[3] is fused
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_round_fused_follows_the_mesh():
    """Fused on the CPU, and on the card in a world of one whose
    collectives stay on the device (NCCL's captured with the round);
    the per-step composition for gloo on the card (staged through the
    host) and for several NCCL ranks."""
    cuda = torch.device("cuda")
    assert D.round_fused(Mesh((1, 1), ("data", "model")))
    assert D.round_fused(Mesh((4, 1), ("data", "model"), world_size=4,
                              backend="gloo"))
    assert D.round_fused(Mesh((1, 1), ("data", "model"), device=cuda,
                              backend="nccl"))
    assert D.round_fused(Mesh((1, 1), ("data", "model"), device=cuda))
    assert not D.round_fused(Mesh((1, 1), ("data", "model"), device=cuda,
                                  backend="gloo"))
    assert not D.round_fused(Mesh((4, 1), ("data", "model"), world_size=4,
                                  device=cuda, backend="gloo"))
    assert not D.round_fused(Mesh((4, 1), ("data", "model"), world_size=4,
                                  device=cuda, backend="nccl"))


RANK_SCRIPT = r"""
import sys
import numpy as np
sys.path[:0] = [{src!r}, {tests!r}]
import test_torch_distributed as T
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh("4x1", device="cpu")
try:
    losses, bits, w = T.run_port(mesh, sys.argv[1], 4, mesh.rank)
    if mesh.rank == 0:
        np.savez(sys.argv[2], losses=losses, bits=bits, w=w)
finally:
    mesh.close()
"""


@pytest.fixture(scope="module")
def four_rank_runs(tmp_path_factory, jx):
    """Both wires at R = 4 gloo ranks on the CPU (one spawn of four
    processes per wire), and repro's R = 4 reference."""
    tmp = tmp_path_factory.mktemp("ranks")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT.format(src=os.path.join(REPO, "src"),
                                         tests=os.path.join(REPO, "tests")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = {}
    for wire in ("dense_psum", "sparse_allgather"):
        res = tmp / f"{wire}.npz"
        ranks = run_local_ranks([sys.executable, str(script), wire, str(res)],
                                4, env=env, timeout=300)
        for rc, _stdout, stderr in ranks:
            assert rc == 0, stderr[-3000:]
        with np.load(res) as f:
            out[wire] = (f["losses"], float(f["bits"]), f["w"])
    return out, repro_reference(jx, 4)


@pytest.mark.parametrize("wire", ["dense_psum", "sparse_allgather"])
def test_engine_matches_reference_four_ranks(four_rank_runs, wire):
    runs, ref = four_rank_runs
    assert_matches_reference(runs[wire], ref)


def test_four_ranks_wires_agree(four_rank_runs):
    runs, _ = four_rank_runs
    dense, sparse = runs["dense_psum"], runs["sparse_allgather"]
    assert dense[1] == sparse[1]
    np.testing.assert_allclose(sparse[0], dense[0], rtol=2e-6, atol=0)
    np.testing.assert_allclose(sparse[2], dense[2], rtol=1e-5, atol=1e-6)
