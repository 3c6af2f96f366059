"""The port's inner optimizers and learning-rate schedules against
``repro``'s, run eagerly on the same numpy inputs.  Both evaluate in
float32 in the same expression order (float32 powers as libm's
``powf``), so results agree exactly except where noted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 0.01}),
    ("momentum", {"momentum": 0.9}),
    ("momentum", {"momentum": 0.8, "nesterov": True, "weight_decay": 1e-3}),
    ("adam", {}), ("adam", {"b1": 0.8, "eps": 1e-6, "weight_decay": 0.1}),
])
def test_optimizer_matches_repro(name, kw):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    oj, ot = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        lr = np.float32(0.05 / (1 + step))
        uj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj,
                           jnp.asarray(lr))
        ut, st = ot.update({k: torch.from_numpy(v) for k, v in g.items()},
                           st, pt, torch.tensor(lr))
        pj = jopt.apply_updates(pj, uj)
        pt = topt.apply_updates(pt, ut)
        for k in params:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    with pytest.raises(KeyError):
        topt.make_optimizer("lion")


SCHEDULES = [
    ("constant", (0.1,)),
    ("inverse_time", (60.0, 100.0)),
    ("paper_convex_lr", (2.0, 0.01, 784, 4, 8)),
    ("piecewise_decay", (0.05, [3, 7])),
    ("piecewise_decay", (0.2, [2, 4, 6], 0.5)),
    ("warmup_piecewise", (0.1, 4, [6, 9])),
    ("warmup_cosine", (0.3, 3, 12)),
    ("warmup_cosine", (0.3, 0, 12, 0.0)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedule_matches_repro(name, args):
    fj, ft = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(14):
        want = np.float32(fj(jnp.asarray(step, jnp.int32)))
        got = ft(step)
        assert got.dtype == torch.float32
        if name == "warmup_cosine":  # cos: XLA's and libm's differ by an ulp
            np.testing.assert_allclose(float(got), want, rtol=1e-6)
        else:
            assert np.float32(got.item()) == want, (name, step)
