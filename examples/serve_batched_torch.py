"""Continuous-batching serving on the PyTorch/CUDA port: the twin of
``examples/serve_batched.py``.

Initializes the dense smoke transformer, compresses it with its arch
policy preset, round-trips the compressed tree through a compact
checkpoint, and drives the ServeEngine on a burst of mixed-length
requests, printing the per-request metrics table (queue wait, TTFT,
tokens/s) and the zero-densify counter.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py --arch yi-6b \\
          [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.policies import get_policy_preset
from repro_torch.models import get_model
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import checkpoint as ckpt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--scheduler", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--dense", action="store_true",
                    help="skip compression (dense baseline)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    if cfg.family != "dense":
        raise SystemExit(f"{args.arch} is family={cfg.family!r}; the "
                         f"serving engine drives the dense family")
    model = get_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init_params(gen, cfg, device=args.device)

    if not args.dense:
        policy = get_policy_preset("arch", args.arch)
        comp = sc.compress_tree(params, policy)
        # compact checkpoint round-trip: what lands on disk is the
        # compressed buffers; loading never builds the dense weights
        with tempfile.TemporaryDirectory() as d:
            ckpt.save_compact(d, comp, step=0)
            assert ckpt.is_compact(d)
            params = ckpt.load_compact(d, device=args.device)
        sizes = sc.tree_bytes(params)
        print(f"compressed: {sizes['compressed'] / 1e6:.2f} MB resident "
              f"(dense {sizes['dense'] / 1e6:.2f} MB)")
    sc.reset_stats()

    eng = ServeEngine(params, cfg, max_batch=args.max_batch,
                      max_len=args.prompt_len + args.new_tokens + 4,
                      prompt_pad=args.prompt_len,
                      scheduler=args.scheduler)
    rng = np.random.RandomState(0)
    for _ in range(args.requests):
        plen = int(rng.randint(max(2, args.prompt_len // 2),
                               args.prompt_len + 1))
        eng.submit(rng.randint(0, cfg.vocab, plen).tolist(),
                   max_new_tokens=args.new_tokens)
    res = eng.run()

    print(f"arch={args.arch} scheduler={args.scheduler} "
          f"slots={args.max_batch} requests={len(res['metrics'])}")
    print(" rid  plen  new   wait_ms   ttft_ms    tok/s")
    for m in sorted(res["metrics"].values(), key=lambda m: m.rid):
        print(f"{m.rid:4d} {m.prompt_len:5d} {m.new_tokens:4d} "
              f"{m.queue_wait_s * 1e3:9.1f} {m.ttft_s * 1e3:9.1f} "
              f"{m.tokens_per_s:8.1f}")
    print(f"aggregate: {res['requests_per_s']:.2f} req/s, "
          f"{res['tokens_per_s']:.1f} tok/s over {res['steps']} engine "
          f"steps; peak occupancy {max(eng.occupancy)}/{args.max_batch}")
    print(f"serve stats: {sc.STATS} (densify must stay 0)")
    rid0 = min(res["outputs"])
    print(f"sample (rid {rid0}):", res["outputs"][rid0][:10])


if __name__ == "__main__":
    main()
