"""Serving launcher: a (compressed) dense transformer through the
continuous-batching engine, on the card (a port of
``repro.launch.serve``, with the same flags).

Without ``--checkpoint`` it serves a random init from ``--seed``, as
``repro``'s does; under ``--compressed`` the weights are compressed once
at load with ``--policy`` (default: the arch's preset).  Loading a
checkpoint waits for the checkpoint module (ROADMAP queue 1 items 7 and
14).  ``--flash`` routes decode attention through the flash-decode
kernel (with ``--paged``: the paged-decode kernel).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --compressed --paged --kv-quant --flash --max-batch 8 --max-len 512 \\
      --prompt-len 128 --new-tokens 64 --requests 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.policies import get_policy_preset
from repro_torch.core import policy as pol
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import DispatchConfig
from repro_torch.models import get_model
from repro_torch.serve import compressed as sc
from repro_torch.serve.engine import ServeEngine

#: ``repro.train.checkpoint.COMPACT_FORMAT``: a manifest naming it holds a
#: compact serving checkpoint
COMPACT_FORMAT = "compact-v1"


def resolve_policy(arg, arch):
    """Policy used for --compressed: an explicit --policy (DSL string,
    @file.json, or preset:<name> | preset:arch), else the arch preset."""
    if arg:
        if arg.startswith("preset:"):
            return get_policy_preset(arg[len("preset:"):], arch)
        return pol.load(arg)
    return get_policy_preset("arch", arch)


def _refuse_checkpoint(path: str):
    compact = False
    mpath = os.path.join(path, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            compact = json.load(f).get("format") == COMPACT_FORMAT
    item = ("14 (compact-v1 checkpoints, train/checkpoint.py load_compact)"
            if compact else "7 (train/checkpoint.py restore)")
    raise NotImplementedError(
        f"loading checkpoints is not ported to repro_torch yet: ROADMAP "
        f"queue 1 item {item}")


def load_params(args, cfg, model, device):
    """(params, source): a random init from --seed (checkpoints are not
    ported yet), compressed at load under --compressed."""
    if args.checkpoint:
        _refuse_checkpoint(args.checkpoint)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, cfg, device=device)
    src = "random init (no --checkpoint)"
    if args.compressed:
        policy = resolve_policy(args.policy, args.arch)
        params = sc.compress_tree(params, policy)
        src += " -> compressed at load"
    return params, src


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a (compressed) model with continuous batching")
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="dense or compact checkpoint directory (not "
                         "ported yet: raises)")
    ap.add_argument("--compressed", action="store_true",
                    help="serve from compressed weights (policy-guided "
                         "one-shot compression at load)")
    ap.add_argument("--policy", default=None,
                    help="compression policy: DSL string, @file.json, "
                         "preset:<name> or preset:arch (default: the "
                         "arch preset)")
    ap.add_argument("--scheduler", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (continuous-batching width)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="synthetic prompt length cap (also the prefill "
                         "pad)")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic request count")
    ap.add_argument("--flash", action="store_true",
                    help="route decode attention through the flash-decode "
                         "kernel (paged: the paged-decode kernel)")
    ap.add_argument("--paged", action="store_true",
                    help="shared KV page pool + block tables instead of "
                         "per-slot contiguous caches")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 pages + per-slot f32 scales (--paged)")
    ap.add_argument("--kv-pool-pages", type=int, default=None,
                    help="total pool pages (default: max-batch * "
                         "ceil(max-len / page-size))")
    ap.add_argument("--dispatch", choices=("auto", "kernel", "reference"),
                    default="auto",
                    help="kernel dispatch mode (auto: the CUDA kernels on "
                         "the card)")
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="write the metrics summary to this file")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.flash:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    if cfg.family != "dense":
        raise SystemExit(
            f"the serving engine drives the dense transformer family "
            f"(arch {args.arch} is family={cfg.family!r})")
    if args.kv_quant and not args.paged:
        raise SystemExit("--kv-quant requires --paged")
    device = resolve_device(args.device)
    model = get_model(cfg)
    dispatch = DispatchConfig(mode=args.dispatch)

    params, source = load_params(args, cfg, model, device)
    sc.reset_stats()
    sizes = sc.tree_bytes(params)
    print(f"arch={args.arch} device={device} source: {source}")
    print(f"resident params: {sizes['compressed'] / 1e6:.2f} MB "
          f"(dense equivalent {sizes['dense'] / 1e6:.2f} MB, "
          f"{sizes['leaves']} leaves)")

    eng = ServeEngine(params, cfg, max_batch=args.max_batch,
                      max_len=args.max_len, prompt_pad=args.prompt_len,
                      scheduler=args.scheduler, paged=args.paged,
                      page_size=args.page_size, kv_quant=args.kv_quant,
                      kv_pool_pages=args.kv_pool_pages, dispatch=dispatch)
    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        plen = int(rng.randint(max(2, args.prompt_len // 2),
                               args.prompt_len + 1))
        eng.submit(rng.randint(0, cfg.vocab, plen).tolist(),
                   max_new_tokens=args.new_tokens)
    res = eng.run()

    mets = sorted(res["metrics"].values(), key=lambda m: m.rid)
    print(f"\nscheduler={args.scheduler} slots={args.max_batch} "
          f"requests={len(mets)} steps={res['steps']}")
    print(" rid  plen  new   wait_ms   ttft_ms    tok/s")
    for m in mets:
        print(f"{m.rid:4d} {m.prompt_len:5d} {m.new_tokens:4d} "
              f"{m.queue_wait_s * 1e3:9.1f} {m.ttft_s * 1e3:9.1f} "
              f"{m.tokens_per_s:8.1f}")
    print(f"\naggregate: {res['requests_per_s']:.2f} req/s, "
          f"{res['tokens_per_s']:.1f} tok/s, "
          f"wall {res['wall_s']:.2f}s, peak occupancy "
          f"{max(eng.occupancy) if eng.occupancy else 0}/{args.max_batch}")
    if args.paged:
        pool = res["pool"]
        print(f"page pool: {pool['peak_pages_used']}/{pool['n_pages']} "
              f"peak pages ({pool['page_size']} tok/page, "
              f"{'int8' if pool['kv_quant'] else 'fp'} layout), "
              f"{pool['pages_used']} in use at exit")
        print(f"  preemptions={pool['preemptions']} "
              f"admission_stalls={pool['admission_stalls']} "
              f"fragmentation={pool['fragmentation']:.4f}")
    print(f"serve stats: {sc.STATS}")
    if args.compressed and sc.STATS["densify"]:
        raise SystemExit("zero-densify violated: the serving path "
                         f"densified {sc.STATS['densify']} leaves")
    if args.json:
        with open(args.json, "w") as f:
            payload = {
                "requests_per_s": res["requests_per_s"],
                "tokens_per_s": res["tokens_per_s"],
                "steps": res["steps"],
                "densify": sc.STATS["densify"],
            }
            if args.paged:
                payload["pool"] = res["pool"]
            json.dump(payload, f, indent=2)
    print("sample:", res["outputs"].get(0, [])[:10])


if __name__ == "__main__":
    main()
