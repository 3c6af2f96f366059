"""Distributed LM training launcher (a port of ``repro.launch.train``).

Drives the distributed Qsparse-local-SGD engine (``core/distributed.py``)
for an architecture of the dense family, one process per worker:

  # one GPU, one worker
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --mesh 1x1 --policy preset:arch --wire sparse_allgather
  # eight GPUs of one host, eight workers (NCCL)
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch gemma3-1b --mesh 8x1 --policy preset:arch
  # the CPU, at the smoke size
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --mesh 1x1 --device cpu --steps 4 --H 2

``repro``'s flag names, defaults and log lines (``policy: ...``, one
``step N [sync |local] loss ... bits up ... down ...`` line per step with
the sync's kernel launches, the summary), except that ``--runtime``
defaults to ``step``, the only runtime ported.  Added: ``--device``
(default cuda), ``--seed`` (weights and the stochastic operators' draws),
``--backend`` (``gloo`` for several ranks sharing one GPU) and ``--json``
(the run's record, exact ledgers included).  Every
flag of a feature not ported yet raises ``NotImplementedError`` naming
its ROADMAP item.  Batches come from ``data.LMTokenStream`` (a numpy copy
of ``repro``'s), so a seed gives both packages the same tokens; each
rank takes its own worker's row.  Only rank 0 prints and writes
``--ckpt``.
"""

from __future__ import annotations

import argparse
import json
import time
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_policy_preset
from repro_torch.core import policy as pol
from repro_torch.core.distributed import ShardCompressor, make_dist_steps
from repro_torch.data import LMTokenStream
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.launch.mesh import data_axes, make_mesh, worker_count
from repro_torch.models import get_model
from repro_torch.optim import momentum_sgd, warmup_piecewise
from repro_torch.sharding.specs import param_specs
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, value_and_grad

#: flags of features the port has not reached: (flag, test on the parsed
#: args, ROADMAP item)
UNPORTED = (
    ("--runtime round", lambda a: a.runtime == "round",
     "queue 1 item 9 (round runtime)"),
    ("--overlap", lambda a: a.overlap or a.overlap_window != 8,
     "queue 1 item 9 (overlapped rounds)"),
    ("--scenario", lambda a: a.scenario is not None,
     "queue 1 item 10 (scenarios)"),
    ("--faults", lambda a: (a.faults is not None or a.fault_seed is not None
                            or a.staleness_weight != "uniform"),
     "queue 1 item 10 (faults)"),
    ("--tune", lambda a: a.tune or a.retune,
     "queue 1 item 11 (autotune)"),
    ("--zero1", lambda a: a.zero1, "queue 1 item 12 (ZeRO-1)"),
)


def resolve_policy_arg(args) -> pol.ChannelSpec:
    """One ChannelSpec from the CLI (``repro``'s rules): ``--policy``
    takes an inline DSL string, ``@file.json`` or ``preset:<name>`` /
    ``preset:arch``; the deprecated ``--compressor`` / ``--downlink``
    flags map onto the equivalent catch-all policy."""
    legacy = (args.compressor is not None or args.downlink is not None
              or args.downlink_k_frac is not None)
    if args.policy is not None:
        if legacy:
            raise SystemExit(
                "--policy conflicts with the deprecated --compressor/"
                "--downlink/--downlink-k-frac flags; put both directions "
                "in the policy ('uplink >> downlink')")
        if args.policy.startswith("preset:"):
            spec = get_policy_preset(args.policy[len("preset:"):],
                                     arch=args.arch)
        else:
            spec = pol.load(args.policy)
        return pol.as_channel_spec(spec)
    if legacy:
        pol.warn_once(
            "launch-legacy-flags",
            "--compressor/--downlink/--downlink-k-frac are deprecated; "
            "use --policy (e.g. --policy 'topk:k=0.01 >> topk:k=0.05')",
            stacklevel=2)
    up_name = args.compressor or "topk"
    up = (pol.PolicySpec.catch_all("identity") if up_name == "none"
          else pol.PolicySpec.catch_all(
              pol.OpSpec(up_name, (("k", args.k_frac),))
              if pol.OpSpec.parse(up_name).takes("k")
              else pol.OpSpec.parse(up_name)))
    down = None
    if args.downlink is not None and args.downlink != "identity":
        dk = (args.downlink_k_frac if args.downlink_k_frac is not None
              else args.k_frac)
        dspec = (pol.OpSpec(args.downlink, (("k", dk),))
                 if pol.OpSpec.parse(args.downlink).takes("k")
                 else pol.OpSpec.parse(args.downlink))
        down = pol.PolicySpec.catch_all(dspec)
    return pol.ChannelSpec(up, down)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--mesh", default="4x2",
                    help="DxM or PxDxM mesh; P*D ranks, M must be 1")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--H", type=int, default=4)
    ap.add_argument("--k-frac", type=float, default=0.01)
    ap.add_argument("--policy", default=None,
                    help="compression policy (DESIGN.md §6): inline DSL, "
                         "@file.json, or preset:<name>|preset:arch")
    ap.add_argument("--compressor", default=None,
                    choices=["topk", "signtopk", "none"],
                    help="DEPRECATED: use --policy")
    ap.add_argument("--dispatch", default="auto",
                    choices=["auto", "kernel", "reference"],
                    help="compression kernel routing: auto = the CUDA "
                         "kernels for tensors on a GPU")
    ap.add_argument("--aggregate", default="mean_R",
                    choices=["mean_R", "mean_S", "support_weighted",
                             "dense_psum", "sparse_allgather"],
                    help="master division rule (DESIGN.md §8); the legacy "
                         "wire values map onto --wire")
    ap.add_argument("--wire", default="dense_psum",
                    choices=["dense_psum", "sparse_allgather"],
                    help="sync transport: dense all-reduce, or compact "
                         "(idx, val) all-gather")
    ap.add_argument("--scenario", default=None, help="not ported")
    ap.add_argument("--runtime", default="step", choices=["round", "step"],
                    help="execution runtime; only 'step' is ported")
    ap.add_argument("--overlap", action="store_true", help="not ported")
    ap.add_argument("--overlap-window", type=int, default=8,
                    help="not ported")
    ap.add_argument("--tune", action="store_true", help="not ported")
    ap.add_argument("--retune", action="store_true", help="not ported")
    ap.add_argument("--faults", default=None, help="not ported")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="not ported")
    ap.add_argument("--staleness-weight", default="uniform",
                    choices=["uniform", "damped"], help="not ported")
    ap.add_argument("--downlink", default=None,
                    help="DEPRECATED: use --policy; only 'identity' (the "
                         "exact broadcast) is ported")
    ap.add_argument("--downlink-k-frac", type=float, default=None,
                    help="DEPRECATED: use --policy")
    ap.add_argument("--zero1", action="store_true", help="not ported")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "nccl", "gloo"],
                    help="process-group backend: auto = nccl on cuda, gloo "
                         "on the cpu; gloo for ranks sharing one GPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="write the run's record (losses, exact ledgers "
                         "per step, launches per sync, step times) here")
    return ap


def refuse_unported(args) -> None:
    for flag, used, item in UNPORTED:
        if used(args):
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet: ROADMAP {item}")


def is_sync(t: int, args) -> bool:
    """The fixed schedule: every H-th step and the last one sync."""
    return (t + 1) % args.H == 0 or t == args.steps - 1


def _note(counts: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in counts.items() if v) or "none"


def main(argv: Optional[list] = None) -> dict:
    """Run the launcher; returns the run's record (losses, step kinds
    and times, ledgers, launches per sync, peak device memory)."""
    args = parser().parse_args(argv)
    refuse_unported(args)
    channel_spec = resolve_policy_arg(args)
    if channel_spec.downlink is not None:
        raise NotImplementedError(
            "a compressed downlink is not ported to repro_torch yet: "
            "ROADMAP queue 1 item 12")
    mesh = make_mesh(args.mesh, device=args.device, backend=args.backend)
    try:
        return _run(args, channel_spec, mesh)
    finally:
        mesh.close()


def setup(args, channel_spec, mesh) -> types.SimpleNamespace:
    """The run's pieces: config, initial state, the two steps, the batch
    stream (this rank's rows), the shared generator and printer."""
    dev = mesh.device
    cfg = get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    grad_fn = value_and_grad(lambda p, b: model.loss_fn(p, b, cfg)[0])
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say("policy:", channel_spec.to_string(), flush=True)
    uplink = ShardCompressor.from_spec(channel_spec.uplink, params,
                                       dispatch=args.dispatch)
    init_fn, local_step, sync_step = make_dist_steps(
        grad_fn, momentum_sgd(0.9),
        uplink if uplink is not None
        else ShardCompressor("none", dispatch=args.dispatch),
        warmup_piecewise(args.lr, 5, [int(args.steps * 0.8)]),
        mesh, data_axes(mesh), param_specs(cfg), aggregate=args.aggregate,
        wire=args.wire)
    R = worker_count(mesh)
    stream = LMTokenStream(vocab=cfg.vocab, R=R, order=64, seed=0)

    def batches():
        for batch in stream.batches(args.batch, args.seq, args.steps,
                                    seed=1):
            b = {"tokens": torch.from_numpy(
                batch["tokens"][mesh.rank]).to(dev)}
            if cfg.modality:
                b["prefix_embeds"] = 0.02 * torch.randn(
                    (args.batch, cfg.n_frontend_tokens, cfg.d_model),
                    generator=rng, device=dev)
            yield b

    # every rank draws the stochastic leaves' randomness alike (repro's
    # key is replicated over the worker axes)
    rng = torch.Generator(device=dev).manual_seed(args.seed + 1)
    return types.SimpleNamespace(
        cfg=cfg, R=R, state=init_fn(params), local_step=local_step,
        sync_step=sync_step, batches=batches, rng=rng, say=say)


def _run(args, channel_spec, mesh) -> dict:
    dev = mesh.device
    run = setup(args, channel_spec, mesh)
    state, say, R = run.state, run.say, run.R
    run.state = None        # so the initial state goes once it is replaced
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {"loss": [], "kind": [], "ms": [], "bits_up": [], "bits_down": [],
           "launches_per_sync": []}
    t0 = time.time()
    for t, b in enumerate(run.batches()):
        sync = is_sync(t, args)
        before = dict(LAUNCHES)
        ts = time.perf_counter()
        step = run.sync_step if sync else run.local_step
        state, loss = step(state, b, run.rng)
        loss, up = float(loss), float(state.bits)       # synchronizes
        rec["ms"].append((time.perf_counter() - ts) * 1e3)
        down = float(state.bits_down)
        note = ""
        if sync:
            counts = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            rec["launches_per_sync"].append(counts)
            note = f" launches/round [{_note(counts)}]"
        rec["loss"].append(loss)
        rec["kind"].append("sync" if sync else "local")
        rec["bits_up"].append(up)
        rec["bits_down"].append(down)
        say(f"step {t + 1:4d} [{'sync ' if sync else 'local'}] loss "
            f"{loss:.4f} bits up {up:.3g} down {down:.3g}{note}", flush=True)
    dt = time.time() - t0
    total = float(state.bits) + float(state.bits_down)
    say(f"\n{args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} it/s); "
        f"R={R} workers, {state.rounds} sync rounds, "
        f"{float(state.bits):.3g} uplink + {float(state.bits_down):.3g} "
        f"downlink = {total:.3g} wire bits", flush=True)
    if dev.type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        say(f"peak device memory {rec['peak_device_bytes']} bytes",
            flush=True)
    if not np.all(np.isfinite(rec["loss"])):
        raise FloatingPointError(f"loss not finite: {rec['loss']}")
    if args.ckpt and mesh.rank == 0:
        # the policy rides along so a resume reproduces the per-leaf
        # operators (and so the bits)
        t_save = time.perf_counter()
        checkpoint.save(args.ckpt, state.master, step=args.steps,
                        policy=channel_spec.to_dict())
        rec["ckpt_s"] = time.perf_counter() - t_save
        say("checkpoint saved to", args.ckpt, flush=True)
    rec.update(R=R, rounds=state.rounds, wall_s=dt,
               n_params=sum(p.numel() for p in tree_leaves(state.master)))
    if args.json and mesh.rank == 0:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
