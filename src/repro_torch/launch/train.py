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

``repro``'s flag names, defaults and log lines (``policy: ...``,
``runtime: ...``, one ``step N [sync |local] loss ... bits up ... down
...`` line per step with the sync's kernel launches, the summary).
``--runtime round`` (the default) runs each sync round as one program,
a CUDA graph on the card where the mesh allows it (a window of one
round of ``core.distributed.make_dist_multiround``; ``--overlap``:
windows of up to ``--overlap-window`` rounds); ``--runtime
step`` runs the steps eagerly.  The log and the ledgers are the same
either way: a mid-round step reports the bits of the round before.
Added: ``--device`` (default cuda), ``--seed`` (weights and the
stochastic operators' draws), ``--backend`` (``gloo`` for several ranks
sharing one GPU) and ``--json`` (the run's record, exact ledgers
included).  Every flag of a feature not ported yet raises
``NotImplementedError`` naming its ROADMAP item.  Batches come from
``data.LMTokenStream`` (a numpy copy of ``repro``'s), so a seed gives
both packages the same tokens; each rank takes its own worker's row.
Only rank 0 prints and writes ``--ckpt``.
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
from repro_torch.core.distributed import (ShardCompressor,
                                          make_dist_multiround,
                                          make_dist_steps)
from repro_torch.core.engine import round_calls
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
    ap.add_argument("--runtime", default="round", choices=["round", "step"],
                    help="execution runtime: 'round' runs each sync round "
                         "(H local steps + sync) as one program, a CUDA "
                         "graph on the card; 'step' runs the steps "
                         "eagerly.  The same trajectories")
    ap.add_argument("--overlap", action="store_true",
                    help="windows of consecutive equal-length rounds as "
                         "one program each; requires --runtime round")
    ap.add_argument("--overlap-window", type=int, default=8,
                    help="most rounds a window (power-of-2 chunks)")
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
    if args.overlap and args.runtime != "round":
        raise SystemExit("--overlap requires --runtime round")
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
    """The run's pieces: config, initial state, the two steps (``--runtime
    step``) or the round program, the batch stream (this rank's rows),
    the shared generator and printer."""
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
    engine_args = (
        grad_fn, momentum_sgd(0.9),
        uplink if uplink is not None
        else ShardCompressor("none", dispatch=args.dispatch),
        warmup_piecewise(args.lr, 5, [int(args.steps * 0.8)]),
        mesh, data_axes(mesh), param_specs(cfg))
    engine_kw = dict(aggregate=args.aggregate, wire=args.wire)
    local_step = sync_step = round_fn = fused = None
    if args.runtime == "step":
        init_fn, local_step, sync_step = make_dist_steps(*engine_args,
                                                         **engine_kw)
    else:
        # one window of rounds a call; without --overlap a window is a
        # round, bit for bit a make_dist_round call
        init_fn, round_fn, fused = make_dist_multiround(*engine_args,
                                                        **engine_kw)
        if args.overlap:
            say(f"runtime: round overlap "
                f"({'fused' if fused else 'per-round fallback'}), "
                f"window {args.overlap_window}", flush=True)
        else:
            say(f"runtime: round "
                f"({'fused' if fused else 'per-step fallback'})", flush=True)
    R = worker_count(mesh)
    stream = LMTokenStream(vocab=cfg.vocab, R=R, order=64, seed=0)
    # the prefix embeddings of a multimodal config draw from their own
    # generator, so the two runtimes (which build a round's batches
    # before running it) draw the operators' randomness alike
    data_rng = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def host_batches():
        """This rank's batches, tokens on the host."""
        for batch in stream.batches(args.batch, args.seq, args.steps,
                                    seed=1):
            b = {"tokens": batch["tokens"][mesh.rank]}
            if cfg.modality:
                b["prefix_embeds"] = 0.02 * torch.randn(
                    (args.batch, cfg.n_frontend_tokens, cfg.d_model),
                    generator=data_rng, device=dev)
            yield b

    def batches():
        for b in host_batches():
            yield {**b, "tokens": torch.from_numpy(b["tokens"]).to(dev)}

    # every rank draws the stochastic leaves' randomness alike (repro's
    # key is replicated over the worker axes)
    rng = torch.Generator(device=dev).manual_seed(args.seed + 1)
    return types.SimpleNamespace(
        cfg=cfg, R=R, state=init_fn(params), local_step=local_step,
        sync_step=sync_step, round_fn=round_fn, fused=fused, batches=batches,
        host_batches=host_batches, rng=rng, say=say)


def _run(args, channel_spec, mesh) -> dict:
    dev = mesh.device
    run = setup(args, channel_spec, mesh)
    state, say, R = run.state, run.say, run.R
    run.state = None        # so the initial state goes once it is replaced
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {"loss": [], "kind": [], "ms": [], "bits_up": [], "bits_down": [],
           "launches_per_sync": [], "runtime": args.runtime,
           "fused": run.fused}

    def log_step(t, sync, loss, up, down, counts=None):
        rec["loss"].append(loss)
        rec["kind"].append("sync" if sync else "local")
        rec["bits_up"].append(up)
        rec["bits_down"].append(down)
        note = ""
        if counts is not None:
            rec["launches_per_sync"].append(counts)
            note = f" launches/round [{_note(counts)}]"
        say(f"step {t + 1:4d} [{'sync ' if sync else 'local'}] loss "
            f"{loss:.4f} bits up {up:.3g} down {down:.3g}{note}", flush=True)

    t0 = time.time()
    if args.runtime == "step":
        for t, b in enumerate(run.batches()):
            sync = is_sync(t, args)
            before = dict(LAUNCHES)
            ts = time.perf_counter()
            step = run.sync_step if sync else run.local_step
            state, loss = step(state, b, run.rng)
            loss, up = float(loss), float(state.bits)   # synchronizes
            rec["ms"].append((time.perf_counter() - ts) * 1e3)
            counts = ({k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                      if sync else None)
            log_step(t, sync, loss, up, float(state.bits_down), counts)
    else:
        state = _run_rounds(args, run, state, rec, log_step)
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


def _run_rounds(args, run, state, rec: dict, log_step):
    """The round runtime's loop over ``engine.round_calls``: the fixed
    schedule's rounds (every H-th step and the last one sync), one
    program a round, or a window of rounds under ``--overlap``; each step
    logged as ``--runtime step`` logs it, a mid-round step with the
    ledger of the round before.  ``ms`` is a round's time over its
    steps, ``round_ms`` the rounds' times."""
    sync = np.array([is_sync(t, args) for t in range(args.steps)])
    up, down = float(state.bits), float(state.bits_down)
    rec["round_ms"] = []
    for plans, block, _ in round_calls(
            run.host_batches(), sync,
            args.overlap_window if args.overlap else 1):
        W, L = len(plans), plans[0].length
        before = dict(LAUNCHES)
        ts = time.perf_counter()
        state, losses, leds = run.round_fn(state, block, run.rng)
        losses = losses.tolist()                           # synchronizes
        ms = (time.perf_counter() - ts) * 1e3
        leds = {k: leds[k].tolist() for k in ("bits", "bits_down")}
        counts = {k: (LAUNCHES[k] - before[k]) // W for k in LAUNCHES}
        for wi, plan in enumerate(plans):
            rec["round_ms"].append(ms / W)
            for i in range(L):
                tail = i == L - 1
                if tail:
                    up, down = leds["bits"][wi], leds["bits_down"][wi]
                rec["ms"].append(ms / (W * L))
                log_step(plan.start + i, tail, losses[wi][i], up, down,
                         counts if tail else None)
    rec["captures"] = run.round_fn.captures
    return state


if __name__ == "__main__":
    main()
