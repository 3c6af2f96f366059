"""Distributed LM training launcher (a port of ``repro.launch.train``).

Drives the distributed Qsparse-local-SGD engine (``core/distributed.py``)
for an architecture of any family (``models.get_model``: dense, MoE,
RWKV-6, Zamba2), one process per worker:

  # one GPU, one worker
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --mesh 1x1 --policy preset:arch --wire sparse_allgather
  # eight GPUs of one host, eight workers (NCCL)
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch gemma3-1b --mesh 8x1 --policy preset:arch
  # eight GPUs, four workers of two tensor-parallel ranks each
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch gemma3-1b --mesh 4x2 --policy preset:arch
  # RWKV-6 or Zamba2 the same way (either wire, --zero1, --resume)
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch rwkv6-3b --mesh 4x2 --policy preset:arch --zero1
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
``--scenario`` runs a fleet scenario's participation mask on the mesh
(``partial=True``); ``--faults`` (``--fault-seed``,
``--staleness-weight``) the mesh fault runtime
(``make_dist_fault_round`` / ``make_dist_fault_steps``, rounds closing
at every event step); ``--zero1`` shards the master (ZeRO-1) and a
``'up >> down'`` policy compresses the downlink.  Added: ``--device``
(default cuda), ``--seed`` (weights and the stochastic operators'
draws), ``--backend`` (``gloo`` for several ranks sharing one GPU) and
``--json`` (the run's record, exact ledgers included).  ``--tune``
times the launch geometries of the kernels the run's compressors launch
(``kernels/autotune.py``; ``topk_compact`` on the sparse wire) before
any step is built or captured and keeps the winners in the card's table
(``--retune`` re-measures signatures already there): rank 0 tunes and
saves, then every rank reloads the table.  Batches come from
``data.LMTokenStream`` (a numpy copy of ``repro``'s), so a seed gives
both packages the same tokens; each rank takes its own worker's row.
Only rank 0 prints and writes ``--ckpt`` (every rank joins the master's
gather first under ``--zero1`` or a model axis above 1).

A mesh ``DxM`` / ``PxDxM`` takes ``P * D * M`` ranks: R = P * D workers of
M tensor-parallel ranks each (every family: the MoE experts split over
the group, RWKV-6 and Zamba2 as ``repro``'s specs place them).  The parameters are drawn
whole from ``--seed`` (or restored whole from ``--resume``) and each
rank keeps its model shard, so a run equals its ``Dx1`` twin within
rounding, with the same ledgers; a worker's batch rows (its data
coordinate's) are shared by its model group.  ``--ckpt`` writes the
whole master in the format a ``Dx1`` run writes.  Above one model rank
the rounds are the per-step composition (``fused`` False) and the
fault runtime is refused (ROADMAP queue 1 item 12e).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_policy_preset
from repro_torch.core import policy as pol, scenarios as scn
from repro_torch.core.distributed import (ModelShards, ShardCompressor,
                                          gather_master,
                                          make_dist_fault_round,
                                          make_dist_fault_steps,
                                          make_dist_multiround,
                                          make_dist_steps,
                                          refuse_faults_model_axis)
from repro_torch.core.engine import (fault_rows, index_rows, round_calls,
                                     stack_block)
from repro_torch.core.rounds import compile_fault_rounds
from repro_torch.data import LMTokenStream
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.launch.mesh import (data_axes, make_mesh, parse_mesh,
                                     worker_count)
from repro_torch.models import get_model
from repro_torch.optim import momentum_sgd, warmup_piecewise
from repro_torch.sharding.specs import (activation_policy, param_specs,
                                        shard_layout, shard_tree)
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves, value_and_grad

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
                    help="DxM or PxDxM mesh: P*D workers of M "
                         "tensor-parallel ranks each, P*D*M ranks")
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
    ap.add_argument("--scenario", default=None,
                    help="fleet scenario (core/scenarios.py): k=v,... or "
                         "preset:<name>; partial participation on the mesh")
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
    ap.add_argument("--tune", action="store_true",
                    help="time the compression kernels' launch geometries "
                         "before training and keep the winners in the "
                         "card's table (artifacts/tuning/<card>.json); "
                         "signatures already tuned are reused")
    ap.add_argument("--retune", action="store_true",
                    help="with --tune: re-measure signatures already in "
                         "the table")
    ap.add_argument("--faults", default=None,
                    help="fault spec (DESIGN.md §9): k=v,... or "
                         "preset:<name>; staleness, drops and crashes "
                         "executed on the mesh")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="override the fault spec's seed")
    ap.add_argument("--staleness-weight", default="uniform",
                    choices=["uniform", "damped"],
                    help="weighting of late payloads: uniform, or damped "
                         "1/(1+tau)")
    ap.add_argument("--downlink", default=None,
                    help="DEPRECATED: use --policy")
    ap.add_argument("--downlink-k-frac", type=float, default=None,
                    help="DEPRECATED: use --policy")
    ap.add_argument("--zero1", action="store_true",
                    help="shard the master over the workers (ZeRO-1)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None,
                    help="start from a checkpoint's master (a --ckpt "
                         "directory written at any mesh) in place of "
                         "--seed's weights")
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


def is_sync(t: int, args, scenario_mask=None) -> bool:
    """The fixed schedule: every H-th step and the last one sync; under
    a scenario, the steps where any worker's mask row fires."""
    if scenario_mask is not None:
        return bool(scenario_mask[t].any())
    return (t + 1) % args.H == 0 or t == args.steps - 1


def _note(counts: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in counts.items() if v) or "none"


def main(argv: Optional[list] = None,
         n_layers: Optional[int] = None) -> dict:
    """Run the launcher; returns the run's record (losses, step kinds
    and times, ledgers, launches per sync, peak device memory).
    ``n_layers`` cuts the arch config's depth (no flag: callers from
    Python, such as a card check sized to the card's memory)."""
    args = parser().parse_args(argv)
    if args.retune and not args.tune:
        raise SystemExit("--retune re-measures what --tune measures; pass "
                         "--tune too")
    channel_spec = resolve_policy_arg(args)
    if args.faults is not None:
        dims, names = parse_mesh(args.mesh)
        refuse_faults_model_axis(dict(zip(names, dims)).get("model", 1))
        # repro's refusals, in its words
        if args.zero1:
            raise SystemExit("--faults does not support --zero1 (the "
                             "recover phase needs the full master)")
        if channel_spec.downlink is not None:
            raise SystemExit("--faults does not support a compressed "
                             "downlink on the mesh engine; drop the "
                             "'>> down' half of the policy")
    if args.overlap:
        if args.runtime != "round":
            raise SystemExit("--overlap requires --runtime round")
        if args.faults is not None:
            raise SystemExit(
                "--overlap is unsupported with --faults: arrival "
                "events segment rounds dynamically")
    mesh = make_mesh(args.mesh, device=args.device, backend=args.backend)
    try:
        return _run(args, channel_spec, mesh, n_layers)
    finally:
        mesh.close()


def tune_run(args, mesh, params, compressors, specs, say,
             shards=None) -> None:
    """``--tune``: rank 0 times the launch signatures the compressors make
    (``ShardCompressor.launch_plans`` on its model shards, the wire's
    kernel) and saves the card's table; after a barrier every rank drops
    what it held and reads the table anew.  Every rank of a model group
    launches at its shard's shapes, which rank 0's are."""
    from repro_torch.kernels import autotune
    keys = []
    for comp in compressors:
        if comp is not None:
            for key in comp.launch_plans(
                    params, specs, compact=args.wire == "sparse_allgather",
                    shards=shards):
                if key not in keys:
                    keys.append(key)
    if mesh.rank == 0:
        fresh = autotune.tune(keys, retune=args.retune, device=mesh.device)
        say(f"tune: {len(fresh)} measured, {autotune.tune.last_cached} "
            f"cached -> {autotune.table_path(device=mesh.device)}",
            flush=True)
    mesh.barrier()
    autotune.clear_cache()


def setup(args, channel_spec, mesh,
          n_layers: Optional[int] = None) -> types.SimpleNamespace:
    """The run's pieces: config (its depth cut to ``n_layers`` if
    given), initial state, the two steps (``--runtime step``) or the
    round program, the batch stream (this rank's rows), the shared
    generator and printer."""
    dev = mesh.device
    cfg = get_config(args.arch, smoke=args.smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = get_model(cfg)
    policy = activation_policy(cfg, mesh)
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, cfg, policy=policy)[0])
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    if args.resume:
        params = checkpoint.restore(args.resume, params, device=dev)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say("policy:", channel_spec.to_string(), flush=True)
    # the operators resolve per leaf against the whole parameters (a
    # rule may read a leaf's size), as repro resolves on global leaves
    uplink = ShardCompressor.from_spec(channel_spec.uplink, params,
                                       dispatch=args.dispatch)
    downlink = None
    if channel_spec.downlink is not None:
        downlink = ShardCompressor.from_spec(channel_spec.downlink, params,
                                             dispatch=args.dispatch)
    specs = param_specs(cfg)
    layout = shard_layout(specs, params, mesh)
    params = shard_tree(params, layout)     # the whole leaves go here
    shards = ModelShards(layout, mesh) if mesh.model_size > 1 else None
    if mesh.model_size > 1:
        say(f"tensor parallel: {mesh.workers} workers x "
            f"{mesh.model_size} model ranks, the rounds per-step",
            flush=True)
    if args.tune:
        tune_run(args, mesh, params, (uplink, downlink), specs, say, shards)
    engine_args = (
        grad_fn, momentum_sgd(0.9),
        uplink if uplink is not None
        else ShardCompressor("none", dispatch=args.dispatch),
        warmup_piecewise(args.lr, 5, [int(args.steps * 0.8)]),
        mesh, data_axes(mesh), specs)
    R = worker_count(mesh)
    scenario_mask = None
    if args.scenario is not None:
        scenario = scn.parse(args.scenario)
        scenario_mask = scenario.mask(args.steps, R, H=args.H)
        scn.warn_if_biased(scenario_mask, args.aggregate)
        say(f"scenario: {scenario.to_string() or 'lossless'} "
            f"(participation {scn.participation_of(scenario_mask):.2f}, "
            f"{int(scenario_mask.any(axis=1).sum())} sync steps)",
            flush=True)
    faults = None
    if args.faults is not None:
        spec = scn.parse_faults(args.faults)
        if args.fault_seed is not None:
            spec = dataclasses.replace(spec, seed=int(args.fault_seed))
        base_mask = (scenario_mask if scenario_mask is not None
                     else np.array([is_sync(t, args)
                                    for t in range(args.steps)]))
        tables = spec.tables(args.steps, R)
        rows = fault_rows(base_mask, tables, R)
        _, arrivals, events = scn.fault_replay(rows.sync, tables)
        faults = types.SimpleNamespace(spec=spec, tables=tables, rows=rows,
                                       events=events)
        say(f"faults: {spec.to_string() or 'none'} "
            f"(queue depth {spec.depth}, "
            f"{int(arrivals.sum())} arrivals, "
            f"{int((~tables.alive).sum())} crashed worker-steps, "
            f"weighting {args.staleness_weight})", flush=True)
    engine_kw = dict(zero1=args.zero1, aggregate=args.aggregate,
                     downlink=downlink, wire=args.wire,
                     partial=scenario_mask is not None, layout=layout)
    local_step = sync_step = round_fn = fused = None
    if faults is not None:
        fault_kw = dict(queue_depth=faults.spec.depth,
                        aggregate=args.aggregate, wire=args.wire,
                        staleness_weight=args.staleness_weight)
        if args.runtime == "round":
            init_fn, round_fn, fused = make_dist_fault_round(*engine_args,
                                                             **fault_kw)
            say(f"runtime: fault round "
                f"({'fused' if fused else 'per-step fallback'})", flush=True)
        else:
            init_fn, local_step, sync_step = make_dist_fault_steps(
                *engine_args, **fault_kw)
    elif args.runtime == "step":
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
    stream = LMTokenStream(vocab=cfg.vocab, R=R, order=64, seed=0)
    # the prefix embeddings of a multimodal config draw from their own
    # generator, so the two runtimes (which build a round's batches
    # before running it) draw the operators' randomness alike
    data_rng = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def host_batches():
        """This rank's batches, tokens on the host: its worker's row,
        shared by the worker's model group."""
        for batch in stream.batches(args.batch, args.seq, args.steps,
                                    seed=1):
            b = {"tokens": batch["tokens"][mesh.worker]}
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
        cfg=cfg, R=R, layout=layout, scenario_mask=scenario_mask,
        faults=faults,
        state=init_fn(params), local_step=local_step,
        sync_step=sync_step, round_fn=round_fn, fused=fused, batches=batches,
        host_batches=host_batches, rng=rng, say=say)


def _run(args, channel_spec, mesh, n_layers=None) -> dict:
    dev = mesh.device
    run = setup(args, channel_spec, mesh, n_layers)
    state, say, R = run.state, run.say, run.R
    run.state = None        # so the initial state goes once it is replaced
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {"loss": [], "kind": [], "ms": [], "bits_up": [], "bits_down": [],
           "launches_per_sync": [], "computes": [], "runtime": args.runtime,
           "fused": run.fused}
    faults = run.faults

    def computes(t) -> bool:
        """Does any worker compress a payload at sync step t (under
        faults an event step may only land payloads)?"""
        if faults is None:
            return True
        return bool((faults.rows.sync[t] & faults.rows.alive[t]).any())

    def log_step(t, sync, loss, up, down, counts=None):
        rec["loss"].append(loss)
        rec["kind"].append("sync" if sync else "local")
        rec["bits_up"].append(up)
        rec["bits_down"].append(down)
        note = ""
        if counts is not None:
            rec["launches_per_sync"].append(counts)
            rec["computes"].append(computes(t))
            note = f" launches/round [{_note(counts)}]"
        say(f"step {t + 1:4d} [{'sync ' if sync else 'local'}] loss "
            f"{loss:.4f} bits up {up:.3g} down {down:.3g}{note}", flush=True)

    t0 = time.time()
    if args.runtime == "step":
        for t, b in enumerate(run.batches()):
            faults = run.faults
            sync = (bool(faults.events[t]) if faults is not None
                    else is_sync(t, args, run.scenario_mask))
            before = dict(LAUNCHES)
            ts = time.perf_counter()
            if faults is not None:
                # event steps (a sync row or an arrival) are the syncs
                step = run.sync_step if sync else run.local_step
                state, loss = step(state, b, index_rows(faults.rows, t),
                                   run.rng)
            elif not sync:
                state, loss = run.local_step(state, b, run.rng)
            elif run.scenario_mask is None:
                state, loss = run.sync_step(state, b, run.rng)
            else:
                state, loss = run.sync_step(state, b, run.rng,
                                            mask=run.scenario_mask[t])
            loss, up = float(loss), float(state.bits)   # synchronizes
            rec["ms"].append((time.perf_counter() - ts) * 1e3)
            counts = ({k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                      if sync else None)
            log_step(t, sync, loss, up, float(state.bits_down), counts)
    elif run.faults is not None:
        state = _run_fault_rounds(args, run, state, rec, log_step)
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
    if args.ckpt:
        # the policy rides along so a resume reproduces the per-leaf
        # operators (and so the bits); a ZeRO-1 or tensor-parallel master
        # is gathered whole first, by every rank
        t_save = time.perf_counter()
        master = (gather_master(state, mesh, param_specs(run.cfg),
                                run.layout)
                  if args.zero1 or mesh.model_size > 1 else state.master)
        if mesh.rank == 0:
            checkpoint.save(args.ckpt, master, step=args.steps,
                            policy=channel_spec.to_dict())
            rec["ckpt_s"] = time.perf_counter() - t_save
            say("checkpoint saved to", args.ckpt, flush=True)
        del master
    rec.update(R=R, model_axis=mesh.model_size, rounds=state.rounds,
               wall_s=dt, n_params=run.layout.numel())
    if state.inflight is not None:
        # this rank's in-flight queue (the fault runtime), allocated once
        rec["queue_bytes"] = sum(x.numel() * x.element_size()
                                 for x in tree_leaves(state.inflight))
    if args.json and mesh.rank == 0:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _run_rounds(args, run, state, rec: dict, log_step):
    """The round runtime's loop over ``engine.round_calls``: the fixed
    schedule's rounds (every H-th step and the last one sync) or the
    scenario mask's (rounds close where any worker syncs; the tails'
    masks go to the program), one program a round, or a window of rounds
    under ``--overlap``; each step logged as ``--runtime step`` logs it,
    a mid-round step with the ledger of the round before.  ``ms`` is a
    round's time over its steps, ``round_ms`` the rounds' times."""
    partial = run.scenario_mask is not None
    sync = (run.scenario_mask if partial else
            np.array([is_sync(t, args) for t in range(args.steps)]))
    up, down = float(state.bits), float(state.bits_down)
    rec["round_ms"] = []
    for plans, block, tails in round_calls(
            run.host_batches(), sync,
            args.overlap_window if args.overlap else 1):
        W, L = len(plans), plans[0].length
        before = dict(LAUNCHES)
        ts = time.perf_counter()
        state, losses, leds = run.round_fn(
            state, block, run.rng, tails=tails if partial else None)
        losses = losses.tolist()                           # synchronizes
        ms = (time.perf_counter() - ts) * 1e3
        leds = {k: leds[k].tolist() for k in ("bits", "bits_down")}
        counts = {k: (LAUNCHES[k] - before[k]) // W for k in LAUNCHES}
        for wi, plan in enumerate(plans):
            rec["round_ms"].append(ms / W)
            for i in range(L):
                tail = i == L - 1 and bool(np.any(plan.mask))
                if i == L - 1:
                    up, down = leds["bits"][wi], leds["bits_down"][wi]
                rec["ms"].append(ms / (W * L))
                log_step(plan.start + i, tail, losses[wi][i], up, down,
                         counts if tail else None)
    rec["captures"] = run.round_fn.captures
    return state


def _run_fault_rounds(args, run, state, rec: dict, log_step):
    """The fault round runtime's loop (``repro``'s): rounds close at every
    event step (``rounds.compile_fault_rounds``), each a call of the
    fault round program with its [L, R] fault rows; a step logs as
    ``--runtime step`` logs it."""
    faults = run.faults
    up, down = float(state.bits), float(state.bits_down)
    rec["round_ms"] = []
    it = run.host_batches()
    for plan in compile_fault_rounds(faults.rows.sync, faults.tables):
        sl = slice(plan.start, plan.start + plan.length)
        block = stack_block([next(it) for _ in range(plan.length)])
        before = dict(LAUNCHES)
        ts = time.perf_counter()
        state, losses = run.round_fn(state, block,
                                     index_rows(faults.rows, sl), run.rng)
        losses = losses.tolist()                           # synchronizes
        ms = (time.perf_counter() - ts) * 1e3
        counts = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        rec["round_ms"].append(ms)
        for i in range(plan.length):
            t = plan.start + i
            tail = i == plan.length - 1
            sync = tail and bool(faults.events[t])
            if tail:
                up, down = float(state.bits), float(state.bits_down)
            rec["ms"].append(ms / plan.length)
            log_step(t, sync, losses[i], up, down, counts if sync else None)
    rec["captures"] = run.round_fn.captures
    rec["round_shapes"] = run.round_fn.shapes
    return state


if __name__ == "__main__":
    main()
