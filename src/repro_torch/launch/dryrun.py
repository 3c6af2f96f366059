"""The dry run (a port of ``repro.launch.dryrun``): every (architecture x
input shape x mesh) run once at full size on the ``meta`` device, with
the numbers behind the roofline report (``launch/roofline.py``).

``repro`` lowers and compiles each combination for a TPU mesh and reads
XLA's analyses.  Here the port's own steps run on ``meta`` tensors
(shapes and dtypes, no storage, no device): the distributed engine's
``sync_step`` and ``local_step`` for ``train`` shapes, the family's
``prefill`` or one ``decode_step`` for serving shapes.  "Lowers and
compiles" becomes "every shape composes at full size", and each step's
record holds, for one device (one worker's rank):

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total plus
  the operations of the hand-written kernels' launches
  (``roofline.kernel_cost``, through ``launch_stats.SINK``);
* ``bytes_accessed``: every aten op's input and output bytes (views and
  empty allocations move none) plus the kernels' bytes: eager traffic,
  with no fusion, where XLA's ``cost_analysis`` counts a fused program;
* ``memory``: ``argument_bytes`` (the step's inputs), ``output_bytes``,
  ``alias_bytes`` (outputs that share storage with an argument) and
  ``temp_bytes`` (the peak of storage the step allocates and holds,
  outputs included until it returns), each storage counted once and
  rounded to the CUDA caching allocator's 512-byte blocks; XLA's
  ``code_bytes`` has no counterpart and is left out;
* ``collectives``: the mesh's collectives (``DryMesh``'s events) in
  ``roofline_parse.collective_bytes``'s dict, and ``collectives_by_group``
  the same apart by group: the tensor-parallel ones under ``model``, the
  engine's wires and means under ``data``;
* ``launches``: the kernels launched, by name.

The mesh is rank 0 of its ranks with no process group
(``launch.mesh.DryMesh``): ``repro``'s device counts laid out
data-parallel, ``256x1`` (record name ``dp256``) and ``2x128x1`` under
``--multi-pod`` (``dp2x128``), and for the training shapes ``repro``'s
production meshes too, ``16x16`` (and ``2x16x16``): R = P * D workers of
M tensor-parallel ranks, rank 0 holding its model shard of every leaf;
``--mesh DxM|PxDxM`` names another.  A record carries the model axis's
``head_divisibility_note``.  Every family trains on a model axis;
serving with a model axis above 1 gives a record with ``status:
"error"``, ``pending: true`` and the ``PendingPort`` naming its ROADMAP
item.  A training worker takes ``global_batch / R``
sequences; a serving batch is split over the workers where it divides,
else every device serves it whole (``repro``'s rule).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--zero1]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 8x1 --smoke

Records: ``artifacts/dryrun/<arch>__<shape>__<mesh>.json``; then
``python -m repro_torch.launch.roofline`` writes the report.  Nothing
here touches a GPU: it runs on any machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import types
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import (ARCHS, INPUT_SHAPES, InputShape, get_config,
                                 get_policy_preset, shape_supported)
from repro_torch.core import policy as pol
from repro_torch.core.distributed import ShardCompressor, make_dist_steps
from repro_torch.kernels import launch_stats
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (DryMesh, Mesh, data_axes, dry_mesh,
                                     worker_count)
from repro_torch.launch.roofline_parse import (collective_bytes,
                                              collectives_by_group)
from repro_torch.models import get_model
from repro_torch.optim import constant, momentum_sgd
from repro_torch.sharding.specs import (PendingPort, activation_policy,
                                        head_divisibility_note, param_specs,
                                        shard_layout, shard_tree)
from repro_torch.tree import tree_leaves, tree_map, value_and_grad

ART_DIR = "artifacts/dryrun"
#: ``repro``'s meshes' device counts, data-parallel: (mesh, record name)
MESHES = {False: ("256x1", "dp256"), True: ("2x128x1", "dp2x128")}
#: ``repro``'s production meshes (``launch/mesh.py``: data x model), which
#: the training shapes run on too: (mesh, record name)
TP_MESHES = {False: ("16x16", "16x16"), True: ("2x16x16", "2x16x16")}
#: the CUDA caching allocator's block size: every storage is counted in
#: whole blocks
ALLOC_BYTES = 512
#: ops that move no bytes of their own (allocations, metadata)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.detach,
               torch.ops.aten.lift_fresh}


# ---------------------------------------------------------------------------
# measuring a step
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples (named ones too) and
    dataclasses, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _blocks(nbytes: int) -> int:
    return -(-int(nbytes) // ALLOC_BYTES) * ALLOC_BYTES


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """The storage, traffic and FLOPs by dtype of the ops a step runs, on
    any device.  Storage is tracked by identity: the arguments' storages
    are known from the start; each storage an op creates counts (in
    whole allocator blocks) from its creation to its death, and
    ``temp_bytes`` is the peak of those alive at once."""

    def __init__(self, args):
        super().__init__()
        self._known = WeakIdKeyDictionary()
        self.argument_bytes = 0
        for t in _tensors(args):
            st = t.untyped_storage()
            if st not in self._known:
                self._known[st] = "argument"
                self.argument_bytes += _blocks(st.nbytes())
        self.live = self.temp_bytes = 0
        self.bytes_accessed = 0.0
        self.flops_by_dtype: dict = {}

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            st = t.untyped_storage()
            if st not in self._known:
                nb = _blocks(st.nbytes())
                self._known[st] = "temp"
                self.live += nb
                weakref.finalize(st, self._free, nb)
        self.temp_bytes = max(self.temp_bytes, self.live)
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        if not (func.is_view or packet in _NO_TRAFFIC):
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        if packet in flop_registry and ins:
            dt = str(ins[0].dtype).replace("torch.", "")
            self.flops_by_dtype[dt] = (self.flops_by_dtype.get(dt, 0)
                                       + flop_registry[packet](
                                           *args, **kwargs, out_val=out))
        return out

    def storage_kind(self, t: torch.Tensor) -> Optional[str]:
        return self._known.get(t.untyped_storage())


def measure(fn, args: tuple, mesh=None) -> tuple:
    """Run ``fn(*args)`` once, measured: returns (its result, the step's
    record).  ``flops`` and ``bytes_accessed`` include the kernels'
    launches (``roofline.kernel_cost`` of each, through
    ``launch_stats.SINK``); ``collectives`` are ``mesh``'s events where
    it is a ``DryMesh`` (empty otherwise).  Runs eagerly on any device:
    on the card it measures the same step the dry run predicts."""
    kern = {"bytes": 0.0, "flops": 0.0}

    def sink(kernel: str, shape: dict) -> None:
        nbytes, ops, _ = roofline.kernel_cost(kernel, **shape)
        kern["bytes"] += nbytes
        kern["flops"] += ops

    dry = isinstance(mesh, DryMesh)
    if dry:
        mesh.events.clear()
    before = dict(LAUNCHES)
    meter = StepMeter(args)
    prev, launch_stats.SINK = launch_stats.SINK, sink
    t0 = time.perf_counter()
    try:
        with meter, FlopCounterMode(display=False) as fc:
            result = fn(*args)
    finally:
        launch_stats.SINK = prev
    outs, seen = [], set()
    for t in _tensors(result):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            outs.append(t)
    step = {
        "trace_s": round(time.perf_counter() - t0, 2),
        "memory": {
            "argument_bytes": meter.argument_bytes,
            "output_bytes": sum(_blocks(t.untyped_storage().nbytes())
                                for t in outs),
            "temp_bytes": meter.temp_bytes,
            "alias_bytes": sum(_blocks(t.untyped_storage().nbytes())
                               for t in outs
                               if meter.storage_kind(t) == "argument"),
        },
        "flops": float(fc.get_total_flops()) + kern["flops"],
        "kernel_flops": kern["flops"],
        "flops_by_dtype": {k: float(v) for k, v in
                           meter.flops_by_dtype.items()},
        "bytes_accessed": meter.bytes_accessed + kern["bytes"],
        "collectives": collective_bytes(mesh.events if dry else ()),
        "collectives_by_group": collectives_by_group(
            mesh.events if dry else ()),
        "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                     if LAUNCHES[k] != before[k]},
    }
    return result, step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def device_batch(global_batch: int, mesh) -> int:
    """A serving batch over the data axes where it divides, else whole
    on every device (``repro``'s batch spec)."""
    R = worker_count(mesh)
    return global_batch // R if global_batch % R == 0 else global_batch


def abstract_params(cfg, mesh, model, device="meta", gen=None):
    """(params, specs): the full-size parameter tree on ``device`` (on
    ``meta``: no storage; elsewhere drawn from ``gen``) and its spec
    tree, every leaf whole (``shard_tree`` cuts a rank's model shards
    out of it)."""
    if gen is None and torch.device(device).type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)
    return model.init_params(gen, cfg, device=device), param_specs(cfg)


def input_specs(cfg, shape, mesh, *, for_train: bool, device="meta",
                gen=None) -> dict:
    """The batch of one device: a training worker's [b, S + 1] tokens (b =
    global_batch / R), a serving device's [B, S] (``device_batch``),
    with the multimodal prefix embeddings where the config has them.  On
    ``meta`` only shapes; elsewhere random tokens from ``gen``."""
    sh = _shape(shape)
    R = worker_count(mesh)
    if for_train:
        lead, S = (max(1, sh.global_batch // R),), sh.seq_len + 1
    else:
        lead, S = (device_batch(sh.global_batch, mesh),), sh.seq_len
    meta = torch.device(device).type == "meta"
    if meta:
        batch = {"tokens": torch.empty(lead + (S,), dtype=torch.int32,
                                       device=device)}
    else:
        batch = {"tokens": torch.randint(
            0, cfg.vocab, lead + (S,), generator=gen, device=device,
            dtype=torch.int32)}
    if cfg.modality:
        pshape = lead + (cfg.n_frontend_tokens, cfg.d_model)
        batch["prefix_embeds"] = (
            torch.empty(pshape, dtype=cfg.adtype, device=device) if meta
            else 0.02 * torch.randn(pshape, generator=gen, device=device,
                                    dtype=torch.float32).to(cfg.adtype))
    return batch


def cache_shardings(cfg, mesh, batch_size: int, max_len: int):
    """One device's decode cache on ``meta`` for ``batch_size`` sequences
    of up to ``max_len`` tokens: the batch split over the data axes
    where it divides (``device_batch``)."""
    return get_model(cfg).init_cache(cfg, device_batch(batch_size, mesh),
                                     max_len, device="meta")


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def compressors(arch: str, policy: Optional[str], params,
                compressor_mode: str = "topk", k_frac: float = 0.01,
                dispatch: str = "auto") -> tuple:
    """(uplink, downlink) ``ShardCompressor``s: ``repro``'s dry run's
    ``ShardCompressor(compressor_mode, k_frac)`` and no downlink, or a
    policy as the launcher's ``--policy`` takes it (``preset:<name>``,
    ``preset:arch``, ``@file.json`` or the DSL)."""
    if policy is None:
        return ShardCompressor(compressor_mode, k_frac, dispatch), None
    spec = (get_policy_preset(policy[len("preset:"):], arch=arch)
            if policy.startswith("preset:") else pol.load(policy))
    spec = pol.as_channel_spec(spec)
    up = ShardCompressor.from_spec(spec.uplink, params, dispatch=dispatch)
    down = (ShardCompressor.from_spec(spec.downlink, params,
                                      dispatch=dispatch)
            if spec.downlink is not None else None)
    return up if up is not None else ShardCompressor("none",
                                                     dispatch=dispatch), down


def build_train(arch: str, cfg, mesh, shape, *, zero1: bool = False,
                compressor_mode: str = "topk", k_frac: float = 0.01,
                aggregate: str = "dense_psum", policy: Optional[str] = None,
                device="meta", seed: int = 0, dispatch: str = "auto"):
    """The training job the dry run measures, on ``device`` and ``mesh``
    (a ``DryMesh`` on meta, or a real one): ``make_dist_steps`` with
    ``momentum_sgd(0.9)``, the compressors (``dispatch``: their kernel
    routing), ``constant(1e-3)``, ``zero1`` and ``wire=aggregate``; the
    parameters (drawn from ``seed`` off meta) and one worker's batch.
    Returns a namespace (``init_fn``, ``steps`` by name, ``params``,
    ``batch``): a step is ``step(state, batch)``, its stochastic
    operators drawing from the job's generator (on meta they draw
    nothing).  Above one model rank ``params`` are the rank's model
    shards and the loss runs tensor-parallel (``activation_policy``)."""
    model = get_model(cfg)
    sharding = activation_policy(cfg, mesh)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    params, specs = abstract_params(cfg, mesh, model, device, gen)
    grad_fn = value_and_grad(
        lambda p, b: model.loss_fn(p, b, cfg, policy=sharding)[0])
    up, down = compressors(arch, policy, params, compressor_mode, k_frac,
                           dispatch)
    layout = shard_layout(specs, params, mesh)
    params = shard_tree(params, layout)
    init_fn, local_step, sync_step = make_dist_steps(
        grad_fn, momentum_sgd(0.9), up, constant(1e-3), mesh,
        data_axes(mesh), specs, zero1=zero1, wire=aggregate, downlink=down,
        layout=layout)
    batch = input_specs(cfg, shape, mesh, for_train=True, device=device,
                        gen=gen)
    rng = torch.Generator(device="cpu" if gen is None else device)
    rng.manual_seed(seed + 1)
    return types.SimpleNamespace(
        init_fn=init_fn, params=params, batch=batch,
        steps={"sync_step": lambda s, b: sync_step(s, b, rng),
               "local_step": lambda s, b: local_step(s, b, rng)})


def steady_state(state):
    """``init_fn``'s state as a round holds it after its first local step:
    the worker's iterate in storage of its own beside the master (at
    init the two are one tensor a leaf), so that a step's arguments
    count both, as they stand from then on."""
    return state._replace(local=tree_map(torch.clone, state.local))


def lower_train(cfg, mesh, shape, *, zero1: bool = False,
                compressor_mode: str = "topk", k_frac: float = 0.01,
                aggregate: str = "dense_psum",
                policy: Optional[str] = None, arch: Optional[str] = None
                ) -> dict:
    """Run the Qsparse ``sync_step`` (the step that communicates) and the
    ``local_step`` once each on ``meta``, both from ``steady_state``:
    their step records by name, on rank 0 of ``mesh`` (its model shards
    above one model rank).  ``repro``'s ``seq_shard`` (activation
    sharding over the model axis) has no counterpart: the residual
    stream is whole on every rank of a model group.  ``arch``: the
    ``ARCHS`` id a ``preset:arch`` policy resolves by."""
    job = build_train(arch or cfg.name, cfg, mesh, shape, zero1=zero1,
                      compressor_mode=compressor_mode, k_frac=k_frac,
                      aggregate=aggregate, policy=policy)
    state = steady_state(job.init_fn(job.params))
    del job.params
    out = {}
    for name in ("sync_step", "local_step"):
        result, out[name] = measure(job.steps[name], (state, job.batch),
                                    mesh)
        del result
    return out


def lower_serve(cfg, mesh, shape, max_len: Optional[int] = None) -> dict:
    """Run ``prefill`` (``prefill`` shapes) or one ``decode_step`` at
    position ``seq_len - 1`` against a full ``seq_len`` cache (``decode``
    shapes) once on ``meta``, under ``torch.no_grad``: the step record
    by name.  ``max_len``: the cache's length where a server sizes it
    past ``seq_len`` (a prefill's prompt and the tokens it will add).
    Serving with a ``model`` axis above 1 is not ported and raises
    (``activation_policy``, ROADMAP queue 1 item 12d)."""
    sh = _shape(shape)
    max_len = sh.seq_len if max_len is None else max_len
    if max_len < sh.seq_len:
        raise ValueError(f"max_len {max_len} < seq_len {sh.seq_len}")
    activation_policy(cfg, mesh, for_serving=True)
    model = get_model(cfg)
    params, _ = abstract_params(cfg, mesh, model)
    with torch.no_grad():
        if sh.kind == "prefill":
            batch = input_specs(cfg, sh, mesh, for_train=False)
            result, step = measure(
                lambda p, b: model.prefill(p, b, cfg, max_len=max_len),
                (params, batch), mesh)
            return {"prefill": step}
        cache = cache_shardings(cfg, mesh, sh.global_batch, max_len)
        token = torch.empty((device_batch(sh.global_batch, mesh),),
                            dtype=torch.int32, device="meta")
        result, step = measure(
            lambda p, c, t: model.decode_step(p, c, t, sh.seq_len - 1, cfg),
            (params, cache, token), mesh)
        return {"decode": step}


def profile_sync_collectives(arch: str, cfg, mesh, shape, wires, device,
                             seen: Optional[set] = None,
                             policy: Optional[str] = None) -> dict:
    """On a real mesh (this rank's part of it): one ``sync_step`` of
    ``build_train``'s job a wire, profiled (``record_shapes``), its
    collectives read from the trace (``roofline_parse.events_from_profile``)
    and counted by kind: what the dry run predicts for the same job on a
    ``DryMesh``.  ``seen`` collects the names of the trace's
    communication records (c10d ops and the backend's)."""
    from repro_torch.launch.roofline_parse import events_from_profile
    out = {}
    for wire in wires:
        job = build_train(arch, cfg, mesh, shape, aggregate=wire,
                          device=device, policy=policy)
        state = job.init_fn(job.params)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                record_shapes=True) as prof:
            job.steps["sync_step"](state, job.batch)
        out[wire] = collective_bytes(events_from_profile(prof))
        if seen is not None:
            seen.update(e.name for e in prof.events()
                        if e.name.startswith(("c10d::", "gloo:", "nccl:")))
    return out


# ---------------------------------------------------------------------------
# running the matrix
# ---------------------------------------------------------------------------


def _mesh(mesh, multi_pod: bool) -> tuple:
    """(DryMesh, record name) from None (``repro``'s device counts), a
    record name of :data:`MESHES` or :data:`TP_MESHES`, a ``"DxM"`` /
    ``"PxDxM"`` string or a mesh."""
    if mesh is None:
        text, name = MESHES[multi_pod]
        return dry_mesh(text), name
    named = {n: t for t, n in (*MESHES.values(), *TP_MESHES.values())}
    if isinstance(mesh, str) and mesh in named:
        return dry_mesh(named[mesh]), mesh
    if isinstance(mesh, str):
        return dry_mesh(mesh), mesh
    if isinstance(mesh, Mesh):
        return mesh, "x".join(str(d) for d in mesh.dims)
    raise TypeError(f"mesh must be None, 'DxM' or a Mesh, got {mesh!r}")


def param_fields(cfg) -> dict:
    """A record's parameter counts: ``params`` (``cfg.param_count()``,
    ``repro``'s analytic count), ``tree_params`` (the meta tree's summed
    ``numel``) and ``active_params``."""
    tree = get_model(cfg).init_params(None, cfg, device="meta")
    return {"params": cfg.param_count(),
            "tree_params": sum(t.numel() for t in tree_leaves(tree)),
            "active_params": cfg.active_param_count()}


def run_one(arch: str, shape_name: Optional[str] = None, *,
            shape: Optional[InputShape] = None, multi_pod: bool = False,
            zero1: bool = False, compressor: str = "topk",
            tag: str = "", smoke: bool = False,
            mesh=None, aggregate: str = "dense_psum", cfg_overrides=None,
            policy: Optional[str] = None,
            max_len: Optional[int] = None) -> dict:
    """One combination's record (``repro``'s schema, per device).
    ``shape_name`` names an ``INPUT_SHAPES`` entry; ``shape`` gives the
    sizes instead (its name is the record's where ``shape_name`` is
    None).  ``mesh``: None (``dp256``, or ``dp2x128`` under
    ``multi_pod``), ``"DxM"`` / ``"PxDxM"`` or a ``DryMesh``.
    ``policy``: a compression policy in place of ``compressor`` (as the
    launcher's ``--policy``).  ``max_len``: a serving shape's cache
    length, if not ``seq_len`` (``lower_serve``).  Every failure is
    recorded, never raised."""
    if shape is None:
        shape = INPUT_SHAPES[shape_name]
    shape_name = shape_name or shape.name
    ok, reason = ((shape_supported(arch, shape_name))
                  if shape_name in INPUT_SHAPES else (True, ""))
    dm, mesh_name = _mesh(mesh, multi_pod)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "zero1": zero1, "compressor": compressor,
        "aggregate": aggregate, "policy": policy, "tag": tag,
        "model_axis": dm.model_size, "status": "skipped", "reason": reason,
    }
    if not ok:
        return record
    kw = {}
    if arch == "zamba2-7b" and shape_name == "long_500k" and not smoke:
        kw["long_context"] = True
    cfg = get_config(arch, smoke=smoke, **kw)
    if smoke and arch == "zamba2-7b" and shape_name == "long_500k":
        cfg = dataclasses.replace(cfg, swa_pattern=(64,))
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    record["head_divisibility_note"] = head_divisibility_note(
        cfg, dm.model_size)
    t0 = time.perf_counter()
    try:
        if shape.kind == "train":
            steps = lower_train(cfg, dm, shape, zero1=zero1,
                                compressor_mode=compressor,
                                aggregate=aggregate,
                                policy=policy, arch=arch)
        else:
            steps = lower_serve(cfg, dm, shape, max_len=max_len)
        by_dtype: dict = {}
        for st in steps.values():
            for k, v in st["flops_by_dtype"].items():
                by_dtype[k] = by_dtype.get(k, 0.0) + v
        peak = max(st["memory"]["argument_bytes"] + st["memory"]["temp_bytes"]
                   for st in steps.values())
        record.update(
            status="ok", lower_s=round(time.perf_counter() - t0, 1),
            steps=steps, **param_fields(cfg),
            n_devices=math.prod(dm.dims), n_workers=worker_count(dm),
            seq_len=shape.seq_len, global_batch=shape.global_batch,
            device_batch=(max(1, shape.global_batch // worker_count(dm))
                          if shape.kind == "train"
                          else device_batch(shape.global_batch, dm)),
            kind=shape.kind,
            dtype=(max(by_dtype, key=by_dtype.get) if by_dtype
                   else cfg.param_dtype),
            peak_bytes=peak, fits=peak <= roofline.DEVICE_BYTES)
        if shape.kind != "train":
            record["max_len"] = max_len or shape.seq_len
    except Exception as e:  # noqa: BLE001 - report every failure mode
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["pending"] = isinstance(e, PendingPort)
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def pending(record: dict) -> bool:
    """Is an error record a refusal that names the ROADMAP item still to
    port it (serving on a model axis)?"""
    return record.get("status") == "error" and record.get("pending", False)


def save_record(record: dict, tag: str = "") -> str:
    os.makedirs(ART_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = (f"{ART_DIR}/{record['arch']}__{record['shape']}"
          f"__{record['mesh']}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(record, f, indent=2)
    return fn


def main(argv: Optional[list] = None,
         shapes: Optional[dict] = None) -> list:
    """Run the combinations the flags name and save their records;
    returns them.  ``shapes`` (no flag: callers from Python) gives the
    sizes of the shapes by name in place of ``INPUT_SHAPES``' (a reduced
    matrix, as ``repro``'s tests run its own)."""
    shapes = shapes or INPUT_SHAPES
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x128x1 (dp2x128) in place of 256x1 (dp256)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM in place of the default meshes "
                         "(dp256, and 16x16 for the training shapes)")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--compressor", default="topk",
                    choices=["topk", "signtopk", "none"])
    ap.add_argument("--aggregate", default="dense_psum",
                    choices=["dense_psum", "sparse_allgather"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs through the same path")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    names = (sorted(INPUT_SHAPES) if (args.all or not args.shape)
             else [args.shape])
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    records, failures = [], 0
    for a in archs:
        for s in names:
            if args.mesh is not None:
                meshes = [(args.mesh, False)]
            else:
                meshes = [(None, mp) for mp in pods]
                if shapes[s].kind == "train":
                    meshes += [(TP_MESHES[mp][1], mp) for mp in pods]
            for mesh, mp in meshes:
                rec = run_one(a, s, shape=shapes[s], multi_pod=mp,
                              zero1=args.zero1,
                              compressor=args.compressor,
                              tag=args.tag,
                              smoke=args.smoke, mesh=mesh,
                              aggregate=args.aggregate)
                save_record(rec, tag=args.tag)
                records.append(rec)
                status, extra = rec["status"], ""
                if status == "ok":
                    st = next(iter(rec["steps"].values()))
                    extra = (f"flops={st['flops']:.3g} "
                             f"arg={st['memory']['argument_bytes'] / 2**30:.2f}"
                             f"GiB temp="
                             f"{st['memory']['temp_bytes'] / 2**30:.2f}GiB "
                             f"coll={st['collectives']['total'] / 2**20:.1f}"
                             f"MiB fits={rec['fits']}")
                elif status == "error":
                    failures += not pending(rec)
                    extra = rec["error"][:160]
                print(f"[{status:7s}] {a} x {s} x {rec['mesh']}  {extra}",
                      flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run failures")
    return records


if __name__ == "__main__":
    main()
