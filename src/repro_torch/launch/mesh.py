"""The process mesh of the distributed engine (a port of
``repro.launch.mesh``, on ``torch.distributed``).

``repro`` lays its workers over the ``pod`` / ``data`` axes of a device
mesh, runs each worker's step inside ``shard_map``, and leaves the
``model`` axis (tensor parallelism) to XLA.  Here one process (rank) is
one device of the mesh ``DxM`` / ``PxDxM``: the world is ``P * D * M``
ranks, rank ``((p * D) + d) * M + m`` at coordinates (pod p, data d,
model m), and a worker is the ``M`` ranks of one (pod, data) row.  Two
subgroups a rank:

  * the **model group**: the ``M`` ranks of its worker (the model's own
    collectives, ``sharding/collectives.py``);
  * the **data group**: the ``P * D`` ranks that hold the same model
    shard (the engine's wires and means).

Every collective names the group it runs over (``over="data"``, the
default, ``"model"`` or ``"world"``); a group of one is the identity.
With ``M == 1`` the data group is the world's group, as before.

The process group is set up from the usual ``torchrun`` variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); a process without them is world size
1 at ``tcp://localhost:<a free port>``.  Backends: NCCL when every rank
owns a GPU, gloo for CPU ranks, and gloo named explicitly for several
ranks sharing one GPU (NCCL takes one rank per GPU).  Under gloo a
collective on CUDA tensors is staged through host memory: a transport
detail, the computation stays on the card.  A failed setup raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
import subprocess
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


def parse_mesh(text: str) -> tuple:
    """``"DxM"`` / ``"PxDxM"`` (or one size) -> (dims, axis names), the
    names right-aligned on ``("pod", "data", "model")`` as ``repro``'s
    launcher names them."""
    try:
        dims = tuple(int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r} is not DxM or PxDxM") from None
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"mesh {text!r} is not DxM or PxDxM")
    return dims, AXES[-len(dims):]


GROUPS = ("data", "model", "world")


@dataclasses.dataclass
class Mesh:
    """The mesh as one rank sees it.  ``group`` is the world's process
    group, None for a world of one without one; ``groups`` holds the
    ``data`` and ``model`` subgroups (None where the group is this rank
    alone: its collectives are then the identity)."""

    dims: tuple
    axis_names: tuple
    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Optional[object] = None
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def model_size(self) -> int:
        """M: the ranks of one worker."""
        return self.shape.get("model", 1)

    @property
    def workers(self) -> int:
        """R = P * D: the workers (one model group each)."""
        return worker_count(self)

    @property
    def worker(self) -> int:
        """This rank's worker: its (pod, data) row in row-major order."""
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        """This rank's place in its model group."""
        return self.rank % self.model_size

    def coords(self) -> dict:
        """This rank's coordinate on each axis of the mesh."""
        out, r = {}, self.rank
        for name, size in reversed(tuple(zip(self.axis_names, self.dims))):
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    def size(self, over: str = "data") -> int:
        """The ranks of the group ``over`` names."""
        if over not in GROUPS:
            raise ValueError(f"unknown group {over!r}; expected one of "
                             f"{GROUPS}")
        return {"data": self.workers, "model": self.model_size,
                "world": self.world_size}[over]

    def _group(self, over: str):
        if over == "world" or (over == "data" and self.model_size == 1):
            return self.group if self.size(over) > 1 else None
        if self.size(over) == 1:
            return None
        return self.groups[over]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _all_reduce(self, t: torch.Tensor, over: str, op) -> torch.Tensor:
        group = self._group(over)
        if group is None:
            return t
        t = t.contiguous()
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, op=op, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=group)
        return t

    def all_reduce_sum(self, t: torch.Tensor,
                       over: str = "data") -> torch.Tensor:
        """The sum of ``t`` over the group ``over`` (in place when ``t``
        is contiguous; a strided view is reduced as a contiguous copy)."""
        return self._all_reduce(t, over, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor,
                       over: str = "model") -> torch.Tensor:
        """The elementwise maximum of ``t`` over the group ``over``, in
        place as :meth:`all_reduce_sum`."""
        return self._all_reduce(t, over, dist.ReduceOp.MAX)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The workers' mean of ``t`` (``pmean`` over the data axes: the
        sum over the data group over R), as a new tensor."""
        return self.all_reduce_sum(t.clone()) / self.workers

    def all_gather(self, t: torch.Tensor, over: str = "data") -> torch.Tensor:
        """[W, *t.shape]: every rank's ``t`` of the group ``over`` in
        rank order (fixed-shape buffers, as the sparse wire's (idx, val)
        slots are)."""
        group = self._group(over)
        if group is None:
            return t[None].clone()
        src = t.reshape(-1).contiguous()
        if self._staged(src):
            src = src.cpu()
        W = self.size(over)
        out = torch.empty((W * src.numel(),), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.reshape((W,) + tuple(t.shape)).to(t.device)

    def barrier(self) -> None:
        """Every rank waits here for every other (a one-float sum over
        the world, read back on the host)."""
        if self.group is not None:
            self.all_reduce_sum(torch.zeros(1, device=self.device),
                                over="world").item()

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group()
            self.group = None
            self.groups = {}


@dataclasses.dataclass
class DryMesh(Mesh):
    """Rank 0 of a mesh of ``world_size`` ranks with no process group,
    for a dry run (``launch/dryrun.py``) on the ``meta`` device: every
    collective returns what rank 0 would get, in shape, and appends
    ``(kind, dtype, shape, group)`` to ``events`` (``roofline_parse``'s
    events, the result's shape on one device, and the group it ran
    over: ``"data"``, ``"model"`` or ``"world"``).  A collective over a
    group of one is the identity and records nothing, as on a real
    mesh.  ``all_reduce_sum`` / ``all_reduce_max`` return their input
    unchanged, ``all_gather`` a new [W, ...] tensor (on meta: no
    storage), ``barrier`` is the one-float all-reduce it is on a real
    mesh."""

    events: list = dataclasses.field(default_factory=list)

    def _all_reduce(self, t, over, op):
        if self.size(over) > 1:
            self.events.append(("all-reduce", t.dtype, tuple(t.shape), over))
        return t

    def all_gather(self, t: torch.Tensor, over: str = "data") -> torch.Tensor:
        shape = (self.size(over),) + tuple(t.shape)
        if self.size(over) > 1:
            self.events.append(("all-gather", t.dtype, shape, over))
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    def barrier(self) -> None:
        if self.world_size > 1:
            self.events.append(("all-reduce", torch.float32, (1,), "world"))


def dry_mesh(text: str, device="meta") -> DryMesh:
    """The dry run's mesh for ``"DxM"`` / ``"PxDxM"``: rank 0 of its
    ``P * D * M`` ranks."""
    dims, names = parse_mesh(text)
    return DryMesh(dims, names, world_size=math.prod(dims),
                   device=torch.device(device))


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def worker_count(mesh: Mesh) -> int:
    out = 1
    for a in data_axes(mesh):
        out *= mesh.shape[a]
    return out


def mesh_ranks(text: str) -> int:
    """The ranks a ``"DxM"`` / ``"PxDxM"`` mesh takes: P * D * M."""
    return math.prod(parse_mesh(text)[0])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def make_mesh(text: str, device="cuda", backend: str = "auto",
              init: bool = True) -> Mesh:
    """The mesh of this process: parse ``text``, check it against the
    world size, pick this rank's device, and (``init``) join the process
    group.  ``backend``: "auto" (NCCL on CUDA, gloo on the CPU), "nccl"
    or "gloo"."""
    dims, names = parse_mesh(text)
    rank = _env_int("RANK", 0)
    world = _env_int("WORLD_SIZE", 1)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    mesh = Mesh(dims, names, rank=rank, world_size=world)
    if math.prod(dims) != world:
        raise ValueError(
            f"mesh {text!r} has {math.prod(dims)} devices but the world "
            f"size is {world}: one rank per device (P * D * M)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend == "auto":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs --device cuda")
        if local_world > torch.cuda.device_count():
            raise ValueError(
                f"{local_world} ranks on {torch.cuda.device_count()} GPUs: "
                "NCCL takes one rank per GPU; name the gloo backend to "
                "share a GPU")
    mesh.device, mesh.backend = dev, backend
    if init:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            method = "env://"
        elif world == 1:
            method = f"tcp://localhost:{free_port()}"
        else:
            raise RuntimeError(
                f"world size {world} without MASTER_ADDR / MASTER_PORT: "
                "start the ranks with torchrun")
        dist.init_process_group(backend, init_method=method, rank=rank,
                                world_size=world)
        mesh.group = dist.group.WORLD
        mesh.groups = _subgroups(mesh)
    return mesh


def _subgroups(mesh: Mesh) -> dict:
    """The rank's model and data groups (``mesh.groups``).  Every rank
    makes every group, in one order, as ``dist.new_group`` requires; with
    M == 1 the data group is the world's and nothing is made."""
    M, R = mesh.model_size, mesh.workers
    if M == 1:
        return {}
    out = {}
    for w in range(R):
        g = dist.new_group([w * M + m for m in range(M)])
        if w == mesh.worker:
            out["model"] = g
    if R > 1:
        for m in range(M):
            g = dist.new_group([w * M + m for w in range(R)])
            if m == mesh.model_rank:
                out["data"] = g
    return out


def run_local_ranks(cmd: list, world_size: int, env: Optional[dict] = None,
                    timeout: float = 600.0) -> list:
    """Start ``world_size`` copies of ``cmd`` on this host as the ranks of
    one process group (a mesh's P * D * M: ``mesh_ranks``) (``torchrun``'s variables, a free port) and wait
    for all of them.  Returns [(returncode, stdout, stderr)] in rank
    order.  Each rank writes to files of its own, so a rank that writes
    much never blocks on a full pipe while the others wait for it in a
    collective.  Every process is stopped before it returns; ranks still
    running after ``timeout`` seconds raise ``TimeoutError`` with the end
    of each rank's stderr."""
    port = free_port()
    procs, files = [], []
    try:
        for r in range(world_size):
            e = dict(os.environ if env is None else env)
            e.update(RANK=str(r), WORLD_SIZE=str(world_size),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world_size),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port))
            files.append((tempfile.TemporaryFile("w+"),
                          tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen(
                cmd, env=e, stdout=files[-1][0], stderr=files[-1][1],
                text=True))
        deadline = time.monotonic() + timeout
        late = []
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                late.append(r)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for (out, err), p in zip(files, procs):
        out.seek(0)
        err.seek(0)
        outs.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    if late:
        tails = "\n".join(f"rank {r} stderr: ...{e[-2000:]}"
                          for r, (_, _, e) in enumerate(outs))
        raise TimeoutError(f"ranks {late} of {cmd} still ran after "
                           f"{timeout} s\n{tails}")
    return outs
