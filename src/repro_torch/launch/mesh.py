"""The process mesh of the distributed engine (a port of
``repro.launch.mesh``, on ``torch.distributed``).

``repro`` lays its workers over the ``pod`` / ``data`` axes of a device
mesh and runs each worker's step inside ``shard_map``.  Here one process
(rank) is one worker: the mesh string ``DxM`` / ``PxDxM`` names the same
axes, and the data axes' product ``P * D`` must equal the world size (the
engine refuses a ``model`` axis above 1 until ROADMAP queue 1 item 12
ports tensor parallelism).

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


@dataclasses.dataclass
class Mesh:
    """The worker mesh as one rank sees it.  ``group`` is None for a
    world of one without a process group (the collectives are then the
    identity)."""

    dims: tuple
    axis_names: tuple
    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the workers (in place when ``t`` is
        contiguous; a strided view is reduced as a contiguous copy)."""
        if self.group is None:
            return t
        t = t.contiguous()
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The workers' mean of ``t`` (``pmean``: the sum over the world
        size), as a new tensor."""
        return self.all_reduce_sum(t.clone()) / self.world_size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[W, *t.shape]: every worker's ``t`` in rank order (fixed-shape
        buffers, as the sparse wire's (idx, val) slots are)."""
        if self.group is None:
            return t[None].clone()
        src = t.reshape(-1).contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty((self.world_size * src.numel(),),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.reshape((self.world_size,) + tuple(t.shape)).to(t.device)

    def barrier(self) -> None:
        """Every rank waits here for every other (a one-float sum, read
        back on the host)."""
        if self.group is not None:
            self.all_reduce_sum(torch.zeros(1, device=self.device)).item()

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group()
            self.group = None


@dataclasses.dataclass
class DryMesh(Mesh):
    """Rank 0 of a mesh of ``world_size`` workers with no process group,
    for a dry run (``launch/dryrun.py``) on the ``meta`` device: every
    collective returns what rank 0 would get, in shape, and appends its
    ``(kind, dtype, shape)`` to ``events`` (``roofline_parse``'s
    events, the result's shape on one device).  ``all_reduce_sum``
    returns its input unchanged, ``all_gather`` a new [W, ...] tensor
    (on meta: no storage), ``barrier`` is the one-float all-reduce it
    is on a real mesh."""

    events: list = dataclasses.field(default_factory=list)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        self.events.append(("all-reduce", t.dtype, tuple(t.shape)))
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        shape = (self.world_size,) + tuple(t.shape)
        self.events.append(("all-gather", t.dtype, shape))
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    def barrier(self) -> None:
        self.events.append(("all-reduce", torch.float32, (1,)))


def dry_mesh(text: str, device="meta") -> DryMesh:
    """The dry run's mesh for ``"DxM"`` / ``"PxDxM"``: rank 0 of the data
    axes' workers (a ``model`` axis above 1 is refused where the engine
    or the serving path checks the mesh)."""
    dims, names = parse_mesh(text)
    mesh = DryMesh(dims, names, device=torch.device(device))
    mesh.world_size = worker_count(mesh)
    return mesh


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def worker_count(mesh: Mesh) -> int:
    out = 1
    for a in data_axes(mesh):
        out *= mesh.shape[a]
    return out


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
    if worker_count(mesh) != world:
        raise ValueError(
            f"mesh {text!r} has {worker_count(mesh)} workers but the world "
            f"size is {world}: one rank per worker")
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
    return mesh


def run_local_ranks(cmd: list, world_size: int, env: Optional[dict] = None,
                    timeout: float = 600.0) -> list:
    """Start ``world_size`` copies of ``cmd`` on this host as the ranks of
    one process group (``torchrun``'s variables, a free port) and wait
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
