"""CUDA graphs for the port's host-bound steps: the counterpart of
``repro``'s ``jax.jit`` of a step whose state it updates in place
(``repro.core.engine.donated_jit`` / ``_donated``, and the serving
engine's ``_step_jit`` / ``_admit_jit``).

``repro`` traces a step once and runs the compiled program after; the
port runs PyTorch eagerly, one operation and one kernel launch at a
time, so a serving step of a few thousand launches costs its host
several times the device's work.  :class:`CudaGraph` records such a step
once as a ``torch.cuda.CUDAGraph`` and replays it with one launch:

- the body is a function of no arguments that reads and writes only
  tensors that outlive it (static inputs, outputs written in place);
  its caller refreshes the inputs in place before a call and reads the
  outputs after it;
- the first call runs the body eagerly on the graph's own stream (the
  warm-up: cuBLAS handles, kernel attributes, the kernel library, the
  kernels' ticket buffers are all made here, before any capture); the
  second captures it and replays the capture; every later call replays.
  An owner that has already run the same work eagerly on a stream of
  its own passes that stream (``stream``, ``warmed=True``): the first
  call then captures;
  The body runs exactly once a call, so a body that advances state
  (positions, a KV cache) gives what the eager calls give;
- the graphs of one owner can share one memory pool (``pool``);
- a body that draws random numbers from a ``torch.Generator`` names it
  (``generators``): the graph registers its state, so each replay
  advances the generator as the eager body does and draws what the eager
  body would draw next;
- the host counters (``kernels.launch_stats.LAUNCHES``,
  ``serve.compressed.STATS``) count a wrapper call where it launches.  A
  capture launches nothing, so what the capture added is taken back off
  and added again at each replay (:func:`record`, :func:`add_counts`):
  a graphed run counts what the eager run counts;
- the garbage collector is run before a capture and held off during it:
  a dead reference cycle freed mid-capture (an old graph, its pool) would
  make CUDA calls that invalidate the capture;
- a failed capture raises; nothing falls back to the eager body.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels.launch_stats import LAUNCHES

Counters = Sequence[dict]


def record(fn: Callable[[], None], counters: Counters) -> list:
    """Run ``fn`` and return what it added to each of ``counters`` (one
    dict of increments each), taking the increments back off: the
    counters end as they began, also when ``fn`` raises."""
    before = [dict(c) for c in counters]
    try:
        fn()
        return [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
                for c, b in zip(counters, before)]
    finally:
        for c, b in zip(counters, before):
            c.update(b)


def add_counts(increments: list, counters: Counters) -> None:
    """Add ``record``'s increments to the counters: one replay's count."""
    for c, inc in zip(counters, increments):
        for k, v in inc.items():
            c[k] += v


class CudaGraph:
    """One zero-argument ``body`` run through a CUDA graph.

    ``static``: the tensors the body reads and writes (at least one), all
    on one CUDA device; anything else raises ``ValueError``.  ``pool``: a
    ``torch.cuda.graph_pool_handle()`` shared with the owner's other
    graphs (a new one by default).  ``counters``: the host counters whose
    increments a replay repeats.  ``captures`` counts captures (1 after
    the second call, whatever the calls after), ``calls`` the calls.
    ``generators``: the CUDA generators the body draws from.
    ``stream``: the stream to warm up and capture on (a new one by
    default); ``warmed``: the body's work has already run eagerly on
    ``stream``, so the first call captures.
    """

    def __init__(self, body: Callable[[], None],
                 static: Sequence[torch.Tensor], *, pool=None,
                 counters: Counters = (LAUNCHES,),
                 generators: Sequence[torch.Generator] = (),
                 stream: Optional[torch.cuda.Stream] = None,
                 warmed: bool = False):
        static = tuple(static)
        if not static:
            raise ValueError("CudaGraph needs the body's static tensors")
        for t in static:
            if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
                raise ValueError(
                    "a CUDA graph captures work on a CUDA device; got "
                    f"{type(t).__name__} on "
                    f"{getattr(t, 'device', 'no device')}")
        devs = {t.device for t in static}
        if len(devs) != 1:
            raise ValueError(f"static tensors on several devices: {devs}")
        self.device = devs.pop()
        self.body = body
        self.static = static
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.counters = tuple(counters)
        self.generators = tuple(generators)
        for g in self.generators:
            if g.device.type != "cuda" or g.device.index not in (
                    None, self.device.index):
                raise ValueError(f"generator on {g.device}, graph on "
                                 f"{self.device}")
        if warmed and stream is None:
            raise ValueError("warmed=True names the stream it was warmed on")
        self.calls = 0
        self.captures = 0
        self._stream: Optional[torch.cuda.Stream] = stream
        self._warm = warmed
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._increments: list = []

    def __call__(self) -> None:
        if self._graph is not None:
            self._replay()
        elif not self._warm:
            self._warm_up()
        else:
            self._capture()
            self._replay()
        self.calls += 1

    def _warm_up(self) -> None:
        """The first call: the body, eagerly, on the stream the capture
        will use (the kernels key their ticket buffers by stream)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._warm = True
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            self.body()
        cur.wait_stream(self._stream)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)

        def capture():
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=self._stream):
                self.body()

        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            self._increments = record(capture, self.counters)
        finally:
            if enabled:
                gc.enable()
        self._graph = graph
        self.captures += 1

    def _replay(self) -> None:
        self._graph.replay()
        add_counts(self._increments, self.counters)
