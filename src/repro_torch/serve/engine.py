"""Continuous-batching request runtime (a port of ``repro.serve.engine``;
DESIGN.md §11.3, §12).

The engine owns ``max_batch`` decode *slots*.  Each slot holds one
in-flight request's KV state; every engine iteration admits queued
requests into free slots (prefill-insert) and then advances **all**
slots by one token with one decode step over the slot batch.
Completion frees the slot for the next queued request immediately.
``scheduler='static'`` admits only when every slot is free.

Two KV layouts:

- **contiguous** (default): a ``max_len`` ring cache per slot, the slot
  axis as the cache's batch axis ([L, max_batch, C, KV, hd], one
  position map per slot; one cache per layer for mixed windows or an
  unscanned stack, whose prefill runs the flash-attention kernel).  ``repro`` decodes the slots one at a time
  (``vmap`` of a batch-1 step); the port decodes the slot batch at once,
  each row at its own position.
- **paged** (``paged=True``): one shared page pool (``models.layers.
  PagedKVCache``) plus per-request block tables.  Admission allocates
  ``ceil(true_len / page_size)`` pages from a host free list
  (``serve.paging``), decode grows a table page by page, a queue head
  the pool cannot hold stalls (``admission_stalls``), and when an active
  request needs a page the pool cannot supply, the newest-admitted
  other request is preempted (pages freed, the original request
  requeued at the front for recompute-from-start; ``preemptions``).

Admission right-pads the prompt to ``prompt_pad``.  Contiguous: the
prefilled cache has its pad positions invalidated and is written into
the slot.  Paged: the prefilled KV is scattered into the allocated pages
(pad garbage beyond ``true_len`` stays inside owned pages, masked by the
row's length until decode overwrites it).  Either way the first decode
step re-feeds the last prompt token at ``true_len - 1``, an idempotent
rewrite of that token's k / v, so sampling starts from logits
conditioned on the true prompt.

Host <-> device traffic per step is one download (the next tokens):
slot tokens, positions and liveness live on the device, the step
advances the positions there, and admission / finish *events* patch
single entries.  The block tables are uploaded only when they change.
Every call of the model goes through ``models.transformer``; a
compressed parameter tree (``serve.compressed``) drops in unchanged.

The decode step and the admission are each one body of no arguments
over static device buffers (``_decode_body``, ``_admit_body``): the
step reads ``_toks`` / ``_poss`` / ``_active`` (and, paged, the block
tables ``_tables``), writes the logits into ``logits``, the next tokens
into ``_toks`` and advances ``_poss`` in place; an admission reads its
prompt from ``_adm_toks`` and its destination from ``_adm_page_ids``
(paged) or ``_adm_slot`` / ``_adm_len`` (contiguous), which the host
refreshes in place before the call.  On a CUDA device each body runs as
a CUDA graph (``graphs.CudaGraph``, ``cuda_graphs``): one capture each
over a whole run, as ``repro`` compiles ``_step_jit`` / ``_admit_jit``
once.  On the CPU, and with ``cuda_graphs=False``, the same bodies run
eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.graphs import CudaGraph
from repro_torch.kernels.dispatch import DispatchConfig
from repro_torch.kernels.launch_stats import LAUNCHES, PAGE_POOL
from repro_torch.models import layers as mlayers
from repro_torch.models import transformer as tf
from repro_torch.models.layers import KVCache
from repro_torch.serve.compressed import STATS
from repro_torch.serve.paging import PagePool
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class Request:
    """One generation request: token prompt + decode budget."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    rid: int = -1
    submit_s: float = 0.0


@dataclasses.dataclass
class RequestMetrics:
    """Per-request serving metrics (all host wall-clock)."""

    rid: int
    prompt_len: int
    new_tokens: int
    queue_wait_s: float     # submit -> slot admission
    ttft_s: float           # submit -> first generated token
    decode_s: float         # first token -> completion
    tokens_per_s: float     # new_tokens / (admission -> completion)


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    tokens: Optional[List[int]] = None   # generated so far
    next_token: int = 0
    pos: int = 0                         # position of next_token
    remaining: int = 0
    admit_s: float = 0.0
    submit_s: float = 0.0
    ttft_s: float = -1.0
    # paged bookkeeping: owned physical pages (logical order), the
    # original request (for recompute-from-start preemption), and the
    # admission sequence number (preemption victims = newest first)
    pages: Optional[List[int]] = None
    prompt: Optional[List[int]] = None
    budget: int = 0
    admit_seq: int = -1

    @property
    def free(self) -> bool:
        return self.rid < 0


def _params_device(params) -> torch.device:
    leaf = tree_leaves(params)[0]
    return (leaf if isinstance(leaf, torch.Tensor) else leaf.a).device


def _upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy a host array into a static device buffer in place, without
    waiting on the device (a pinned staging copy, kept by PyTorch's host
    allocator until the copy has run)."""
    host = torch.from_numpy(src)
    if dst.is_cuda:
        host = host.pin_memory()
    dst.copy_(host, non_blocking=dst.is_cuda)


def _use_graphs(cuda_graphs, device: torch.device, dispatch) -> bool:
    """Resolve ``cuda_graphs``: "auto" is graphs on a CUDA device and the
    eager bodies on the CPU (``DispatchConfig``'s "auto" rule)."""
    if cuda_graphs not in ("auto", True, False):
        raise ValueError(f"cuda_graphs must be 'auto', True or False, got "
                         f"{cuda_graphs!r}")
    if cuda_graphs is False or (cuda_graphs == "auto"
                                and device.type != "cuda"):
        return False
    if device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs the parameters on a CUDA "
                         f"device; they are on {device}")
    if dispatch is not None and dispatch.mode == "reference":
        raise ValueError(
            "a graphed engine captures the CUDA kernels' path; "
            "DispatchConfig(mode='reference') runs the kernels' plain "
            "versions, the eager reference the graphs are held against: "
            "pass cuda_graphs=False")
    return True


class ServeEngine:
    """Continuous-batching serving runtime over a (possibly compressed)
    parameter tree, on the device the parameters live on.

    ``scheduler`` is 'continuous' (slot reuse on completion) or 'static'
    (admit only into an all-free batch).  Greedy decoding; ``eos_id``
    stops a request early.  ``paged=True`` switches the KV state to the
    shared page pool (``page_size`` tokens per page, ``kv_pool_pages``
    total — default ``max_batch * ceil(max_len / page_size)``, the
    contiguous layout's memory); ``kv_quant=True`` stores pages as int8
    levels + per-slot f32 scales.  ``dispatch`` (a
    ``kernels.dispatch.DispatchConfig``) routes the compressed matmuls
    and, under ``cfg.use_pallas``, decode attention.  ``cuda_graphs``:
    "auto" (CUDA graphs for the decode step and the admission where the
    parameters are on a CUDA device, the eager bodies on the CPU), True
    (graphs; raises on the CPU and under reference dispatch) or False
    (the eager bodies on any device).  ``captures`` counts each graph's
    captures; ``logits`` holds the last decode step's logits.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 max_len: int = 64, prompt_pad: int = 16,
                 scheduler: str = "continuous",
                 eos_id: Optional[int] = None,
                 paged: bool = False, page_size: int = 16,
                 kv_quant: bool = False,
                 kv_pool_pages: Optional[int] = None,
                 dispatch: Optional[DispatchConfig] = None,
                 cuda_graphs="auto"):
        if scheduler not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if prompt_pad >= max_len:
            raise ValueError("prompt_pad must leave room to decode "
                             f"(prompt_pad={prompt_pad}, max_len={max_len})")
        if kv_quant and not paged:
            raise ValueError("kv_quant requires paged=True (the contiguous "
                             "layout has no quantized variant)")
        self.params = params
        self.cfg = cfg
        self.dispatch = dispatch
        self.device = _params_device(params)
        self.cuda_graphs = _use_graphs(cuda_graphs, self.device, dispatch)
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.prompt_pad = int(prompt_pad)
        self.scheduler = scheduler
        self.eos_id = eos_id
        self.paged = bool(paged)
        self.kv_quant = bool(kv_quant)
        self._queue: deque = deque()
        self._slots = [_Slot() for _ in range(self.max_batch)]
        self._next_rid = 0
        self._admit_seq = 0
        self._outputs: dict = {}
        self._metrics: dict = {}
        #: per-iteration active-slot counts (scheduler-invariant tests)
        self.occupancy: List[int] = []
        self.steps = 0
        #: prefills run (admissions, re-admissions after preemption too)
        self.admissions = 0
        #: paged-runtime counters (mirrored into launch_stats.PAGE_POOL)
        self.preemptions = 0
        self.admission_stalls = 0
        self._peak_pages = 0

        dev = self.device
        self._toks = torch.zeros(self.max_batch, dtype=torch.int32,
                                 device=dev)
        self._poss = torch.zeros(self.max_batch, dtype=torch.int32,
                                 device=dev)
        self._active = torch.zeros(self.max_batch, dtype=torch.bool,
                                   device=dev)
        self.logits = torch.zeros(self.max_batch, cfg.vocab,
                                  dtype=torch.float32, device=dev)
        self._adm_toks = torch.zeros(1, self.prompt_pad, dtype=torch.int64,
                                     device=dev)
        static = [self._toks, self._poss, self._active, self.logits,
                  self._adm_toks]

        if self.paged:
            wins = cfg.layer_windows()
            if not (tf.uniform_windows(cfg) and cfg.scan_layers
                    and wins[0] <= 0):
                raise ValueError(
                    "paged KV serving requires uniform full-attention "
                    f"windows and scanned layers (windows={wins}, "
                    f"scan_layers={cfg.scan_layers})")
            if page_size <= 0:
                raise ValueError(f"page_size must be positive: {page_size}")
            self.page_size = int(page_size)
            self.max_pages_per_req = -(-self.max_len // self.page_size)
            default_pages = self.max_batch * self.max_pages_per_req
            self.n_pages = int(kv_pool_pages or default_pages)
            if self.n_pages < self.max_pages_per_req:
                raise ValueError(
                    f"kv_pool_pages={self.n_pages} cannot hold one "
                    f"max_len={self.max_len} request "
                    f"({self.max_pages_per_req} pages of {self.page_size})")
            self.pool_alloc = PagePool(self.n_pages, self.page_size)
            self._adm_pages = -(-self.prompt_pad // self.page_size)
            self._pool = mlayers.init_paged_pool(
                cfg, self.n_pages, self.page_size, stacked=cfg.n_layers,
                quant=self.kv_quant, device=dev)
            self._tables_np = np.full(
                (self.max_batch, self.max_pages_per_req), -1, np.int32)
            self._tables = torch.from_numpy(self._tables_np.copy()).to(dev)
            self._tables_dirty = False
            # the admission's page destinations, the n_pages sentinel
            # (the pool's write sink) for unallocated tail pages
            self._adm_page_ids = torch.full((self._adm_pages,), self.n_pages,
                                            dtype=torch.int64, device=dev)
            static += [self._tables, self._adm_page_ids]
        else:
            self._caches = tf.init_cache(cfg, self.max_batch, self.max_len,
                                         device=dev)
            # the admission's slot (an index of one) and true length
            self._adm_slot = torch.zeros(1, dtype=torch.int64, device=dev)
            self._adm_len = torch.zeros((), dtype=torch.int32, device=dev)
            static += [self._adm_slot, self._adm_len]
        self._decode_call = self._decode_body
        self._admit_call = self._admit_body
        if self.cuda_graphs:
            pool = torch.cuda.graph_pool_handle()
            counters = (LAUNCHES, STATS)
            self._decode_call = CudaGraph(self._decode_body, static,
                                          pool=pool, counters=counters)
            self._admit_call = CudaGraph(self._admit_body, static,
                                         pool=pool, counters=counters)

    # -- request intake ----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16) -> int:
        """Enqueue one request; returns its request id."""
        prompt = list(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.prompt_pad:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"prompt_pad={self.prompt_pad}")
        budget = self.max_len - len(prompt)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(prompt, min(max_new_tokens, budget),
                                   rid, time.perf_counter()))
        return rid

    # -- device slot state -------------------------------------------------
    def _set_slot_state(self, slot: int, tok: int, pos: int,
                        active: bool) -> None:
        """Patch one slot's device decode state (admission and finish
        events only, never per step)."""
        self._toks[slot] = tok
        self._poss[slot] = pos
        self._active[slot] = active

    # -- model calls: the bodies the graphs capture ------------------------
    @torch.no_grad()
    def _admit_body(self) -> None:
        """Prefill ``_adm_toks`` and write its KV: into the pages
        ``_adm_page_ids`` names (paged), or into slot ``_adm_slot`` with
        the positions from ``_adm_len`` on invalidated (contiguous)."""
        batch = {"tokens": self._adm_toks}
        if self.paged:
            _, cache, _ = tf.prefill(
                self.params, batch, self.cfg, self.dispatch,
                max_len=self._adm_pages * self.page_size)
            mlayers.paged_prefill_insert(self._pool, cache.k[:, 0],
                                         cache.v[:, 0], self._adm_page_ids)
            return
        _, cache, _ = tf.prefill(self.params, batch, self.cfg,
                                 self.dispatch, max_len=self.max_len)
        bigs = ([self._caches] if isinstance(self._caches, KVCache)
                else self._caches)
        smalls = [cache] if isinstance(cache, KVCache) else cache
        for big, small in zip(bigs, smalls):
            # the slot is the cache's batch axis (after [L] when stacked)
            axis = big.k.dim() - 4
            pos = torch.where((small.pos >= 0) & (small.pos < self._adm_len),
                              small.pos, torch.full_like(small.pos, -1))
            big.k.index_copy_(axis, self._adm_slot, small.k)
            big.v.index_copy_(axis, self._adm_slot, small.v)
            big.pos.index_copy_(axis, self._adm_slot, pos)

    @torch.no_grad()
    def _decode_body(self) -> None:
        """One decode step over every slot: logits into ``logits``, the
        greedy tokens into ``_toks``, positions advanced in place."""
        if self.paged:
            logits, _ = tf.decode_step_paged(
                self.params, self._pool, self._tables, self._toks,
                self._poss, self._active, self.cfg, self.dispatch)
        else:
            logits, _ = tf.decode_step(self.params, self._caches, self._toks,
                                       self._poss, self.cfg, self.dispatch)
        self.logits.copy_(logits)
        self._toks.copy_(torch.argmax(logits, dim=-1))
        self._poss.add_(1)

    def _prefill_into_pages(self, toks: np.ndarray, pages: List[int]) -> None:
        page_ids = np.full(self._adm_pages, self.n_pages, np.int64)
        page_ids[:len(pages)] = pages
        _upload(self._adm_toks[0], toks)
        _upload(self._adm_page_ids, page_ids)
        self._admit_call()

    def _prefill_into_slot(self, toks: np.ndarray, true_len: int,
                           slot: int) -> None:
        _upload(self._adm_toks[0], toks)
        self._adm_slot.fill_(slot)
        self._adm_len.fill_(true_len)
        self._admit_call()

    def _decode(self) -> None:
        if self.paged and self._tables_dirty:
            _upload(self._tables, self._tables_np)
            self._tables_dirty = False
        self._decode_call()

    @property
    def captures(self) -> dict:
        """CUDA-graph captures of the decode step and the admission (0
        each when the bodies run eagerly)."""
        return {name: getattr(call, "captures", 0) for name, call in
                (("decode", self._decode_call), ("admit", self._admit_call))}

    # -- scheduling --------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.free]

    def _admit(self) -> int:
        """Move queued requests into free slots (FIFO).  The static
        scheduler admits only when *every* slot is free.  Paged: the
        queue head also needs ``ceil(true_len / page_size)`` free pages;
        a blocked head counts an admission stall and keeps FIFO order."""
        free = self._free_slots()
        if self.scheduler == "static" and len(free) < self.max_batch:
            return 0
        admitted = 0
        for slot_id in free:
            if not self._queue:
                break
            req = self._queue[0]
            true_len = len(req.prompt)
            pages: List[int] = []
            if self.paged:
                need = self.pool_alloc.pages_for(true_len)
                if not self.pool_alloc.can_alloc(need):
                    self.admission_stalls += 1
                    break
                pages = self.pool_alloc.alloc(need, req.rid)
            self._queue.popleft()
            toks = np.zeros(self.prompt_pad, np.int64)
            toks[:true_len] = req.prompt
            if self.paged:
                self._prefill_into_pages(toks, pages)
                self._tables_np[slot_id, :] = -1
                self._tables_np[slot_id, :len(pages)] = pages
                self._tables_dirty = True
            else:
                self._prefill_into_slot(toks, true_len, slot_id)
            self.admissions += 1
            self._slots[slot_id] = _Slot(
                rid=req.rid, tokens=[], next_token=req.prompt[-1],
                pos=true_len - 1, remaining=req.max_new_tokens,
                admit_s=time.perf_counter(), submit_s=req.submit_s,
                pages=pages, prompt=list(req.prompt),
                budget=req.max_new_tokens, admit_seq=self._admit_seq)
            self._admit_seq += 1
            self._set_slot_state(slot_id, req.prompt[-1], true_len - 1, True)
            admitted += 1
        return admitted

    # -- paged page management ---------------------------------------------
    def _pick_victim(self, exclude: int) -> Optional[int]:
        cands = [(s.admit_seq, i) for i, s in enumerate(self._slots)
                 if not s.free and i != exclude]
        return max(cands)[1] if cands else None

    def _preempt(self, slot_id: int) -> None:
        """Evict one active request (recompute-from-start): free its
        pages, drop its generated tokens, and requeue the *original*
        request at the queue front so FIFO completion order survives."""
        s = self._slots[slot_id]
        self.pool_alloc.release(s.pages, s.rid)
        self._queue.appendleft(Request(s.prompt, s.budget, s.rid,
                                       s.submit_s))
        self._tables_np[slot_id, :] = -1
        self._tables_dirty = True
        self._slots[slot_id] = _Slot()
        self._set_slot_state(slot_id, 0, 0, False)
        self.preemptions += 1

    def _grow_pages(self) -> None:
        """Before a decode step, make sure every active slot owns the page
        its next write lands in, oldest admission first; preempt the
        newest-admitted requests when the pool runs dry.  Terminates:
        ``n_pages >= max_pages_per_req`` lets the oldest survivor grow
        once every other slot is evicted."""
        order = sorted((i for i, s in enumerate(self._slots) if not s.free),
                       key=lambda i: self._slots[i].admit_seq)
        for i in order:
            s = self._slots[i]
            if s.free:           # preempted earlier in this pass
                continue
            while s.pos // self.page_size >= len(s.pages):
                if self.pool_alloc.can_alloc(1):
                    page = self.pool_alloc.alloc(1, s.rid)[0]
                    self._tables_np[i, len(s.pages)] = page
                    s.pages.append(page)
                    self._tables_dirty = True
                else:
                    victim = self._pick_victim(exclude=i)
                    if victim is None:
                        raise RuntimeError(
                            "page pool deadlock: lone request cannot grow "
                            "(kv_pool_pages misconfigured?)")
                    self._preempt(victim)

    def _refresh_gauges(self) -> None:
        used = self.pool_alloc.used_pages
        live = sum(s.pos + 1 for s in self._slots if not s.free)
        self._peak_pages = max(self._peak_pages, used)
        PAGE_POOL["pages_used"] = used
        PAGE_POOL["pages_free"] = self.pool_alloc.free_pages
        PAGE_POOL["peak_pages_used"] = self._peak_pages
        PAGE_POOL["fragmentation"] = (
            round(1.0 - live / (used * self.page_size), 4) if used else 0.0)
        PAGE_POOL["preemptions"] = self.preemptions
        PAGE_POOL["admission_stalls"] = self.admission_stalls

    def pool_metrics(self) -> dict:
        """Current page-pool gauges (paged engines only)."""
        if not self.paged:
            return {}
        self._refresh_gauges()
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "kv_quant": self.kv_quant, **{k: PAGE_POOL[k]
                                              for k in PAGE_POOL}}

    def step(self) -> int:
        """One engine iteration: admit, grow block tables (paged), then
        advance every slot one token.  Returns the number of requests
        completed."""
        self._admit()
        if self.paged:
            self._grow_pages()
        active = [i for i, s in enumerate(self._slots) if not s.free]
        if not active:
            if self.paged:
                self._refresh_gauges()
            return 0
        self.occupancy.append(len(active))
        self._decode()
        nxt = self._toks.cpu().numpy()
        now = time.perf_counter()
        done = 0
        for i in active:
            s = self._slots[i]
            tok = int(nxt[i])
            s.tokens.append(tok)
            if s.ttft_s < 0:
                s.ttft_s = now - s.submit_s
            s.pos += 1
            s.next_token = tok
            s.remaining -= 1
            if s.remaining <= 0 or (self.eos_id is not None
                                    and tok == self.eos_id):
                self._finish(i, now)
                done += 1
        self.steps += 1
        if self.paged:
            self._refresh_gauges()
        return done

    def _finish(self, slot_id: int, now: float) -> None:
        s = self._slots[slot_id]
        n = len(s.tokens)
        span = max(now - s.admit_s, 1e-9)
        self._outputs[s.rid] = list(s.tokens)
        self._metrics[s.rid] = RequestMetrics(
            rid=s.rid, prompt_len=s.pos + 1 - n, new_tokens=n,
            queue_wait_s=s.admit_s - s.submit_s, ttft_s=s.ttft_s,
            decode_s=max(now - (s.submit_s + s.ttft_s), 0.0),
            tokens_per_s=n / span)
        if self.paged and s.pages:
            self.pool_alloc.release(s.pages, s.rid)
            self._tables_np[slot_id, :] = -1
            self._tables_dirty = True
        self._slots[slot_id] = _Slot()
        self._set_slot_state(slot_id, 0, 0, False)

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(1 for s in self._slots if not s.free)

    def run(self, requests: Optional[Sequence[Request]] = None,
            max_steps: int = 100_000) -> dict:
        """Drive the engine until every queued request completes.
        Returns {'outputs': {rid: tokens}, 'metrics': {rid: ...},
        'requests_per_s', 'tokens_per_s', 'steps', 'wall_s'} (plus
        'pool': page-pool gauges when paged)."""
        for req in requests or ():
            self.submit(req.prompt, req.max_new_tokens)
        t0 = time.perf_counter()
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        wall = max(time.perf_counter() - t0, 1e-9)
        mets = dict(self._metrics)
        total_tokens = sum(m.new_tokens for m in mets.values())
        out: dict[str, Any] = {
            "outputs": dict(self._outputs),
            "metrics": mets,
            "requests_per_s": len(mets) / wall,
            "tokens_per_s": total_tokens / wall,
            "steps": steps,
            "wall_s": wall,
        }
        if self.paged:
            out["pool"] = self.pool_metrics()
        return out
