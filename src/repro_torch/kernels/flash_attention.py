"""Flash attention on Hopper: the two kernels of ``repro``'s
``kernels/flash_attention.py``, hand-written in CUDA C++.

- ``flash_attention_fwd`` (``csrc/flash_attention.cu``): causal,
  optionally sliding-window GQA attention over a whole sequence, the
  prefill of attention with a static window under ``cfg.use_pallas``
  (unscanned dense stacks, Zamba2's shared block).  Routed by
  dtype: bfloat16 (every card path) to the tensor-core kernel, float32 to
  the float32 FMA kernel (full float32 precision, which the float32
  agreement checks need; TF32 would not give it).
- ``flash_decode`` (``csrc/flash_decode.cu``): single-token decode
  attention over a ring KV cache, split over the cache length
  (``decode_splits``) with the partials merged by the last block of each
  (row, kv head).

A CUDA tensor launches a kernel on the current stream; a CPU tensor runs
the plain version (``ref.flash_attention_ref``, ``ref.flash_decode_ref``);
a ``meta`` tensor (a dry run) gets an empty output of the kernel's shape,
after the card's argument checks that need no call to the card.  There
is no other route: a failed build or launch raises.  A launch
makes no host call that a CUDA-graph capture forbids: its scratch (the
split partials) is a ``torch.empty`` of the call, which under a capture
comes from the graph's memory pool and lives as long as the graph; its
ticket buffer is made before the capture (``_tickets``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import count

#: head widths ``csrc/flash_attention.cu`` is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
#: the kernel ``flash_attention_fwd`` launches for each dtype
ROUTES = {torch.bfloat16: "bf16 tensor cores (mma.sync m16n8k16)",
          torch.float32: "float32 FMA"}
_BQ, _BK = 64, 32  # float32 kernel: query rows per block, keys per tile
#: shared memory one block may use on an H100 (227 KB)
MAX_SMEM = 232_448
#: flash_decode: least slots a split takes, most query heads a block
#: serves (head groups beyond)
DECODE_MIN_CHUNK = 64
_DECODE_HEADS = (1, 2, 4, 8)


def flash_attention_smem(D: int) -> int:
    """Dynamic shared memory of one float32 ``flash_attention`` block: the
    query tile and a K tile (rows padded to D + 4 floats), a V tile, the
    probabilities and two per-row vectors, all float32."""
    return 4 * (_BQ * (D + 4) + _BK * (D + 4) + _BK * D + _BQ * (_BK + 4)
                + 2 * _BQ)


class TcGeometry(NamedTuple):
    """The bfloat16 (tensor-core) kernel's geometry at one head width."""
    rows: int      # packed (position, head) rows a tile
    keys: int      # keys a staged K / V tile
    smem: int      # dynamic shared memory of a block, bytes
    scratch: int   # scratch floats of one split tile (two halves' state)


@functools.lru_cache(maxsize=None)
def tc_geometry(D: int) -> TcGeometry:
    """The tensor-core kernel's geometry at head width D, as the library
    reports it (``qs_flash_attention_bf16_geometry``)."""
    geo = (ctypes.c_int * 4)()
    _build.check(_build.load().qs_flash_attention_bf16_geometry(D, geo))
    return TcGeometry(*geo)


@functools.lru_cache(maxsize=None)
def decode_max_splits() -> int:
    """The most splits ``flash_decode`` takes, as the library reports it."""
    return _build.load().qs_flash_decode_max_splits()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA card ``index``; ``decode_splits`` aims at waves of
    them."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_schedule(S: int, H: int, KV: int, window: int, rows: int,
                       keys: int) -> int:
    """How many of the tensor-core kernel's tiles of ``rows`` packed
    (position, head) rows are split in two halves of their ``keys``-key
    tiles, to even out causal work.

    Blocks take the longest tiles first.  A window bounds every tile's
    keys: no split.  Causal without one, every tile sees keys from 0, so
    its key tiles grow with its index and the longest tile would set the
    launch's length: the tiles that see more than half the longest tile's
    key tiles are split, so that no block walks more than about half the
    longest tile.
    """
    if 0 < window < S:
        return 0
    G = H // KV
    tiles = -(-S * G // rows)
    # key tiles tile t sees: positions up to its last row's
    n_kt = [min(S - 1, (t * rows + rows - 1) // G) // keys + 1
            for t in range(tiles)]
    cap = -(-n_kt[-1] // 2)
    return sum(n > cap for n in n_kt)


def split_tiles(S: int, H: int, KV: int, D: int, window: int) -> int:
    """``attention_schedule`` at the kernel's geometry for head width D:
    what ``flash_attention_fwd`` launches."""
    geo = tc_geometry(D)
    return attention_schedule(S, H, KV, window, geo.rows, geo.keys)


def decode_splits(B: int, KV: int, C: int, sms: int,
                  max_splits: int) -> tuple:
    """(splits, chunk) of ``flash_decode``: the C cache slots of each
    (row, kv head) in ``splits`` contiguous chunks of ``chunk`` slots
    (the last one ragged, none empty), enough for about two waves of
    blocks over ``sms`` SMs, each at least ``DECODE_MIN_CHUNK`` slots, at
    most ``max_splits``."""
    want = -(-2 * sms // max(1, B * KV))
    splits = max(1, min(want, C // DECODE_MIN_CHUNK, max_splits))
    chunk = -(-C // splits)
    return -(-C // chunk), chunk


def decode_heads_per_block(G: int) -> int:
    """Query heads one ``flash_decode`` block serves: the smallest of 1,
    2, 4, 8 that holds the group's G, else 8 (and more head groups)."""
    return next((n for n in _DECODE_HEADS if n >= G), _DECODE_HEADS[-1])


def _check_aligned(**ts) -> None:
    """The kernels read 16-byte vectors: every base address must be
    16-byte aligned (a view with a ragged storage offset is refused)."""
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def flash_attention_fwd(q, k, v, *, window: int = -1):
    """Causal (``window`` > 0: sliding-window) GQA attention forward.

    q: [B, S, H, D]; k, v: [B, S, KV, D], float32 or bfloat16 (one dtype),
    H a multiple of KV, D in ``FLASH_HEAD_DIMS``.  Returns [B, S, H, D]
    in q's dtype.  Like ``repro``'s kernel it has no backward: an input
    that requires grad while autograd records raises.
    """
    _build.check_tensor("q", q, 4, (torch.float32, torch.bfloat16))
    _build.check_tensor("k", k, 4, (q.dtype,))
    _build.check_tensor("v", v, 4, (q.dtype,))
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, D) or v.shape != k.shape or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention takes head widths "
                         f"{FLASH_HEAD_DIMS}, got {D}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd has no backward (nor has repro's Pallas "
            "kernel); run it under torch.no_grad() or set use_pallas=False "
            "to differentiate")
    dev = _build.device_of(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if dev.type == "cuda":
        smem = tc_geometry(D).smem if bf16 else flash_attention_smem(D)
        if smem > MAX_SMEM:
            raise ValueError(f"flash_attention needs {smem} bytes of shared "
                             f"memory; at most {MAX_SMEM}")
    count("flash_attention", B=B, S=S, H=H, KV=KV, D=D, window=int(window),
          elem=q.element_size())
    if dev.type == "meta":
        return torch.empty_like(q)
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window)
    lib = _build.load()
    out = torch.empty_like(q)
    if bf16:
        _check_aligned(q=q, k=k, v=v)
        n_split = split_tiles(S, H, KV, D, window)
        scratch = torch.empty(B * KV * n_split * tc_geometry(D).scratch,
                              dtype=torch.float32, device=dev)
        _build.check(lib.qs_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _tickets(dev, B * KV * n_split).data_ptr(),
            B, S, H, KV, D, int(window), D ** -0.5, n_split,
            _build.stream_of(dev)))
    else:
        _build.check(lib.qs_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, KV, D, int(window), D ** -0.5, _build.stream_of(dev)))
    return out


#: the kernels' ticket counters (flash_decode's and paged_decode's
#: splits, flash_attention's split tiles), one zeroed int32 buffer per
#: (device, stream); the block that merges resets its counter to 0, so
#: the buffer is zero between launches, and so at the start of every
#: replay of a CUDA graph that captured launches using it
_TICKETS: dict = {}


def _tickets(dev, n: int):
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a buffer made here would be zeroed by the graph's memset
            # at every replay, in memory of the graph's pool: made
            # outside the capture instead (graphs.CudaGraph's warm-up
            # runs the body on the capture stream first)
            raise RuntimeError(
                "flash kernels: no ticket buffer for the capturing "
                "stream; run the body once on that stream before "
                "capturing it")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _TICKETS[key] = buf
    return buf


def flash_decode(q, k, v, valid):
    """Single-token GQA decode attention.

    q: [B, 1, H, hd] float32 or bfloat16 (rope'd at the current
    position); k, v: [B, C, KV, hd] ring-cache contents in q's dtype;
    valid: bool slot-validity mask, [B, C] (one per row) or [C] (shared
    by every row, as ``repro`` passes it).  Returns [B, 1, H, hd].  On
    the card hd must be a multiple of 8 up to 256 (every config's is).
    """
    _build.check_tensor("q", q, 4, (torch.float32, torch.bfloat16))
    _build.check_tensor("k", k, 4, (q.dtype,))
    _build.check_tensor("v", v, 4, (q.dtype,))
    B, one, H, hd = q.shape
    _, C, KV, hd_k = k.shape
    if one != 1 or hd_k != hd or H % KV or v.shape != k.shape \
            or k.shape[0] != B:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if valid.dtype != torch.bool or valid.shape not in ((C,), (B, C)):
        raise ValueError(f"valid must be bool [{C}] or [{B}, {C}], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    dev = _build.device_of(q, k, v, valid)
    if dev.type in ("cuda", "meta") and (hd % 8 or hd > 256):
        raise ValueError(f"flash_decode takes head widths that are "
                         f"multiples of 8 up to 256, got {hd}")
    count("flash_decode", B=B, H=H, KV=KV, hd=hd, C=C,
          elem=q.element_size())
    if dev.type == "meta":
        return torch.empty_like(q)
    if dev.type == "cpu":
        return ref.flash_decode_ref(q, k, v, valid)
    _check_aligned(k=k, v=v)
    G = H // KV
    GT = decode_heads_per_block(G)
    units = B * KV * -(-G // GT)
    splits, chunk = decode_splits(B, KV, C, sm_count(dev.index),
                                  decode_max_splits())
    mask = valid.reshape(-1, C).expand(B, C).contiguous()
    # the partials of every split in one allocation: o (16-byte aligned
    # at the start), then m, then l
    n_part = units * splits * GT if splits > 1 else 0
    part = torch.empty(n_part * (hd + 2), dtype=torch.float32, device=dev)
    p_o = part.data_ptr()
    p_m = p_o + 4 * n_part * hd
    tickets = _tickets(dev, units)
    lib = _build.load()
    out = torch.empty_like(q)
    _build.check(lib.qs_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), p_m, p_m + 4 * n_part, p_o, tickets.data_ptr(), B,
        H, KV, hd, C, GT, splits,
        chunk, hd ** -0.5, int(q.dtype == torch.bfloat16),
        _build.stream_of(dev)))
    return out
