"""Flash attention on Hopper: the two kernels of ``repro``'s
``kernels/flash_attention.py``, hand-written in CUDA C++.

- ``flash_attention_fwd`` (``csrc/flash_attention.cu``): causal,
  optionally sliding-window GQA attention over a whole sequence, the
  prefill of unscanned layer stacks under ``cfg.use_pallas``.
- ``flash_decode`` (``csrc/flash_decode.cu``): single-token decode
  attention over a ring KV cache.

A CUDA tensor launches the kernel on the current stream; a CPU tensor
runs the plain version (``ref.flash_attention_ref``,
``ref.flash_decode_ref``).  There is no other route: a failed build or
launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.paged_attention import MAX_SMEM

_TILE = 32  # cache slots staged at a time (csrc/flash_decode.cu)
#: head widths ``csrc/flash_attention.cu`` is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_BQ, _BK = 64, 32  # query rows per block, keys per tile (the .cu file)


def flash_attention_smem(D: int) -> int:
    """Dynamic shared memory of one ``flash_attention`` block: the
    query tile and a K tile (rows padded to D + 4 floats), a V tile, the
    probabilities and two per-row vectors, all float32."""
    return 4 * (_BQ * (D + 4) + _BK * (D + 4) + _BK * D + _BQ * (_BK + 4)
                + 2 * _BQ)


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
    if dev.type == "cuda" and flash_attention_smem(D) > MAX_SMEM:
        raise ValueError(f"flash_attention needs {flash_attention_smem(D)} "
                         f"bytes of shared memory; at most {MAX_SMEM}")
    LAUNCHES["flash_attention"] += 1
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window)
    lib = _build.load()
    out = torch.empty_like(q)
    _build.check(lib.qs_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, D, int(window), D ** -0.5, int(q.dtype == torch.bfloat16),
        _build.stream_of(dev)))
    return out


def flash_decode(q, k, v, valid):
    """Single-token GQA decode attention.

    q: [B, 1, H, hd] float32 or bfloat16 (rope'd at the current
    position); k, v: [B, C, KV, hd] ring-cache contents in q's dtype;
    valid: bool slot-validity mask, [B, C] (one per row) or [C] (shared
    by every row, as ``repro`` passes it).  Returns [B, 1, H, hd].
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
    LAUNCHES["flash_decode"] += 1
    if dev.type == "cpu":
        return ref.flash_decode_ref(q, k, v, valid)
    G = H // KV
    smem = 4 * (2 * G * hd + G * C + _TILE * (hd + 1) + G)
    if smem > MAX_SMEM:
        raise ValueError(f"flash_decode needs {smem} bytes of shared memory "
                         f"for a cache of {C} slots; at most {MAX_SMEM}")
    mask = valid.reshape(-1, C).expand(B, C).contiguous()
    lib = _build.load()
    out = torch.empty_like(q)
    _build.check(lib.qs_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, H, KV, hd, C, hd ** -0.5,
        int(q.dtype == torch.bfloat16), _build.stream_of(dev)))
    return out
