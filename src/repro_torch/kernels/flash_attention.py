"""Single-token decode attention over a ring KV cache (``repro``'s
``kernels/flash_attention.py::flash_decode_fwd``), hand-written in CUDA
C++ for Hopper (``csrc/flash_decode.cu``).

``repro``'s prefill kernel in the same module (``flash_attention_fwd``)
runs only on unscanned layer stacks and is not ported yet (ROADMAP
queue 2).  A CUDA tensor launches the kernel on the current stream; a
CPU tensor runs the plain version (``ref.flash_decode_ref``).  There is
no other route: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.paged_attention import MAX_SMEM

_TILE = 32  # cache slots staged at a time (csrc/flash_decode.cu)


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
