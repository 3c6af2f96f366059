"""Paged single-token decode attention over a shared KV page pool
(``repro``'s ``kernels/paged_attention.py::paged_decode_fwd``),
hand-written in CUDA C++ for Hopper (``csrc/paged_decode.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor
runs the plain version (``ref.paged_decode_ref``).  There is no other
route: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES

#: pages staged per tile when the caller names no geometry
DEFAULT_PAGES_PER_BLOCK = 4
#: shared memory one block may use on an H100 (227 KB)
MAX_SMEM = 232_448


def smem_bytes(G: int, hd: int, tile_tokens: int) -> int:
    """Dynamic shared memory of one block (``csrc/paged_decode.cu``)."""
    return 4 * (2 * G * hd + 2 * tile_tokens * (hd + 1)
                + G * tile_tokens + 3 * G)


def paged_decode(q, kp, vp, kscale, vscale, tables, lengths, *,
                 pages_per_block: int = DEFAULT_PAGES_PER_BLOCK):
    """Single-token GQA decode attention against a KV page pool.

    q: [B, 1, H, hd] float32 or bfloat16 (rope'd at each row's position);
    kp/vp: [n_pages, page_size, KV, hd] in q's dtype, or int8 levels with
    kscale/vscale [n_pages, page_size] float32 per-slot scales (read only
    for int8 pools); tables: [B, P] int32 block tables (-1 =
    unallocated); lengths: [B] int32 (0 = free slot: exact zeros).
    Returns [B, 1, H, hd] in q's dtype.
    """
    _build.check_tensor("q", q, 4, (torch.float32, torch.bfloat16))
    for name, t in (("kp", kp), ("vp", vp)):
        _build.check_tensor(name, t, 4, (q.dtype, torch.int8))
    _build.check_tensor("kscale", kscale, 2, (torch.float32,))
    _build.check_tensor("vscale", vscale, 2, (torch.float32,))
    _build.check_tensor("tables", tables, 2, (torch.int32,))
    _build.check_tensor("lengths", lengths, 1, (torch.int32,))
    B, one, H, hd = q.shape
    n_pages, ps, KV, hd_p = kp.shape
    P = tables.shape[1]
    if one != 1 or hd_p != hd or H % KV or vp.shape != kp.shape \
            or vp.dtype != kp.dtype:
        raise ValueError(f"shapes q {tuple(q.shape)} kp {tuple(kp.shape)} "
                         f"vp {tuple(vp.shape)} do not fit")
    if tuple(kscale.shape) != (n_pages, ps) or vscale.shape != kscale.shape:
        raise ValueError(f"scales must be [{n_pages}, {ps}]")
    if tables.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={B}")
    dev = _build.device_of(q, kp, vp, kscale, vscale, tables, lengths)
    pb = max(1, min(int(pages_per_block), P))
    LAUNCHES["paged_decode"] += 1
    if dev.type == "cpu":
        return ref.paged_decode_ref(q, kp, vp, kscale, vscale, tables,
                                    lengths)
    smem = smem_bytes(H // KV, hd, pb * ps)
    if smem > MAX_SMEM:
        raise ValueError(f"paged_decode needs {smem} bytes of shared memory "
                         f"(G={H // KV}, hd={hd}, {pb} pages of {ps}); "
                         f"at most {MAX_SMEM}: lower pages_per_block")
    lib = _build.load()
    out = torch.empty_like(q)
    _build.check(lib.qs_paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kscale.data_ptr(),
        vscale.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, KV, hd, n_pages, ps, P, pb, hd ** -0.5,
        int(q.dtype == torch.bfloat16), int(kp.dtype == torch.int8),
        _build.stream_of(dev)))
    return out
