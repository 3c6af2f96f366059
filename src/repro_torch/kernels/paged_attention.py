"""Paged single-token decode attention over a shared KV page pool
(``repro``'s ``kernels/paged_attention.py::paged_decode_fwd``),
hand-written in CUDA C++ for Hopper (``csrc/paged_decode.cu``), split
over each row's pages (``paged_splits``) with the live splits' partials
merged by the last of them.

A CUDA tensor launches the kernel on the current stream; a CPU tensor
runs the plain version (``ref.paged_decode_ref``); a ``meta`` tensor (a
dry run) gets an empty output of the kernel's shape.  There is no other
route: a failed build or launch raises.  Under a CUDA-graph capture the
split partials come from the graph's pool and the ticket buffer from
before the capture, as ``flash_attention``'s do.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (
    _tickets, decode_heads_per_block)
from repro_torch.kernels.launch_stats import count

#: logical pages one block takes when the caller names no geometry
DEFAULT_PAGES_PER_BLOCK = 4


def paged_splits(P: int, pages_per_block: int) -> int:
    """Blocks a (row, kv head) has: its ``P`` table entries in splits of
    ``pages_per_block`` consecutive pages, the last one ragged."""
    return -(-P // pages_per_block)


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
    if dev.type in ("cuda", "meta") and (hd % 8 or hd > 256):
        raise ValueError(f"paged_decode takes head widths that are "
                         f"multiples of 8 up to 256, got {hd}")
    pb = max(1, min(int(pages_per_block), P))
    count("paged_decode", B=B, H=H, KV=KV, hd=hd, P=P, page_size=ps,
          quant=kp.dtype == torch.int8, elem=q.element_size())
    if dev.type == "meta":
        return torch.empty_like(q)
    if dev.type == "cpu":
        return ref.paged_decode_ref(q, kp, vp, kscale, vscale, tables,
                                    lengths)
    # the kernel reads K and V rows in 16-byte vectors (8 bytes of int8)
    align = 8 if kp.dtype == torch.int8 else 16
    if kp.data_ptr() % align or vp.data_ptr() % align:
        raise ValueError(f"kp and vp must start on a {align}-byte boundary")
    G = H // KV
    # at most 4 query heads a block: the registers of 8 heads' query and
    # output slices would leave room for 2 positions in flight, not 8
    GT = min(4, decode_heads_per_block(G))
    units = B * KV * -(-G // GT)
    splits = paged_splits(P, pb)
    # the partials of every split in one allocation: o (16-byte aligned
    # at the start), then m, then l
    n_part = units * splits * GT if splits > 1 else 0
    part = torch.empty(n_part * (hd + 2), dtype=torch.float32, device=dev)
    p_o = part.data_ptr()
    p_m = p_o + 4 * n_part * hd
    lib = _build.load()
    out = torch.empty_like(q)
    _build.check(lib.qs_paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kscale.data_ptr(),
        vscale.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), p_m, p_m + 4 * n_part, p_o,
        _tickets(dev, units).data_ptr(), B, H, KV, hd, n_pages, ps, P, pb,
        GT, hd ** -0.5, int(q.dtype == torch.bfloat16),
        int(kp.dtype == torch.int8), _build.stream_of(dev)))
    return out
