"""The compression *channel*: one abstraction for everything that
crosses the wire, in either direction (DESIGN.md §5).

A port of ``repro.core.channel``: ``Channel`` for the single-process
engine and ``ShardChannel`` for the distributed one.  A Channel holds
the static policy — an operator (or tree of operators, Corollary 1), a
kernel-dispatch policy and a direction tag — plus the error-feedback
algebra

    q = C(acc),   memory' = acc − q,   bits = counted wire cost,

routed through ``kernels.dispatch.channel_compress_tree``, so eligible
leaves run the CUDA kernels (megabuffer-packed: one launch per bucket
per direction per sync round) and the kernel's fused memory is used
directly.  An Identity channel means no compression: the engine takes
the exact-broadcast path and the ledger charges the dense cost.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import bits as bitlib
from repro_torch.core.operators import CompressionOp, Identity
from repro_torch.tree import tree_leaves, tree_map


class WireLedger(NamedTuple):
    """Per-direction cumulative wire bits (the paper's x-axis, §1.4)."""

    up: Any    # worker → server
    down: Any  # server → worker

    @property
    def total(self):
        return self.up + self.down


def wire_ledger(state) -> WireLedger:
    """Per-direction ledger of an engine state with ``bits`` /
    ``bits_down`` fields."""
    down = getattr(state, "bits_down", None)
    if down is None:
        down = torch.zeros((), dtype=torch.float32)
    return WireLedger(up=state.bits, down=down)


def _all_identity(op_tree) -> bool:
    if isinstance(op_tree, CompressionOp):
        return isinstance(op_tree, Identity)
    leaves = tree_leaves(op_tree, is_leaf=lambda o: isinstance(
        o, CompressionOp))
    return all(isinstance(o, Identity) for o in leaves)


@dataclasses.dataclass(frozen=True)
class Channel:
    """Engine-level channel: operator tree + dispatch policy + direction.

    ``operator`` is a ``CompressionOp`` or a tree of them; ``dispatch``
    the kernel routing policy (None = dispatch defaults); ``direction``
    a tag ("uplink" | "downlink").
    """

    operator: Any
    direction: str = "uplink"
    dispatch: Optional[Any] = None  # kernels.dispatch.DispatchConfig

    def is_identity(self) -> bool:
        """True when the channel transmits exactly (no compression)."""
        return self.operator is None or _all_identity(self.operator)

    def init_memory(self, tree):
        """Fresh (zero) float32 error memory in ``tree``'s layout."""
        return tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), tree)

    def apply(self, rng, acc, *, per_leaf: bool = False,
              batched: bool = False):
        """Error-compensated compression of the accumulator ``acc``
        (the caller adds the memory in: acc = memory + payload).

        Returns ``(q, new_memory, bits)`` with ``new_memory == acc − q``
        and counted wire bits.  With ``per_leaf`` a fourth element
        carries the per-leaf bits (flatten order) for the per-leaf-group
        ledger.  ``batched``: ``acc``'s leaves lead with a worker axis and
        the bits, per-leaf bits included, are per worker ([B] vectors;
        see ``channel_compress_tree``).
        """
        from repro_torch.kernels import dispatch as dsp
        return dsp.channel_compress_tree(
            self.operator, rng, acc, self.dispatch,
            want_leaf_bits=per_leaf, batched=batched)

    def dense_bits(self, tree, value_bits: int = 32) -> float:
        """Exact-transmission wire cost of one broadcast of ``tree``."""
        return bitlib.bits_dense_tree(tree, value_bits)


def as_channel(op_or_channel, direction: str, dispatch=None) -> Channel:
    """Normalize a make_step-style argument into a Channel.  ``None`` and
    Identity operators give an Identity channel."""
    if isinstance(op_or_channel, Channel):
        return op_or_channel
    return Channel(operator=op_or_channel, direction=direction,
                   dispatch=dispatch)


@dataclasses.dataclass(frozen=True)
class ShardChannel:
    """Channel of the distributed engine: wraps a
    ``core.distributed.ShardCompressor`` (spec-aware, per-leaf
    compression) with the same error-feedback algebra and direction tag.
    Duck-typed, to keep channel and distributed free of an import cycle;
    ``compressor`` None means Identity."""

    compressor: Any
    direction: str = "uplink"

    def is_identity(self) -> bool:
        return self.compressor is None or self.compressor.is_identity()

    def init_memory(self, tree):
        return tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), tree)

    def apply(self, acc, param_specs, rng=None, shards=None):
        """Dense-form error-compensated compression of ``acc``:
        ``(q, new_memory, bits)`` with ``q + new_memory == acc``.  ``rng``
        feeds the stochastic operators of a heterogeneous policy;
        ``shards``: ``acc`` is a rank's model shards
        (``core.distributed.ModelShards``)."""
        q, bits = self.compressor(acc, param_specs, rng=rng, shards=shards)
        new_mem = tree_map(lambda a, g: a - g, acc, q)
        return q, new_mem, bits

    def compact(self, acc, param_specs, rng=None, shards=None):
        """Compact wire form (DESIGN.md §3.3): ``ShardCompressor.compact``'s
        (payloads, spec, bits, memory)."""
        return self.compressor.compact(acc, param_specs, rng=rng,
                                       shards=shards)

    def dense_bits(self, tree, value_bits: int = 32) -> float:
        return bitlib.bits_dense_tree(tree, value_bits)
