"""Qsparse-local-SGD core (a port of ``repro.core``): compression
operators, error-feedback channels, the unified sync/async engine with
its Algorithm-1/2 wrappers (``qsparse``, ``async_qsparse``) and its round
plans (``rounds``), bit accounting, compression policies and the
distributed engine."""

from repro_torch.core import (async_qsparse, bits, channel, engine,
                              operators, policy, qsparse, rounds, schedule)
from repro_torch.core.engine import EngineState
from repro_torch.core.policy import ChannelSpec, OpSpec, PolicySpec
from repro_torch.core.operators import (
    CompressionOp,
    Identity,
    QSGDQuantizer,
    QuantizedSparsifier,
    RandK,
    RowSignTopK,
    RowTopK,
    Sign,
    SignSparsifier,
    StochasticKLevel,
    TopK,
    compress_tree,
    make_operator,
    tree_gamma,
)

__all__ = [
    "async_qsparse",
    "bits",
    "channel",
    "engine",
    "EngineState",
    "operators",
    "policy",
    "qsparse",
    "rounds",
    "schedule",
    "ChannelSpec",
    "OpSpec",
    "PolicySpec",
    "CompressionOp",
    "Identity",
    "QSGDQuantizer",
    "QuantizedSparsifier",
    "RandK",
    "RowSignTopK",
    "RowTopK",
    "Sign",
    "SignSparsifier",
    "StochasticKLevel",
    "TopK",
    "compress_tree",
    "make_operator",
    "tree_gamma",
]
