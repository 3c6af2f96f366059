"""Compressed-weight serving (a port of ``repro.serve``):
``serve.compressed`` turns a dense parameter tree into zero-densify
serving weights chosen by a compression policy, and ``serve.engine``
runs a continuous-batching request runtime over the model's prefill and
decode entry points."""

from repro_torch.serve.compressed import (   # noqa: F401
    STATS,
    CompressedTensor,
    compress_tree,
    reset_stats,
    tree_bytes,
)
from repro_torch.serve.engine import (       # noqa: F401
    Request,
    RequestMetrics,
    ServeEngine,
)
