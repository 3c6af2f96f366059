"""The tensor-parallel collectives of the model code, inside autograd:
the port's counterpart of ``repro``'s ``maybe_shard`` / ``pvary``
(``repro.models.layers``), which leave the ``model`` axis to XLA's SPMD
partitioner.  PyTorch has none, so the Megatron-style regions are
written out:

* :func:`copy_in` — into a column-parallel region: the identity forward,
  the gradient all-reduced over the model group in the backward (each
  rank's product saw only its columns);
* :func:`reduce_out` — out of a row-parallel region: the partial sums
  all-reduced forward, the identity backward;
* :func:`gather_features` — a column-parallel output whole on every rank
  (the attention's q / k / v where a shard does not hold whole heads):
  an all-gather along the last axis forward; backward, this rank's slice
  of the model group's summed gradient (a reduce-scatter, run as an
  all-reduce and a slice, which every backend has);
* :func:`vocab_embed` — the lookup in a vocab-sharded table: each rank
  its rows, the rest zero, summed over the group;
* :func:`vocab_nll` — cross entropy over vocab-sharded logits: the
  global max, log-sum-exp and gold logit, each by all-reduce.

Two more for the RWKV-6 and Zamba2 families, whose blocks hand values
between work every rank does alike and work split over the group:

* :func:`split_features` — a whole value every rank computes alike, cut
  to this rank's slice for per-rank work: the slice forward; backward,
  the slices' gradients all-gathered into the whole gradient, equal on
  every rank (``own_features`` leaves zeros outside the slice, right
  only where the whole value's gradient is then summed over the group);
* :func:`gather_whole` — the group's slices made whole for work every
  rank then does alike: an all-gather forward; backward, this rank's
  slice of the whole gradient, which every rank holds in full
  (``gather_features``' sum would count it M times).

(Partial sums whose total feeds per-rank work, as the mean square of a
norm over split features, are ``copy_in(reduce_out(x))``: all-reduced
forward and backward.)  The rule behind them: a leaf whole on every rank must get the same
whole gradient on every rank (``core.distributed.ModelShards`` counts
it once), so every value such a leaf reaches is either computed alike
with its gradient whole on every rank, or per rank, and each crossing
between the two is one of these regions.

Each goes through the ``launch.mesh.Mesh`` methods (``over="model"``), so
a dry run's ``DryMesh`` records it.  Under a policy with a model group
of one every function is the identity (or the plain lookup / loss), and
the model runs as without one.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShardingPolicy


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_sum(g.clone(), over="model"), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_sum(x.clone(), over="model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = mesh.all_gather(x.contiguous(), over="model")
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        total = mesh.all_reduce_sum(g.contiguous().clone(), over="model")
        n = total.shape[-1] // mesh.model_size
        return total.narrow(-1, mesh.model_rank * n, n).contiguous(), None


class _SplitFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = x.shape[-1] // mesh.model_size
        return x.narrow(-1, mesh.model_rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = ctx.mesh.all_gather(g.contiguous(), over="model")
        return torch.cat(parts.unbind(0), dim=-1), None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = mesh.all_gather(x.contiguous(), over="model")
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[-1] // mesh.model_size
        return g.narrow(-1, mesh.model_rank * n, n).contiguous(), None


def copy_in(x: torch.Tensor, policy: ShardingPolicy) -> torch.Tensor:
    """``x`` entering a column-parallel region (all-reduce backward)."""
    return _CopyIn.apply(x, policy.mesh) if policy.active else x


def reduce_out(x: torch.Tensor, policy: ShardingPolicy) -> torch.Tensor:
    """The model group's partial sums ``x`` summed (identity backward)."""
    return _ReduceOut.apply(x, policy.mesh) if policy.active else x


def gather_features(x: torch.Tensor,
                    policy: ShardingPolicy) -> torch.Tensor:
    """The model group's slices of ``x`` along its last axis, whole."""
    return _GatherFeatures.apply(x, policy.mesh) if policy.active else x


def own_features(x: torch.Tensor, policy: ShardingPolicy) -> torch.Tensor:
    """This rank's slice of a whole ``x`` along its last axis (a view;
    its gradient is zero outside the slice)."""
    if not policy.active:
        return x
    n = x.shape[-1] // policy.size
    return x.narrow(-1, policy.rank * n, n)


def copy_in_all(xs: list, policy: ShardingPolicy) -> list:
    """:func:`copy_in` of each of ``xs`` (tensors of one shape), their
    gradients all-reduced together in one collective."""
    if not policy.active:
        return list(xs)
    return list(copy_in(torch.stack(xs), policy).unbind(0))


def split_features(x: torch.Tensor,
                   policy: ShardingPolicy) -> torch.Tensor:
    """This rank's slice of a whole ``x`` every rank computes alike,
    along its last axis; its gradient, all-gathered, is whole and equal
    on every rank."""
    return _SplitFeatures.apply(x, policy.mesh) if policy.active else x


def gather_whole(x: torch.Tensor, policy: ShardingPolicy) -> torch.Tensor:
    """The model group's slices of ``x`` along its last axis, whole, for
    work every rank does alike (its gradient: this rank's slice)."""
    return _GatherWhole.apply(x, policy.mesh) if policy.active else x


def _local_ids(ids: torch.Tensor, n_local: int, policy: ShardingPolicy):
    """(the ids shifted to this rank's rows and clamped into them, which
    of them fall there)."""
    local = ids.to(torch.int64) - policy.rank * n_local
    inside = (local >= 0) & (local < n_local)
    return torch.where(inside, local, torch.zeros_like(local)), inside


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor,
                policy: ShardingPolicy) -> torch.Tensor:
    """Rows of a table whose vocab the model group splits (``table`` is
    this rank's [V / M, d] slice): each rank looks up the tokens among
    its rows, zeros elsewhere, and the sum over the group is the lookup
    (one nonzero term a token: exact in any dtype)."""
    local, inside = _local_ids(tokens, table.shape[0], policy)
    rows = table[local]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_out(rows, policy)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor,
              policy: ShardingPolicy) -> torch.Tensor:
    """The summed negative log-likelihood of ``labels`` under float32
    logits whose vocab the model group splits ([..., V / M] on this
    rank): log-sum-exp from the group's max (a constant shift: no
    gradient) and its summed exponentials, minus the gold logit from
    the rank that holds it; every rank returns the same loss."""
    m = policy.mesh.all_reduce_max(logits.detach().amax(dim=-1),
                                   over="model")
    s = reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), policy)
    local, inside = _local_ids(labels, logits.shape[-1], policy)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = reduce_out(torch.where(inside, gold, torch.zeros_like(gold)),
                      policy)
    return (torch.log(s) + m - gold).sum()
