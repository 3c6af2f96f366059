"""One compression-policy API (a port of ``repro.core.policy``;
DESIGN.md §6).

The paper describes a *family* of algorithms — Top_k, Rand_k, QSGD,
Sign, composed quantized sparsifiers, local steps — and its ResNet-50
experiments apply Top_k layer-wise; Wangni et al. show *where* the
sparsity budget lands across the model matters as much as the total.
This module is the single configuration surface for all of it:

  * :class:`OpSpec` — a serializable handle on one registered operator
    (``parse("topk:k=0.01")`` ↔ ``to_dict()``/``from_dict()`` ↔
    ``build()``), validated against ``core.operators.OP_REGISTRY`` so
    unknown names or kwargs fail loudly instead of silently becoming
    Identity;
  * :class:`PolicySpec` — ordered ``(path-regex → OpSpec)`` rules with
    first-match-wins semantics plus an optional *global budget*
    allocator that splits one total survivor count across the matched
    leaves proportional to leaf size;
  * :class:`ChannelSpec` — an uplink/downlink pair of policies (the
    two wire directions of DESIGN.md §5);
  * :func:`resolve` — turns any of the above (or a plain operator, or
    a DSL string) into the per-leaf operator tree that
    ``kernels.dispatch.compress_tree`` / ``channel_compress_tree`` and
    the engines already accept.  Because the result is an ordinary
    tree of ``CompressionOp`` leaves, heterogeneous policies compose
    with megabuffer packing for free: dispatch buckets leaves by
    operator family, one kernel launch per family per direction.

DSL grammar (round-trips through ``to_string``)::

    policy   := side ( ">>" side )?          # uplink >> downlink
    side     := item ( ";" item )*
    item     := "budget=" number             # global-budget directive
              | [ pattern "->" ] opspec      # no pattern = catch-all
    opspec   := name ( ":" kv ( "," kv )* )?
    kv       := key "=" value                # int | float | bool | str

Patterns are Python regexes matched with ``re.search`` against the
leaf's ``/``-joined path (e.g. ``layers/attn/wq``); ``|`` alternation
is available since the direction separator is ``>>``.  Examples::

    topk:k=0.01                              # catch-all Top_k, 1%
    norm|bias|ln->identity; embed|head->qsgd:s=15; .*->topk:k=0.01
    budget=0.01; mlp|attn->topk; .*->identity
    topk:k=0.01 >> topk:k=0.05               # compressed downlink
"""

from __future__ import annotations

import dataclasses
import json
import re
import warnings
from typing import Any, Optional, Tuple, Union

from repro_torch.core.operators import (
    OP_REGISTRY,
    CompressionOp,
    make_operator,
    spec_name_of,
)
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

#: DSL separators (see module docstring)
DIRECTION_SEP = ">>"
RULE_SEP = ";"
PATTERN_SEP = "->"

#: registry field name the budget allocator assigns
BUDGET_FIELD = "k"


# ---------------------------------------------------------------------------
# deprecation plumbing (shared by every policy-migration surface)
# ---------------------------------------------------------------------------


_WARNED_KEYS: set = set()


def warn_once(key: str, message: str, stacklevel: int = 3) -> None:
    """One-time (per process) DeprecationWarning — the RunConfig shims
    and the CLI legacy flags share this so warn-once semantics and
    formatting stay consistent across surfaces."""
    if key not in _WARNED_KEYS:
        warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)
        _WARNED_KEYS.add(key)


# ---------------------------------------------------------------------------
# value (de)serialization
# ---------------------------------------------------------------------------


def _parse_value(text: str):
    t = text.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _format_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return repr(v) if isinstance(v, float) else str(v)


# ---------------------------------------------------------------------------
# OpSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """A registered operator name + its configurable kwargs.

    Hashable and order-normalized, so two specs describing the same
    operator compare equal; ``build()`` constructs the operator through
    ``operators.make_operator`` (registry-validated).
    """

    name: str
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.name not in OP_REGISTRY:
            raise KeyError(
                f"unknown operator {self.name!r}; registered: "
                f"{sorted(OP_REGISTRY)}")
        object.__setattr__(self, "kwargs", tuple(sorted(self.kwargs)))
        entry = OP_REGISTRY[self.name]
        valid = entry.fields()
        for k, _ in self.kwargs:
            if k not in valid:
                raise TypeError(
                    f"operator {self.name!r} has no parameter {k!r}; "
                    f"valid: {sorted(valid)}")

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "OpSpec":
        """``"topk:k=0.01,value_bits=32"`` → OpSpec."""
        t = text.strip()
        if not t:
            raise ValueError("empty operator spec")
        name, _, rest = t.partition(":")
        kw = {}
        if rest:
            for part in rest.split(","):
                k, sep, v = part.partition("=")
                if not sep:
                    raise ValueError(
                        f"malformed operator spec {text!r}: expected "
                        f"key=value, got {part!r}")
                kw[k.strip()] = _parse_value(v)
        return cls(name.strip(), tuple(kw.items()))

    @classmethod
    def of(cls, op: CompressionOp) -> "OpSpec":
        """The spec serializing an existing operator instance (only its
        non-default, non-pinned fields are recorded)."""
        name = spec_name_of(op)
        entry = OP_REGISTRY[name]
        kw = {k: getattr(op, k) for k, default in entry.fields().items()
              if getattr(op, k) != default}
        return cls(name, tuple(kw.items()))

    # -- serialization -----------------------------------------------------
    def to_string(self) -> str:
        if not self.kwargs:
            return self.name
        kv = ",".join(f"{k}={_format_value(v)}" for k, v in self.kwargs)
        return f"{self.name}:{kv}"

    def to_dict(self) -> dict:
        return {"op": self.name, **dict(self.kwargs)}

    @classmethod
    def from_dict(cls, d: dict) -> "OpSpec":
        d = dict(d)
        name = d.pop("op")
        return cls(name, tuple(d.items()))

    # -- resolution --------------------------------------------------------
    def takes(self, field: str) -> bool:
        return field in OP_REGISTRY[self.name].fields()

    def sets(self, field: str) -> bool:
        return any(k == field for k, _ in self.kwargs)

    def build(self, **extra) -> CompressionOp:
        return make_operator(self.name, **dict(self.kwargs), **extra)


# ---------------------------------------------------------------------------
# PolicySpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One ordered rule: leaves whose path matches ``pattern`` (regex,
    ``re.search`` semantics) get ``op``.  First match wins."""

    pattern: str
    op: OpSpec

    def __post_init__(self):
        re.compile(self.pattern)  # fail at spec time, not resolve time

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Ordered path-regex rules + optional global-budget allocator.

    ``budget``: a total Top_k survivor budget shared by every leaf whose
    matching rule *takes* ``k`` but does not set it — an int is an
    absolute total count, a float in (0, 1) a fraction of the summed
    size of those leaves.  Each participating leaf i of size d_i gets
    ``k_i = max(1, round(K * d_i / Σ_j d_j))`` — the sparsity budget is
    spent proportional to leaf size (Wangni et al.).  Rules that set
    ``k`` explicitly are untouched by the allocator.
    """

    rules: Tuple[PolicyRule, ...]
    budget: Optional[Union[int, float]] = None

    def __post_init__(self):
        if not self.rules:
            raise ValueError("PolicySpec needs at least one rule")
        if self.budget is not None and not (
                isinstance(self.budget, int) and self.budget >= 1
                or isinstance(self.budget, float) and 0.0 < self.budget < 1.0):
            raise ValueError(
                f"budget must be an int count >= 1 or a fraction in "
                f"(0, 1); got {self.budget!r}")

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "PolicySpec":
        """One DSL *side* (no ``>>``): ``item (";" item)*``."""
        rules, budget = [], None
        for raw in text.split(RULE_SEP):
            item = raw.strip()
            if not item:
                continue
            if item.startswith("budget="):
                if budget is not None:
                    raise ValueError(f"duplicate budget directive in {text!r}")
                budget = _parse_value(item[len("budget="):])
                continue
            if PATTERN_SEP in item:
                pat, _, spec = item.partition(PATTERN_SEP)
                rules.append(PolicyRule(pat.strip(), OpSpec.parse(spec)))
            else:
                rules.append(PolicyRule(".*", OpSpec.parse(item)))
        return cls(tuple(rules), budget)

    @classmethod
    def catch_all(cls, op: Union[OpSpec, str, CompressionOp]) -> "PolicySpec":
        if isinstance(op, CompressionOp):
            op = OpSpec.of(op)
        elif isinstance(op, str):
            op = OpSpec.parse(op)
        return cls((PolicyRule(".*", op),))

    # -- serialization -----------------------------------------------------
    def to_string(self) -> str:
        items = []
        if self.budget is not None:
            items.append(f"budget={_format_value(self.budget)}")
        for r in self.rules:
            items.append(r.op.to_string() if r.pattern == ".*"
                         else f"{r.pattern}{PATTERN_SEP}{r.op.to_string()}")
        return RULE_SEP.join(items)

    def to_dict(self) -> dict:
        d = {"rules": [{"match": r.pattern, **r.op.to_dict()}
                       for r in self.rules]}
        if self.budget is not None:
            d["budget"] = self.budget
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PolicySpec":
        rules = []
        for rd in d["rules"]:
            rd = dict(rd)
            pat = rd.pop("match", ".*")
            rules.append(PolicyRule(pat, OpSpec.from_dict(rd)))
        return cls(tuple(rules), d.get("budget"))

    # -- resolution --------------------------------------------------------
    def match(self, path: str) -> Optional[PolicyRule]:
        for r in self.rules:
            if r.matches(path):
                return r
        return None

    def resolve(self, params) -> Any:
        """Per-leaf operator tree in ``params``' structure — the form
        ``compress_tree``/``channel_compress_tree``/``engine.make_step``
        accept.  Every leaf must match a rule; end the policy with a
        catch-all (``.*->identity``) rather than relying on a silent
        default."""
        paths, leaves, treedef = tree_paths(params)
        matched = [self.match(p) for p in paths]
        missing = [p for p, m in zip(paths, matched) if m is None]
        if missing:
            raise ValueError(
                f"policy matches no rule for leaves {missing}; add a "
                f"final catch-all rule (e.g. '.*->identity')")
        # global-budget allocation (proportional to leaf size)
        budgeted = [i for i, m in enumerate(matched)
                    if self.budget is not None
                    and m.op.takes(BUDGET_FIELD)
                    and not m.op.sets(BUDGET_FIELD)]
        k_of = {}
        if budgeted:
            sizes = [_numel(leaves[i]) for i in budgeted]
            total_d = sum(sizes)
            K = (int(self.budget) if isinstance(self.budget, int)
                 else max(1, round(self.budget * total_d)))
            for i, d_i in zip(budgeted, sizes):
                k_of[i] = max(1, min(d_i, round(K * d_i / total_d)))
        ops = []
        for i, m in enumerate(matched):
            extra = {BUDGET_FIELD: k_of[i]} if i in k_of else {}
            ops.append(m.op.build(**extra))
        return tree_unflatten(treedef, ops)


# ---------------------------------------------------------------------------
# ChannelSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """The two wire directions (DESIGN.md §5) as one spec: an uplink
    policy and an optional downlink policy (None = exact broadcast)."""

    uplink: PolicySpec
    downlink: Optional[PolicySpec] = None

    @classmethod
    def parse(cls, text: str) -> "ChannelSpec":
        parts = text.split(DIRECTION_SEP)
        if len(parts) > 2:
            raise ValueError(
                f"at most one {DIRECTION_SEP!r} (uplink >> downlink) "
                f"allowed; got {text!r}")
        up = PolicySpec.parse(parts[0])
        down = PolicySpec.parse(parts[1]) if len(parts) == 2 else None
        return cls(up, down)

    def to_string(self) -> str:
        if self.downlink is None:
            return self.uplink.to_string()
        return (f"{self.uplink.to_string()} {DIRECTION_SEP} "
                f"{self.downlink.to_string()}")

    def to_dict(self) -> dict:
        return {
            "uplink": self.uplink.to_dict(),
            "downlink": (None if self.downlink is None
                         else self.downlink.to_dict()),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ChannelSpec":
        down = d.get("downlink")
        return cls(PolicySpec.from_dict(d["uplink"]),
                   None if down is None else PolicySpec.from_dict(down))

    def resolve(self, params) -> Tuple[Any, Optional[Any]]:
        """(uplink_op_tree, downlink_op_tree | None)."""
        up = self.uplink.resolve(params)
        down = (None if self.downlink is None
                else self.downlink.resolve(params))
        return up, down


# ---------------------------------------------------------------------------
# top-level entries
# ---------------------------------------------------------------------------


PolicyLike = Union[str, OpSpec, PolicySpec, ChannelSpec, CompressionOp]


def parse(text: str) -> Union[PolicySpec, ChannelSpec]:
    """Parse a DSL string: a ChannelSpec when it carries a downlink
    side (``>>``), else a PolicySpec."""
    if DIRECTION_SEP in text:
        return ChannelSpec.parse(text)
    return PolicySpec.parse(text)


def from_dict(d: dict) -> Union[OpSpec, PolicySpec, ChannelSpec]:
    """Dispatch on the dict shape: {"uplink": ...} → ChannelSpec,
    {"rules": ...} → PolicySpec, {"op": ...} → OpSpec."""
    if "uplink" in d:
        return ChannelSpec.from_dict(d)
    if "rules" in d:
        return PolicySpec.from_dict(d)
    if "op" in d:
        return OpSpec.from_dict(d)
    raise ValueError(
        f"unrecognized policy dict (expected 'uplink', 'rules' or 'op' "
        f"key): {sorted(d)}")


def load(text: str) -> Union[PolicySpec, ChannelSpec]:
    """CLI argument form: an inline DSL string, or ``@file.json`` whose
    contents are a ``to_dict()`` serialization."""
    if text.startswith("@"):
        with open(text[1:]) as f:
            spec = from_dict(json.load(f))
        if isinstance(spec, OpSpec):
            return PolicySpec.catch_all(spec)
        return spec
    return parse(text)


def as_channel_spec(policy: PolicyLike) -> ChannelSpec:
    """Normalize any policy-like value to a ChannelSpec."""
    if isinstance(policy, str):
        policy = parse(policy)
    if isinstance(policy, CompressionOp):
        policy = PolicySpec.catch_all(policy)
    if isinstance(policy, OpSpec):
        policy = PolicySpec.catch_all(policy)
    if isinstance(policy, PolicySpec):
        policy = ChannelSpec(policy)
    if not isinstance(policy, ChannelSpec):
        raise TypeError(f"not a policy: {policy!r}")
    return policy


def resolve(policy: PolicyLike, params) -> Any:
    """One-direction resolution: any policy-like value → the per-leaf
    operator tree the engines/dispatch accept.  Plain operators (and
    operator trees) pass through untouched, so existing call sites keep
    their exact semantics."""
    if isinstance(policy, str):
        policy = parse(policy)
        if isinstance(policy, ChannelSpec):
            raise ValueError(
                "this surface takes a single direction; the '>>' downlink "
                "side belongs in a ChannelSpec-aware caller")
    if isinstance(policy, OpSpec):
        policy = PolicySpec.catch_all(policy)
    if isinstance(policy, PolicySpec):
        return policy.resolve(params)
    return policy  # CompressionOp or pre-resolved tree: pass through


# ---------------------------------------------------------------------------
# path / leaf-group helpers (shared with the per-leaf bits ledger)
# ---------------------------------------------------------------------------


def _numel(leaf) -> int:
    """Element count of a tensor or a numpy array."""
    n = getattr(leaf, "numel", None)
    return int(n()) if callable(n) else int(leaf.size)


def tree_paths(tree, is_leaf=None):
    """(paths, leaves, treedef): '/'-joined key paths per leaf, in
    flatten order (the order every compression path iterates) — the
    same strings as ``repro``'s over the same nested dicts."""
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    paths = ["/".join(str(k) for k in p) for p, _ in flat]
    leaves = [l for _, l in flat]
    return paths, leaves, treedef


def leaf_groups(tree) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Top-level leaf grouping for the per-leaf bits ledger: group names
    (first path component, sorted) and each leaf's group index, in
    flatten order."""
    paths, _, _ = tree_paths(tree)
    tops = [p.split("/")[0] if p else "<root>" for p in paths]
    names = tuple(sorted(set(tops)))
    index = {n: i for i, n in enumerate(names)}
    return names, tuple(index[t] for t in tops)
