"""Parameter specs for the ``model`` axis (``specs.py``)."""

from repro_torch.sharding.specs import is_spec, param_specs, sanitize_spec

__all__ = ["is_spec", "param_specs", "sanitize_spec"]
