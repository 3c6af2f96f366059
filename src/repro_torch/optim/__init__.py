from repro_torch.optim.transforms import (
    GradientTransform,
    OptState,
    adam,
    momentum_sgd,
    sgd,
    apply_updates,
    make_optimizer,
)
from repro_torch.optim.schedules import (
    constant,
    inverse_time,
    paper_convex_lr,
    piecewise_decay,
    warmup_cosine,
    warmup_piecewise,
)

__all__ = [
    "GradientTransform",
    "OptState",
    "adam",
    "momentum_sgd",
    "sgd",
    "apply_updates",
    "make_optimizer",
    "constant",
    "inverse_time",
    "paper_convex_lr",
    "piecewise_decay",
    "warmup_cosine",
    "warmup_piecewise",
]
