"""Softmax (multinomial logistic) regression with an l2 regularizer —
the paper's convex objective (Section 5.2).  A port of
``repro.models.softmax``:

    -(1/n) sum_i sum_j 1{b_i = j} log h_{x,z}(a_i) + (lambda/2) ||x||^2
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class SoftmaxConfig:
    name: str = "mnist_softmax"
    input_dim: int = 784
    num_classes: int = 10
    l2: float = 1e-4          # lambda; paper uses 1/n


def init_params(cfg: SoftmaxConfig, device=None):
    device = resolve_device(device)
    return {
        "x": torch.zeros((cfg.input_dim, cfg.num_classes),
                         dtype=torch.float32, device=device),
        "z": torch.zeros((cfg.num_classes,), dtype=torch.float32,
                         device=device),
    }


def forward(params, feats):
    return as_tensor(feats, params["x"].device) @ params["x"] + params["z"]


def loss_fn(params, batch, cfg: SoftmaxConfig):
    logits = forward(params, batch["features"])
    labels = as_tensor(batch["labels"], logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    nll = (lse - gold).mean()
    reg = 0.5 * cfg.l2 * (params["x"] * params["x"]).sum()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll + reg, {"accuracy": acc, "nll": nll}

