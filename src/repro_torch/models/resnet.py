"""ResNet (He et al. 2016) — the paper's non-convex experiment model
family (ResNet-50 on ImageNet in Section 5.1).  A port of
``repro.models.resnet``.

The parameter layout is ``repro``'s, so the two packages exchange
weights as they are (``repro_torch.convert``): images are
``[B, H, W, C]`` and conv weights HWIO.  ``forward`` permutes to
PyTorch's NCHW / OIHW inside.  Normalization is GroupNorm (``repro``'s
documented substitution for BatchNorm: stateless and batch-size
independent at per-worker batch sizes).  Convolutions pad as XLA's
``"SAME"`` does — for a stride-2 3x3 conv on an even input that is 0
before and 1 after, which ``nn.Conv2d(padding=1)`` does not reproduce —
so the pads are computed and applied explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import as_tensor, resolve_device
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet"
    stage_sizes: Sequence[int] = (2, 2, 2, 2)   # resnet18
    bottleneck: bool = False                    # True => resnet50-style
    width: int = 64
    num_classes: int = 10
    in_channels: int = 3
    groups: int = 8
    param_dtype: str = "float32"
    stem_stride: int = 1                        # 1 for CIFAR-size inputs

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def resnet50_config(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig(name="resnet50", stage_sizes=(3, 4, 6, 3),
                        bottleneck=True, num_classes=num_classes,
                        stem_stride=2)


def init_params(gen: torch.Generator, cfg: ResNetConfig, device=None):
    """Random parameters (He-normal convs, unit GroupNorm) drawn from
    ``gen``, in ``repro``'s tree layout, on ``device`` (default cuda)."""
    device = resolve_device(device)
    dt = cfg.pdtype

    def conv(k, cin, cout):
        return dense_init(gen, (k, k, cin, cout), dt,
                          scale=(2.0 / (k * k * cin)) ** 0.5, device=device)

    def gn(c):
        return {"scale": torch.ones(c, dtype=dt, device=device),
                "bias": torch.zeros(c, dtype=dt, device=device)}

    w = cfg.width
    params = {"stem": {"conv": conv(3, cfg.in_channels, w), "gn": gn(w)},
              "stages": []}
    cin = w
    for si, n in enumerate(cfg.stage_sizes):
        cout = w * (2 ** si)
        blocks = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            if cfg.bottleneck:
                cexp = cout * 4
                blk = {"conv1": conv(1, cin, cout), "gn1": gn(cout),
                       "conv2": conv(3, cout, cout), "gn2": gn(cout),
                       "conv3": conv(1, cout, cexp), "gn3": gn(cexp)}
                if cin != cexp or stride != 1:
                    blk["proj"] = conv(1, cin, cexp)
                cin = cexp
            else:
                blk = {"conv1": conv(3, cin, cout), "gn1": gn(cout),
                       "conv2": conv(3, cout, cout), "gn2": gn(cout)}
                if cin != cout or stride != 1:
                    blk["proj"] = conv(1, cin, cout)
                cin = cout
            blocks.append(blk)
        params["stages"].append(blocks)
    params["head"] = dense_init(gen, (cin, cfg.num_classes), dt,
                                device=device)
    params["head_b"] = torch.zeros(cfg.num_classes, dtype=dt, device=device)
    return params


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: [B, C, H, W]; w: HWIO."""
    top, bottom = same_pads(x.shape[2], w.shape[0], stride)
    left, right = same_pads(x.shape[3], w.shape[1], stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, p, groups: int) -> torch.Tensor:
    c = x.shape[1]
    g = min(groups, c)
    out = F.group_norm(x.to(torch.float32), g, p["scale"], p["bias"],
                       eps=1e-5)
    return out.to(x.dtype)


def _block(x, blk, cfg: ResNetConfig, stride: int):
    r = x
    if cfg.bottleneck:
        y = F.relu(_gn(_conv(x, blk["conv1"]), blk["gn1"], cfg.groups))
        y = F.relu(_gn(_conv(y, blk["conv2"], stride), blk["gn2"],
                       cfg.groups))
        y = _gn(_conv(y, blk["conv3"]), blk["gn3"], cfg.groups)
    else:
        y = F.relu(_gn(_conv(x, blk["conv1"], stride), blk["gn1"],
                       cfg.groups))
        y = _gn(_conv(y, blk["conv2"]), blk["gn2"], cfg.groups)
    if "proj" in blk:
        r = _conv(x, blk["proj"], stride)
    return F.relu(y + r)


def forward(params, images, cfg: ResNetConfig) -> torch.Tensor:
    """images: [B, H, W, C] -> logits [B, num_classes] (float32)."""
    dev = params["head"].device
    x = as_tensor(images, dev).to(cfg.pdtype).permute(0, 3, 1, 2)
    x = _conv(x, params["stem"]["conv"], cfg.stem_stride)
    x = F.relu(_gn(x, params["stem"]["gn"], cfg.groups))
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _block(x, blk, cfg, stride)
    x = x.mean(dim=(2, 3))
    return (x @ params["head"] + params["head_b"]).to(torch.float32)


def loss_fn(params, batch, cfg: ResNetConfig):
    logits = forward(params, batch["images"], cfg)
    labels = as_tensor(batch["labels"], logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    loss = (lse - gold).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"accuracy": acc}
