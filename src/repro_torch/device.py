"""Where the port's entry points put their work.

The port runs on the card: every entry point that allocates state
(``engine.init``, ``train``, model initializers) resolves its ``device``
argument here, defaulting to ``cuda``.  Asking for ``cuda`` on a machine
without one raises instead of quietly running on the CPU; the tests ask
for ``"cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def as_tensor(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """numpy array / tensor / scalar -> tensor on ``device`` (dtype kept)."""
    if isinstance(x, torch.Tensor):
        return x.to(device) if device is not None else x
    return torch.as_tensor(x, device=device)
