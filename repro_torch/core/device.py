"""The device rule of the port's entry points.

``device=None`` means the card (``"cuda"``).  Without one the entry
points raise; they never move to the CPU on their own.  Tests and CPU
callers pass ``device="cpu"`` explicitly.  ``"meta"`` (shapes and
dtypes, no storage) is for the dry run's stand-ins
(``launch/specs.py``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
