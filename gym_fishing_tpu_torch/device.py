"""The device an entry point runs on.

Every public function of the package that takes a ``device`` passes it
through `resolve`: ``None`` means the card (the current CUDA device), and a
machine without one raises instead of carrying on on the CPU. A caller that
wants the CPU, as the CPU tests do, says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a `torch.device`; ``None`` is the current CUDA device.

    Raises `RuntimeError` when a CUDA device is asked for, by name or by
    default, and none is there.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device for device={str(device)!r} (the default is the card): "
                'pass device="cpu" to run on the CPU'
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
