"""Where the port's tensors live: on the card unless the caller asks for the
host.

Every public entry point takes ``device`` with the default ``"cuda"`` and
resolves it here. Without a CUDA device it raises instead of carrying on
with the plain-PyTorch versions on the host, which would run none of the
hand-written kernels and say nothing about it.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str = DEFAULT_DEVICE) -> torch.device:
    """`torch.device(device)`, refusing a CUDA device when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev
