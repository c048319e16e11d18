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
    """`torch.device(device)`, refusing a CUDA device when there is none; a
    card without an index is the current one, as the tensors made on it
    report it (a wrapper built for "cuda" takes tensors on "cuda:0")."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
