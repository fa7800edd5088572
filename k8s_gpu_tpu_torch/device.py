"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a CUDA device on a machine without CUDA
raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
