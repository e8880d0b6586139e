"""Where an entry point runs.

The public entry points (`render`, `make_train_step`) run on the NVIDIA GPU
unless the caller names another device. There is no quiet CPU path: with no
card, a call that did not ask for the CPU raises.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means "cuda". Raises when a CUDA
    device is asked for (or implied) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the GPU unless it is "
            "given device='cpu'")
    return dev


def kind(t: torch.Tensor, what: str) -> str:
    """"cpu" or "cuda" for a tensor a kernel wrapper was given: the plain
    version runs for the first, the kernel for the second. Anything else
    raises, naming `what`."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {t.device}")
    return t.device.type
