"""Device selection and the card's identity.  Every public entry point of
the port takes an explicit device; a CUDA device without a card raises
(nothing falls back to the CPU)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (torch.cuda.is_available() "
                           "is false)")


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def put(a, device) -> torch.Tensor:
    """A host array as a tensor on device (on the CPU, the array itself)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def card_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (one line per card)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip()
