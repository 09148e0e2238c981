"""Device and precision setup (counterpart of ``utils/jaxconfig.py``).

Every entry point calls :func:`setup` first.  It turns off TF32 for float32
matrix products and convolutions: CG diverged at about 1e5 dofs when the
operator contractions took reduced-precision passes, so every f32 product of
the solve runs in full IEEE f32.

The device is always chosen by the caller.  Nothing here falls back from a
card to the CPU: asking for CUDA on a machine without one raises.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

__all__ = ["setup", "card_line"]


def setup(device) -> torch.device:
    """Full-precision f32 products everywhere; returns the torch.device for
    ``device`` ("cpu", "cuda", "cuda:0", or a torch.device), raising when a
    CUDA device is asked for and none exists."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device is None:
        raise ValueError("device must be given explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda reports "
                           "no CUDA device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_line(device) -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, for a
    CUDA device; None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()
