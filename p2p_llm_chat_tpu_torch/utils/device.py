"""The port's device rule, in one place.

Entry points run on the card unless the caller asks for the CPU: an
explicit ``device`` argument wins, then ``SERVE_DEVICE``, else ``cuda``.
Asking for ``cuda`` on a machine without one raises instead of quietly
falling back — a CPU run must never be mistaken for a card run.
"""

from __future__ import annotations

from typing import Optional

import torch

from .env import env_or


def resolve_device(device: Optional[str | torch.device] = None
                   ) -> torch.device:
    dev = torch.device(device if device is not None
                       else env_or("SERVE_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or set "
            "SERVE_DEVICE=cpu) to run on the CPU explicitly")
    return dev
