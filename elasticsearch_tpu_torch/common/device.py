"""Where the port's tensors live.

The port's entry points run on CUDA unless the caller names another device
(the CPU tests pass ``device="cpu"``). A CUDA request on a machine with no
card raises: the port never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "elasticsearch_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
