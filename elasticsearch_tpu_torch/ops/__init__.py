"""Device ops of the port: plain functions on tensors, each hand-written
CUDA kernel beside its plain PyTorch version (see ``cuda_build``)."""

import torch


def per_query(x, device=None) -> torch.Tensor:
    """A per-query constant shaped to broadcast against per-doc values: a
    [B] tensor (one value a query of the batch) becomes a [B, 1] column; a
    scalar stays 0-dim; the result lies on ``device`` (None: a tensor's
    own, the CPU for a scalar)."""
    t = torch.as_tensor(x, device=device)
    return t[:, None] if t.dim() == 1 else t
