"""elasticsearch_tpu_torch — the PyTorch / CUDA port of elasticsearch_tpu.

The same search engine, served on an NVIDIA GPU (Hopper, ``sm_90a``):
columnar segments live on the card as torch tensors, and the scoring and
top-k work of a query runs in hand-written CUDA kernels (``csrc/``) built
with ``nvcc`` at first use and bound through ``ctypes``. Every module
mirrors its counterpart in ``elasticsearch_tpu`` (the JAX package, kept as
the reference) under the same path; the port imports neither JAX nor the
JAX package.

Entry points place tensors on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper runs the kernel's
plain PyTorch version, which is what the CPU tests compare against the
JAX package.
"""

__version__ = "0.1.0"

from elasticsearch_tpu_torch.common.versioning import Version, CURRENT_VERSION

__all__ = ["Version", "CURRENT_VERSION", "__version__"]
