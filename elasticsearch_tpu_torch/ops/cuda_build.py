"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel lives in ``elasticsearch_tpu_torch/csrc/<name>.cu`` behind a
plain C interface. At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``elasticsearch_tpu_torch/_build/`` — one shared library
per source, named by the source's content hash, so an edited source is
rebuilt and concurrent processes never load a half-written file — and bound
with ``ctypes``. Nothing here runs at import time: this module imports on a
machine with no CUDA toolkit, and only a launch on a CUDA tensor needs one.

A :class:`CudaKernel` counts its launches (``launches``) so a run can show
that the path it drove went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH = "sm_90a"


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "elasticsearch_tpu_torch need the CUDA toolkit")


def library_path(source: str) -> Path:
    """The built library for ``csrc/<source>``: keyed by its content and
    the content of the headers in ``csrc/`` (a source may include them)."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def nvcc_command(source: str, out: Path) -> list[str]:
    return [find_nvcc(), "-gencode", f"arch=compute_90a,code={ARCH}",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC_DIR / source)]


def build_libraries(sources: list[str]) -> dict[str, dict]:
    """Compile every source not built yet, all ``nvcc`` processes started
    together. → {source: {"path", "seconds", "log"}}; ``log`` is nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel),
    kept beside the library. Raises RuntimeError naming every source that
    failed to build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = []
    for source in sources:
        path = library_path(source)
        log_path = path.with_suffix(".log")
        if path.exists():
            out[source] = {"path": path, "seconds": 0.0,
                           "log": log_path.read_text()
                           if log_path.exists() else ""}
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        procs.append((source, path, log_path, tmp, time.perf_counter(),
                      subprocess.Popen(nvcc_command(source, tmp),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True)))
    failed = []
    for source, path, log_path, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source} (nvcc exit {proc.returncode}):\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, path)
        out[source] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


class CudaKernel:
    """One C entry point of one ``csrc`` source, loaded on first launch.

    ``argtypes`` follow the C signature; the stream is appended last by
    :meth:`launch`. The C function returns ``cudaGetLastError()`` after the
    launch, and a nonzero code raises here with CUDA's own message."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        self._error_string = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                path = build_libraries([self.source])[self.source]["path"]
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{Path(self.source).stem}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(*args, stream)
        if rc != 0:
            msg = self._error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{rc} ({msg})")
        with self._lock:
            self.launches += 1


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor for a ``c_void_p`` argument (None → NULL)."""
    return None if t is None else t.data_ptr()


def check_cuda(name: str, device: torch.device, **tensors) -> None:
    """Every tensor a kernel reads or writes must be contiguous and on the
    kernel's CUDA device."""
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: [{arg}] is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: [{arg}] must be contiguous")


def check_dtype(name: str, arg: str, t: torch.Tensor | None,
                dtype: torch.dtype) -> None:
    if t is not None and t.dtype != dtype:
        raise TypeError(f"{name}: [{arg}] must be {dtype}, got {t.dtype}")
