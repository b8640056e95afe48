"""Device mesh and the collective plane's collectives.

Counterpart of ``elasticsearch_tpu/parallel/mesh.py``. The JAX package lays
its devices out as a ``("dp", "shard")`` ``jax.sharding.Mesh`` and runs the
plane as one ``shard_map`` program whose ``all_gather`` / ``psum`` ride the
interconnect. Here a :class:`Mesh` is the same grid of devices plus a
``torch.distributed`` process group over them, one rank a device, and the
collectives are plain functions over that group (:meth:`Mesh.all_gather`,
:meth:`Mesh.psum`, :meth:`Mesh.shard_index`): NCCL on CUDA devices, gloo on
the CPU. The group is made over a store the caller names, or, for a mesh of
one rank, over an in-process ``HashStore`` with no network.

``shard_map_compat`` has no counterpart: the port runs each rank's local
step eagerly. Several ranks in one process are not served; a mesh of
several ranks (one process each, ``store`` and ``rank`` given) takes
``dp = 1``.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, NotPortedError)


def valid_geometries(n: int) -> list:
    """Every dp×shard factorization of ``n`` devices, dp ascending."""
    return [(d, n // d) for d in range(1, n + 1) if n % d == 0]


class Mesh:
    """A ``("dp", "shard")`` grid of devices (one rank each) and the
    process group over them. ``rank`` is this process's rank; its device is
    ``devices.flat[rank]``."""

    axis_names = ("dp", "shard")

    def __init__(self, devices: np.ndarray, group, rank: int):
        self.devices = devices
        self.group = group
        self.rank = int(rank)
        self.shape = {"dp": int(devices.shape[0]),
                      "shard": int(devices.shape[1])}

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]

    @property
    def backend(self) -> str:
        return "nccl" if self.device.type == "cuda" else "gloo"

    def shard_index(self) -> int:
        """This rank's index along the ``shard`` axis (``lax.axis_index``)."""
        return self.rank % self.shape["shard"]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather`` along the shard axis → [shard, *t.shape], the
        shards in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.group.size())]
        self.group.allgather([out], [t]).wait()
        return torch.stack(out)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` along the shard axis (a new tensor)."""
        out = t.contiguous().clone()
        self.group.allreduce([out]).wait()
        return out

    def close(self) -> None:
        """Shut the process group down (its communicator and threads)."""
        shutdown = getattr(self.group, "shutdown", None)
        if shutdown is not None:
            shutdown()


def _process_group(store, rank: int, size: int, device: torch.device):
    import torch.distributed as dist
    if store is None:
        store = dist.HashStore()
    if device.type == "cuda":
        return dist.ProcessGroupNCCL(store, rank, size)
    return dist.ProcessGroupGloo(store, rank, size)


def make_mesh(dp: int | None = None, shard: int | None = None,
              devices=None, *, device=None, store=None,
              rank: int = 0) -> Mesh:
    """A mesh over ``devices`` (one rank a device, in rank order), or over
    one ``device`` (CUDA when neither is given; raises with no card).

    With no ``store`` the mesh is one rank in this process, over an
    in-process HashStore. With a ``torch.distributed`` store, the caller is
    rank ``rank`` of ``len(devices)`` processes that each call this with
    the same store, devices and geometry; its device is ``devices[rank]``.
    """
    if devices is None:
        devices = [resolve_device(device)]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if shard is None and dp is None:
        dp = 1
        shard = n
    elif shard is None:
        if dp <= 0 or n % dp:
            raise IllegalArgumentError(
                f"mesh geometry dp={dp} does not divide {n} devices; "
                f"valid dp×shard factorizations: {valid_geometries(n)}")
        shard = n // dp
    elif dp is None:
        if shard <= 0 or n % shard:
            raise IllegalArgumentError(
                f"mesh geometry shard={shard} does not divide {n} "
                f"devices; valid dp×shard factorizations: "
                f"{valid_geometries(n)}")
        dp = n // shard
    if dp <= 0 or shard <= 0 or dp * shard != n:
        raise IllegalArgumentError(
            f"mesh geometry {dp}x{shard} != {n} devices; valid "
            f"dp×shard factorizations: {valid_geometries(n)}")
    if n > 1 and store is None:
        raise NotPortedError(
            "a mesh of several devices in one process is not ported: run "
            "one process a device, each with the same store and its rank")
    if n > 1 and dp != 1:
        raise NotPortedError("a mesh of several ranks takes dp = 1 (the "
                             "batch is not split over ranks yet)")
    if not 0 <= rank < n:
        raise IllegalArgumentError(f"rank {rank} outside a mesh of {n}")
    grid = np.empty((dp, shard), dtype=object)
    for i, d in enumerate(devices):
        grid.flat[i] = d
    return Mesh(grid, _process_group(store, rank, n, devices[rank]), rank)
