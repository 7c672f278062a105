"""The ("dp", "tp") mesh of ranks (the JAX package's ``parallel/mesh.py``).

``dp`` shards the node rows of a batch (and, in the all-gather strategy,
its edge rows) over contiguous blocks; ``tp`` shards the output features
of the Linears whose layer has a parallelism factor above 1
(``sharding.model_p_factors``).  A rank is one process with one device:
the mesh holds a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks with dims ("dp", "tp"), the process groups of each dim, and a group
of all the mesh's ranks, which sums the gradients of replicated
parameters.

The caller initialises the process group.  NCCL serves CUDA tensors (one
rank per card); gloo serves the CPU, and CUDA tensors too when several
ranks share one card (NCCL refuses two ranks on one device): then every
collective stages its buffers through host memory (``Mesh.staging``),
because gloo's point-to-point sends take host tensors only.  The mesh's
``DeviceMesh`` is made with the device type of the backend's buffers
("cuda" under NCCL, "cpu" under gloo); the tensors live on
``Mesh.device``.

A mesh may take fewer ranks than the world (``dp * tp`` below the world
size), as ``scaling.measure_scaling`` does.  Process groups are made
collectively, so every rank of the world calls ``make_mesh`` with the
same arguments; a rank outside the mesh gets a ``Mesh`` with
``member=False``, whose collectives raise.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_multihost_mesh"]

AXES = ("dp", "tp")


class Mesh:
    """Ranks laid out [dp, tp] (``ranks``, global ranks), this rank's
    place in it (``coordinate`` or None), the ``DeviceMesh`` over them and
    the process groups of each axis (``group``) and of the whole mesh
    (``mesh_group``).  ``shape`` is {"dp": dp, "tp": tp}, as the JAX
    mesh's."""

    def __init__(self, ranks: np.ndarray, device_mesh, mesh_group,
                 device: torch.device, backend: str):
        self.ranks = ranks
        self.device_mesh = device_mesh
        self.mesh_group = mesh_group
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)
        self.coordinate = (tuple(int(c) for c in where[0]) if len(where)
                           else None)
        self.shape = {"dp": int(ranks.shape[0]), "tp": int(ranks.shape[1])}
        # gloo cannot send CUDA tensors point to point: stage on the host
        self.staging = backend == "gloo" and device.type == "cuda"

    @property
    def member(self) -> bool:
        return self.coordinate is not None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _check_member(self):
        if not self.member:
            raise RuntimeError(
                f"rank {self.rank} is not in this mesh {self.ranks.tolist()}")

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        self._check_member()
        return self.coordinate[AXES.index(axis)]

    def group_ranks(self, axis: str) -> list:
        """The global ranks of this rank's group along ``axis``, in axis
        order."""
        self._check_member()
        d, t = self.coordinate
        line = self.ranks[:, t] if axis == "dp" else self.ranks[d, :]
        return [int(r) for r in line]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._check_member()
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"ranks={self.ranks.tolist()}, device={self.device}, "
                f"backend={self.backend})")


def _local_device(device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda'): no CUDA device available; pass "
            "device_type='cpu' (with a gloo process group) for the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> Mesh:
    """A (dp, tp) mesh over the global ranks ``devices`` (default: every
    rank of the initialised process group, in rank order); ``dp`` defaults
    to the ranks / ``tp``.  ``dp * tp`` below the number of ranks takes
    the first ``dp * tp`` of them (a submesh).  Every rank of the world
    calls it.  ``device_type`` "cuda" (the default) raises without CUDA;
    "cpu" needs a gloo process group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    backend = str(dist.get_backend())
    if device_type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU mesh needs the gloo backend, not {backend}")
    if device_type == "cuda" and backend not in ("nccl", "gloo"):
        raise ValueError(f"a CUDA mesh needs NCCL or gloo, not {backend}")
    device = _local_device(device_type)
    devices = list(range(dist.get_world_size()) if devices is None
                   else devices)
    n = len(devices)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks do not split into tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"dp({dp}) * tp({tp}) > ranks({n})")
    ranks = np.asarray(devices[: dp * tp], dtype=np.int64).reshape(dp, tp)
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                    torch.as_tensor(ranks), mesh_dim_names=AXES)
    # every rank of the world takes part in making the group
    mesh_group = dist.new_group(ranks=[int(r) for r in ranks.flat])
    return Mesh(ranks, dm, mesh_group, device, backend)


def make_multihost_mesh(tp: int = 1, device_type: str = "cuda") -> Mesh:
    """A (world / tp, tp) mesh with the ranks ordered by (host, local
    rank), hosts in the order of their lowest rank: consecutive dp shards
    stay on one host, so the halo ring crosses hosts once per host seam.
    The local rank is ``LOCAL_RANK`` (as ``torchrun`` sets it), else the
    global rank.  On one host it equals ``make_mesh(tp=tp)``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh needs an initialised "
                           "process group")
    me = (socket.gethostname(),
          int(os.environ.get("LOCAL_RANK", dist.get_rank())),
          dist.get_rank())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, me)
    first = {}
    for host, _, rank in every:
        first[host] = min(first.get(host, rank), rank)
    order = sorted(every, key=lambda e: (first[e[0]], e[1], e[2]))
    n = len(order)
    if n % tp:
        raise ValueError(f"{n} ranks do not split into tp={tp}")
    return make_mesh(tp=tp, devices=[r for _, _, r in order],
                     device_type=device_type)
