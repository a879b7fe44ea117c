"""The client mesh of the sharded rounds: a ``torch.distributed`` device
mesh standing in for the JAX ``Mesh`` of ``repro.launch.mesh``.

Clients shard over the mesh's ``data`` axis, or over ``pod`` × ``data``
(``engine.client_axes``).  Each rank of the process group is one shard: it
holds its own contiguous slab of the clients, and the masked-FedAvg payload
crosses the mesh as one all-reduce a round (``engine.all_reduce_bundle``).

The process group is the caller's: ``torch.distributed.init_process_group``
with the NCCL backend for a mesh of cards (``device_type="cuda"``, the
default) or gloo for one of CPU processes (``"cpu"``), given its address,
world size and rank (or launched by ``torch.distributed.run``, which sets
them in the environment).  A mesh is never moved to another backend or
device than the one asked for: a mismatch raises.

A gloo mesh also carries the all-reduce of CUDA tensors (gloo copies them
through the host), which is how several ranks share one card: NCCL refuses
two ranks on one device.  Such rounds cannot be captured in a CUDA graph.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_client_mesh(data: int, pod: Optional[int] = None,
                     device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``data`` client shards, ``("data",)``, or of
    ``pod`` × ``data``, ``("pod", "data")``, over every rank of the default
    process group (``pod · data`` must be its world size; rank r is shard
    r, row-major).  ``device_type`` is ``"cuda"`` (default: NCCL, and this
    rank's card is set to ``LOCAL_RANK``, else its rank modulo the cards)
    or ``"cpu"`` (gloo).  Raises for ``"cuda"`` without a card, without a
    process group, and when the group's backend is not the device
    type's."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or "cuda"
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device; none is "
                           "available")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_client_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    backend = str(dist.get_backend()).lower()
    if backend != _BACKEND[device_type]:
        raise RuntimeError(f"a {device_type!r} mesh needs the "
                           f"{_BACKEND[device_type]!r} backend, the process "
                           f"group has {backend!r}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    shape = (int(data),) if pod is None else (int(pod), int(data))
    names = ("data",) if pod is None else ("pod", "data")
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape} must be positive")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {names} mesh of shape {shape} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)
