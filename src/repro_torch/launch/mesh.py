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

The production meshes of the dry-runs (``make_production_mesh``: 16 × 16
``("data", "model")`` or 2 × 16 × 16 ``("pod", "data", "model")``) stand
over a FAKE world (``make_fake_world``): rank 0 of 256 or 512 ranks of
``torch.testing``'s ``"fake"`` backend, whose collectives return at once
and move nothing.  One process then runs rank 0's share of a sharded
program, and ``repro_torch.roofline.analysis`` records its collectives and
counts its work: the counterpart of the JAX package's lowering onto fake
XLA CPU devices.  A process group is process-global, so a dry-run is a
process of its own.

The card's constants for the roofline (one H100 SXM5 80 GB, NVIDIA's data
sheet) have their one home here.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

# ---------------------------------------------------------------------------
# One H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet)
# ---------------------------------------------------------------------------
PEAK_BYTES = 3.35e12       # HBM3 bytes/s
PEAK_FP32 = 67e12          # FP32 FLOP/s, CUDA cores (no tensor cores)
PEAK_BF16 = 989e12         # dense BF16 FLOP/s, tensor cores
PEAK_TF32 = 495e12         # dense TF32 FLOP/s, tensor cores
# f32-accurate products on the tensor cores take three TF32 products each
# (3xTF32): the least time of f32 matrix work is its operations at this rate
PEAK_F32_MMA = PEAK_TF32 / 3
HBM_BYTES = 80e9           # device memory
# NVLink 4: 900 GB/s a GPU, both directions together; a ring sends one way
NVLINK_BW = 450e9          # bytes/s, one direction
# ConnectX-7 NDR InfiniBand, one 400 Gb/s port a GPU (DGX / HGX H100)
INTER_NODE_BW = 50e9       # bytes/s, one direction
GPUS_PER_NODE = 8          # an HGX H100 board: 8 GPUs joined by NVLink


def make_fake_world(n: int) -> None:
    """Rank 0 of a fake process group of ``n`` ranks (the ``"fake"``
    backend of ``torch.testing._internal.distributed.fake_pg``): its
    collectives return at once and move nothing.  Does nothing when this
    process already has a fake world of ``n`` ranks; raises when it has
    another process group."""
    if dist.is_initialized():
        backend = str(dist.get_backend()).lower()
        if backend != "fake" or dist.get_world_size() != int(n):
            raise RuntimeError(f"this process already has a {backend!r} "
                               f"process group of {dist.get_world_size()} "
                               f"ranks; a fake world of {n} needs a process "
                               f"of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))


def make_fake_mesh(shape, names, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` (dims ``names``) over a fake world of
    as many ranks (``make_fake_world``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    make_fake_world(n)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production mesh over a fake world (``make_fake_world``): 16 × 16
    ``("data", "model")`` on 256 ranks, or 2 × 16 × 16 ``("pod", "data",
    "model")`` on 512.  ``device_type`` is where rank 0's tensors live
    (``"cuda"`` puts them on the card; the collectives still move
    nothing)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"),
                              device_type)
    return make_fake_mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh():
    """A 1 × 1 ``("data", "model")`` mesh over a fake world of one rank."""
    return make_fake_mesh((1, 1), ("data", "model"))


def make_cpu_mesh(data: int):
    """A ``data`` × 1 ``("data", "model")`` mesh of the process group's
    ranks (gloo across CPU processes, or a fake world of ``data`` ranks
    when the process has no group)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        make_fake_world(data)
    if dist.get_world_size() != int(data):
        raise ValueError(f"a ({data}, 1) mesh needs {data} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh("cpu", (int(data), 1),
                            mesh_dim_names=("data", "model"))


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
