"""Partition rules of the model zoo; twin of ``repro.sharding.partition``.

The rules are the JAX package's, applied uniformly across the zoo:

* weight matrices (…, rows, cols): rows → the FSDP axes ("pod", "data")
  when divisible (falling back to "data" alone, then unsharded), cols →
  "model";
* vectors (norm scales, biases) replicate;
* batch dims of activations and caches → ("pod", "data"); the head dim of
  a cache → "model"; every choice is guarded by divisibility, so odd vocab
  sizes (49155) or head counts (9, 14) replicate instead of failing.

A spec is a tuple with one entry a tensor dim: None, an axis name, or a
tuple of two or more names (the entries of a JAX ``PartitionSpec``).  The rules read the
mesh's axis sizes from a ``DeviceMesh`` or from an ordered ``{name:
size}`` mapping, so they need no process group.  ``placements`` turns a
spec into DTensor placements and ``shard_params`` / ``shard_batch`` /
``shard_cache`` apply them with ``distribute_tensor``.

The JAX package stacks a model's layers on leading dims (``lax.scan``);
the port keeps one tensor a layer (``convert.layer_stacks``).  A leaf's
path is the JAX one, ``/``-joined without the layer index
(``param_path``), so ``"experts" in path`` and ``path.endswith("w_down")``
see the reference's strings, and the rules see the port's per-layer shape.
For every leaf of two or more dims a layer that gives the reference's spec
with the stacked dims dropped.  A per-layer VECTOR differs: the reference
applies its matrix rule to the stacked (L, d) leaf, splitting the layer
dim over the FSDP axes and d over "model"; here the (d,) vector
replicates (``stacked_vector_leaves`` lists them).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Spec = Tuple[Any, ...]
MeshLike = Union[Mapping[str, int], Any]


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping, in mesh
    order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = tuple(mesh.mesh_dim_names or ())
    return {n: int(s) for n, s in zip(names, mesh.mesh.shape)}


def _axis_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fsdp_axes(sizes: Dict[str, int]) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in sizes else ("data",)


def _pick(dim: int, sizes: Dict[str, int], candidates: Sequence):
    """First candidate axis (or axis group) that divides ``dim``; a group
    of one axis is that axis's name (as ``PartitionSpec`` writes it)."""
    for c in candidates:
        n = _axis_size(sizes, c)
        if n > 1 and dim % n == 0:
            return c[0] if isinstance(c, tuple) and len(c) == 1 else c
    return None


def param_spec(path: str, shape: Sequence[int], mesh: MeshLike, *,
               fsdp: bool = True, expert_parallel=False) -> Spec:
    """Spec of one parameter (``path``: the reference's ``/``-joined
    tree keys; ``shape``: the port's per-layer shape).

    ``expert_parallel``: shard the EXPERT dim of the MoE weights
    (…, E, d_in, d_out) on "model" instead of the per-expert d_out (each
    rank owns E/|model| whole experts); ``"megatron"`` also splits d_ff on
    "data" (column-parallel w_gate / w_up, row-parallel w_down)."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    if nd <= 1:
        return (None,) * nd
    spec: list = [None] * nd
    rows, cols = nd - 2, nd - 1
    row_cands = [_fsdp_axes(sizes), "data"] if fsdp else []
    if expert_parallel and "experts" in path and nd >= 3:
        spec[nd - 3] = _pick(shape[nd - 3], sizes, ["model"])
        if expert_parallel == "megatron":
            if path.endswith("w_down"):
                spec[rows] = _pick(shape[rows], sizes, ["data"])
            else:
                spec[cols] = _pick(shape[cols], sizes, ["data"])
            return tuple(spec)
        spec[rows] = _pick(shape[rows], sizes, row_cands)
        return tuple(spec)
    spec[rows] = _pick(shape[rows], sizes, row_cands)
    spec[cols] = _pick(shape[cols], sizes, ["model"])
    return tuple(spec)


def batch_spec(shape: Sequence[int], mesh: MeshLike, *,
               dp_over_model: bool = False) -> Spec:
    """Activations and token batches: dim 0 is the global batch.
    ``dp_over_model`` also spreads it over "model" (pure data
    parallelism)."""
    sizes = axis_sizes(mesh)
    spec: list = [None] * len(shape)
    fs = _fsdp_axes(sizes)
    cands = ([fs + ("model",), fs, "data"] if dp_over_model
             else [fs, "data"])
    spec[0] = _pick(shape[0], sizes, cands)
    return tuple(spec)


def cache_spec(shape: Sequence[int], mesh: MeshLike) -> Spec:
    """One layer's KV or state cache: dim 0 is the batch, and of three or
    more dims the one before last (the heads of (b, window, kv_heads,
    head_dim)) goes on "model" when it divides.  The reference's rule on
    its stacked (L, …) leaves, the layer dim dropped."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    spec: list = [None] * nd
    if nd >= 1:
        spec[0] = _pick(shape[0], sizes, [_fsdp_axes(sizes), "data"])
    if nd >= 3:
        spec[nd - 2] = _pick(shape[nd - 2], sizes, ["model"])
    return tuple(spec)


def replicated(ndim: int = 0) -> Spec:
    """The spec of a replicated tensor of ``ndim`` dims."""
    return (None,) * ndim


# ---------------------------------------------------------------------------
# Paths of the port's parameters
# ---------------------------------------------------------------------------

def param_path(cfg, name: str) -> str:
    """The reference's ``/``-joined leaf path of a port state-dict key:
    ``layers.3.attn.wq`` → ``layers/attn/wq`` (the layer index is the
    reference's stacked leading dim, ``convert.layer_stacks``)."""
    from repro_torch.convert import layer_stacks
    parts = name.split(".")
    if parts[0] in layer_stacks(cfg):
        parts = [parts[0]] + parts[2:]
    return "/".join(parts)


def stacked_vector_leaves(cfg, named) -> Dict[str, Tuple[int, ...]]:
    """The per-layer vectors among ``named`` ((key, tensor) pairs), keyed
    by their reference path, with the reference's stacked shape: the
    leaves whose spec differs from the reference's (module docstring)."""
    from repro_torch.convert import layer_stacks
    stacks = layer_stacks(cfg)
    out = {}
    for key, t in named:
        head = key.split(".")[0]
        if head in stacks and t.dim() <= 1:
            out[param_path(cfg, key)] = tuple(stacks[head]) + tuple(t.shape)
    return out


def param_specs(cfg, named, mesh: MeshLike, *, fsdp: bool = True,
                expert_parallel=False) -> Dict[str, Spec]:
    """``{state-dict key: spec}`` of a model's parameters."""
    return {key: param_spec(param_path(cfg, key), tuple(t.shape), mesh,
                            fsdp=fsdp, expert_parallel=expert_parallel)
            for key, t in named}


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): one a
    mesh dim, ``Shard(d)`` for each axis that splits tensor dim d, else
    ``Replicate()``.  A dim split over ("pod", "data") takes two
    ``Shard(d)``, pod outer and data inner, the row-major order of JAX."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} splits two dims of "
                                 f"{spec}")
            out[i] = Shard(d)
    return out


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``t`` as a DTensor laid out by ``spec`` on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh))


def shard_params(model, mesh, *, fsdp: bool = True, expert_parallel=False,
                 specs: Optional[Dict[str, Spec]] = None) -> Dict[str, Spec]:
    """Replace every parameter of ``model`` by a DTensor laid out by the
    param rules (or by ``specs``, ``{key: spec}``), in place; returns the
    specs.  The gradients stay as they were (off until a train step's
    ``init_state``)."""
    named = list(model.named_parameters())
    if specs is None:
        specs = param_specs(model.cfg, named, mesh, fsdp=fsdp,
                            expert_parallel=expert_parallel)
    for key, p in named:
        mod = model.get_submodule(key.rpartition(".")[0]) if "." in key \
            else model
        leaf = key.rpartition(".")[2]
        mod.register_parameter(leaf, torch.nn.Parameter(
            distribute(p.detach(), specs[key], mesh),
            requires_grad=p.requires_grad))
    return specs


def shard_batch(batch: Dict[str, torch.Tensor], mesh, *,
                dp_over_model: bool = False) -> Dict[str, Any]:
    """Every array of a batch as a DTensor split on its batch dim."""
    return {k: distribute(v, batch_spec(tuple(v.shape), mesh,
                                        dp_over_model=dp_over_model), mesh)
            for k, v in batch.items()}


def shard_cache(cache, mesh):
    """A model's decode cache (lists of per-layer NamedTuples, or dicts of
    them) with every tensor a DTensor laid out by ``cache_spec``; host
    integers stay as they are."""
    if isinstance(cache, torch.Tensor):
        return distribute(cache, cache_spec(tuple(cache.shape), mesh), mesh)
    if isinstance(cache, dict):
        return {k: shard_cache(v, mesh) for k, v in cache.items()}
    if isinstance(cache, list):
        return [shard_cache(v, mesh) for v in cache]
    if isinstance(cache, tuple) and hasattr(cache, "_fields"):
        return type(cache)(*(shard_cache(v, mesh) for v in cache))
    return cache
