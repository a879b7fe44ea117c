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

What XLA's partitioner does on its own and eager DTensor does not, the
models ask for here, each an explicit ``redistribute`` a
``roofline.analysis.CollectiveTrace`` counts and each a no-op on a plain
tensor, so the CPU and card paths run as before: ``reshape`` gathers a
view's operand (and its gradient) where the shard cannot pass, such as 9
heads over 16 ranks; ``whole_dim`` keeps a scan's step dim whole;
``fsdp_gathered``, ``laid_out_like`` and ``replicated_like`` lay out the
MoE's expert weights and buffers and Adafactor's update.  ``sharding.rules`` holds the strategies DTensor lacks.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Spec = Tuple[Any, ...]
MeshLike = Union[Mapping[str, int], Any]


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping, in mesh
    order.  A mesh dim that holds several axes as one (the mesh's
    ``folded``, ``{dim name: {axis: size}}``: the dry-run's ("pod", "data"),
    ``launch.mesh.make_dryrun_mesh``) gives each of them."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = tuple(mesh.mesh_dim_names or ())
    folded = getattr(mesh, "folded", {})
    out: Dict[str, int] = {}
    for n, s in zip(names, mesh.mesh.shape):
        out.update(folded.get(n, {n: int(s)}))
    return out


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
    its stacked (L, …) leaves, the layer dim dropped, but for a vector:
    the ring buffer's slot positions (window,) replicate, where the
    reference's rule splits them as a batch.  XLA writes a slot of a split
    vector; DTensor loses a write into a slot of a sharded dim (it writes a
    gathered copy)."""
    sizes = axis_sizes(mesh)
    nd = len(shape)
    spec: list = [None] * nd
    if nd >= 2:
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
    ``Shard(d)``, pod outer and data inner, the row-major order of JAX, or
    one where the mesh holds the two as one dim (``axis_sizes``); a spec
    that splits one of those without the other is refused there: that
    mesh cannot lay it out."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    folded = getattr(mesh, "folded", {})
    held = [tuple(folded.get(n, (n,))) for n in names]
    out: list = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if not any(a in h for h in held)]
        if unknown:
            raise ValueError(f"{spec} names {unknown}: not an axis of the "
                             f"mesh {names}")
        for i, h in enumerate(held):
            hit = [a for a in axes if a in h]
            if not hit:
                continue
            if len(hit) != len(h):
                raise ValueError(f"{spec} splits {hit} alone: mesh dim "
                                 f"{names[i]!r} holds {h} as one")
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dim {names[i]!r} splits two dims "
                                 f"of {spec}")
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
    compute = specs
    if specs is None:
        specs = param_specs(model.cfg, named, mesh, fsdp=fsdp,
                            expert_parallel=expert_parallel)
        compute = param_specs(model.cfg, named, mesh, fsdp=False,
                              expert_parallel=expert_parallel)
    for key, p in named:
        mod = model.get_submodule(key.rpartition(".")[0]) if "." in key \
            else model
        leaf = key.rpartition(".")[2]
        q = torch.nn.Parameter(distribute(p.detach(), specs[key], mesh),
                               requires_grad=p.requires_grad)
        # the layout without FSDP's row split (``fsdp_gathered``)
        q.compute_placements = placements(compute[key], mesh)
        mod.register_parameter(leaf, q)
    return specs


def shard_batch(batch: Dict[str, torch.Tensor], mesh, *,
                dp_over_model: bool = False) -> Dict[str, Any]:
    """Every array of a batch as a DTensor split on its batch dim."""
    return {k: distribute(v, batch_spec(tuple(v.shape), mesh,
                                        dp_over_model=dp_over_model), mesh)
            for k, v in batch.items()}


def _view_groups(src: Sequence[int], dst: Sequence[int]):
    """The (input dims, output dims) groups of a reshape from ``src`` to
    ``dst``: runs of consecutive dims with equal products."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        ins, outs, a, b = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]
                ins.append(i)
                i += 1
            else:
                b *= dst[j]
                outs.append(j)
                j += 1
        groups.append((ins, outs))
    if groups:            # trailing size-1 dims join the last group
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def _uneven_for_view(x, shape: Tuple[int, ...]) -> list:
    """The mesh dims of DTensor ``x`` whose shard a view to ``shape`` cannot
    carry: DTensor keeps a shard through a view only on the first dim of a
    merge and into the first dim of a split, and only when that dim
    divides evenly; anything else it refuses (an uneven split, such as 9
    heads over 16 ranks), turns into a strided shard or, split over two
    mesh dims, gets wrong.  Of a dim split over several mesh dims the
    innermost go first, until the rest divide."""
    src = tuple(x.shape)
    sharded: Dict[int, list] = {}
    for m, p in enumerate(x.placements):
        d = getattr(p, "dim", None)
        if d is not None:
            sharded.setdefault(d, []).append(m)
    if not sharded:
        return []
    n_of = dict(zip(range(x.device_mesh.ndim), x.device_mesh.mesh.shape))
    bad = []
    for ins, outs in _view_groups(src, shape):
        ins1 = [i for i in ins if src[i] != 1]
        outs1 = [o for o in outs if shape[o] != 1]
        if len(ins1) <= 1 and len(outs1) <= 1:
            continue                      # a dim kept as it is
        for d in ins1:
            mdims = sharded.get(d, [])
            if not mdims:
                continue
            n = 1
            for m in mdims:
                n *= int(n_of[m])
            strided = any(type(x.placements[m]).__name__ == "_StridedShard"
                          for m in mdims)
            if strided or d != ins1[0] or not outs1:
                bad += mdims
                continue
            while mdims and (src[d] % n or shape[outs1[0]] % n):
                m = mdims.pop()
                n //= int(n_of[m])
                bad.append(m)
    return sorted(bad)


def _evened(x, shape: Tuple[int, ...]):
    """DTensor ``x`` gathered on the mesh dims whose shard a view to
    ``shape`` cannot carry (``_uneven_for_view``)."""
    bad = _uneven_for_view(x, shape)
    if not bad:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if m in bad else p for m, p in enumerate(x.placements)])


class _EvenView(torch.autograd.Function):
    """A DTensor view whose operand, and in the backward pass whose
    gradient, is first gathered where its shard cannot pass: DTensor lays
    a gradient out by its own choice, which the forward's layout does not
    fix."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _evened(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _evened(g, ctx.src).reshape(ctx.src), None


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor whose shard the view cannot carry
    (``_uneven_for_view``), and its gradient likewise, is first gathered on
    those mesh dims, an explicit ``redistribute`` to ``Replicate`` that a
    ``CollectiveTrace`` counts, as XLA reshards a sharded operand of such a
    reshape.  A plain tensor is reshaped as it is."""
    if not hasattr(x, "placements"):
        return x.reshape(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            known *= s if s != -1 else 1
        shape = tuple(x.numel() // known if s == -1 else s for s in shape)
    return _EvenView.apply(x, tuple(shape))


def _whole(x, dim: int):
    """DTensor ``x`` gathered on the mesh dims that shard its dim ``dim``."""
    if not any(getattr(p, "dim", None) == dim for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if getattr(p, "dim", None) == dim else p
        for p in x.placements])


class _WholeDim(torch.autograd.Function):
    """``x`` with its dim ``dim`` whole, and its gradient too."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _whole(x, dim).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.dim), None


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A scan's output (b, L, …) with its step dim ``dim`` whole, forward
    and backward, by explicit gathers a ``CollectiveTrace`` counts: the
    gradient of a stack of L steps parts in L selects, and DTensor, where
    it has split that gradient along L, gathers it whole for every one of
    them (4,096 gathers a layer of an RWKV6 train step on 32 × 16) where
    one suffices.  A plain tensor is returned as it is."""
    if not hasattr(x, "placements"):
        return x
    return _WholeDim.apply(x, dim)


def fsdp_gathered(w: torch.Tensor) -> torch.Tensor:
    """A parameter gathered on the mesh dims its FSDP row rule split (to
    the ``compute_placements`` ``shard_params`` gave it: its spec without
    FSDP, so an expert-parallel layout, such as Megatron's d_ff on "data",
    stays split): the all-gather an FSDP step runs before it uses a
    weight, by an explicit ``redistribute`` a ``CollectiveTrace`` counts.
    Left to DTensor, a batched product with a stack of expert weights
    splits the experts unevenly over "data" instead (40 over 16), which a
    later view refuses.  A plain tensor is returned as it is."""
    want = getattr(w, "compute_placements", None)
    if want is None or list(w.placements) == list(want):
        return w
    return w.redistribute(w.device_mesh, want)


def laid_out_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """DTensor ``x`` laid out as DTensor ``ref`` (an explicit
    ``redistribute`` a ``CollectiveTrace`` counts), such as an update as
    the parameter it is written into; a plain tensor as it is."""
    if not hasattr(x, "placements") or list(x.placements) == list(
            ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def replicated_like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor made from nothing (zeros, an empty buffer), as a
    DTensor replicated over ``ref``'s mesh when ``ref`` is a DTensor: the
    same on every rank, as a jitted JAX step's constants are, and a
    DTensor, so a write of DTensors into it in place keeps its layout
    (DTensor refuses one into a plain tensor).  ``t`` itself otherwise."""
    if not hasattr(ref, "placements"):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


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
