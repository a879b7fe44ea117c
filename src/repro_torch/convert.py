"""Parameters between the JAX package's layout and the port's tensors.

The JAX package holds an MLP as a list of ``{"w", "b"}`` arrays and a zoo
model as a nested dict; after ``jax.device_get`` they are numpy arrays,
which is what these functions take and give.  This module does not import
jax.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(layers: Sequence[dict],
                      device: DeviceLike = None) -> List[dict]:
    """``[{"w", "b"}]`` numpy arrays -> f32 tensors on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
             for k, v in p.items()} for p in layers]


def params_to_numpy(layers: Sequence[dict]) -> List[dict]:
    """The port's ``[{"w", "b"}]`` tensors -> numpy f32 arrays."""
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in layers]


# ---------------------------------------------------------------------------
# The sharded error-feedback state
# ---------------------------------------------------------------------------

def _zip_map(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure (dicts,
    lists, tuples)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def qstate_shard_from_numpy(tree, shard: int, device: DeviceLike = None,
                            axis: int = 1):
    """The reference's sharded int8 error-feedback state, a tree of numpy
    leaves with the shard axis at ``axis`` (its mesh campaign's (S,
    n_shards, …), or ``axis=0`` for one round's (n_shards, …); ``{param
    index: layers}``), -> client shard ``shard``'s residual as the port's
    rank keeps it: f32 tensors on ``device``."""
    dev = resolve_device(device)
    return _zip_map(lambda a: torch.tensor(np.take(np.asarray(a), shard,
                                                   axis=axis),
                                           dtype=torch.float32, device=dev),
                    tree)


def qstate_shards_to_numpy(per_rank: Sequence, axis: int = 1):
    """The ranks' residuals (rank order, each a tree of tensors) -> the
    reference's gathered layout, numpy leaves stacked on ``axis`` ((S,
    n_shards, …) for the campaign's seed-stacked state)."""
    return _zip_map(lambda *leaves: np.stack(
        [t.detach().cpu().numpy() for t in leaves], axis=axis), *per_rank)


# ---------------------------------------------------------------------------
# Model-zoo parameter trees
# ---------------------------------------------------------------------------

def layer_stacks(cfg) -> Dict[str, Tuple[int, ...]]:
    """The JAX tree's stacked subtrees and their leading dims: the layers of
    ``lax.scan``, which the port keeps as a list of modules.  What lies
    inside a layer keeps its dims (an MoE layer's ``(E, …)`` expert
    stacks), and the single blocks (``mtp_block``, Zamba2's ``shared``)
    are not stacked."""
    if cfg.family in ("dense", "vlm", "moe", "ssm"):
        return {"layers": (cfg.n_layers,)}
    if cfg.family == "hybrid":
        group = cfg.shared_attn_every or cfg.n_layers
        return {"mamba": (cfg.n_layers // group, group)}
    if cfg.family == "audio":
        return {"enc_layers": (cfg.enc_layers,),
                "dec_layers": (cfg.n_layers,)}
    raise ValueError(f"unsupported family {cfg.family!r} for the transformer "
                     f"zoo")


def _leaves(tree: dict, prefix: Tuple[str, ...] = (),
            is_leaf=lambda v: not isinstance(v, dict)
            ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for name, value in tree.items():
        if is_leaf(value):
            yield prefix + (name,), value
        else:
            yield from _leaves(value, prefix + (name,), is_leaf)


def _tensor(leaf, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype.  numpy has no bfloat16:
    a JAX bf16 leaf arrives with the ``ml_dtypes`` dtype, which torch does
    not take, so it goes through float32 (exact) and back to bfloat16."""
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy; bf16 as float32 (numpy has no
    bfloat16; exact)."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _split(cfg, tree: dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A JAX tree of stacked leaves -> the port's per-layer names."""
    stacks = layer_stacks(cfg)
    out = {}
    for path, leaf in _leaves(tree):
        t = _tensor(leaf, dev)
        dims = stacks.get(path[0])
        if dims is None:
            out[".".join(path)] = t
            continue
        if tuple(t.shape[:len(dims)]) != dims:
            raise ValueError(f"{'.'.join(path)}: leading dims "
                             f"{tuple(t.shape)} are not {dims}")
        t = t.reshape((-1,) + tuple(t.shape[len(dims):]))
        for i in range(t.shape[0]):
            out[".".join((path[0], str(i)) + path[1:])] = t[i]
    return out


def _stack(cfg, named) -> dict:
    """The port's per-layer (name, tensor) pairs -> the JAX tree, stacked
    as JAX stacks it (numpy leaves)."""
    stacks = layer_stacks(cfg)
    tree: dict = {}
    stacked: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for key, t in named:
        a = _numpy(t)
        parts = key.split(".")
        if parts[0] in stacks:
            stacked.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = a
        else:
            _put(tree, parts, a)
    for path, by_layer in stacked.items():
        arr = np.stack([by_layer[i] for i in range(len(by_layer))])
        _put(tree, path, arr.reshape(stacks[path[0]] + arr.shape[1:]))
    return tree


def model_params_from_numpy(cfg, tree: dict,
                            device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A JAX zoo model's parameter tree (numpy leaves) -> the port model's
    state dict, for ``model.load_state_dict``.  Stacked layer leaves are
    split on their leading dim (Zamba2's ``(n_groups, group, …)`` leaves
    flattened first); each leaf keeps its dtype."""
    return _split(cfg, tree, resolve_device(device))


def model_params_to_numpy(model) -> dict:
    """The port model's parameters -> the JAX package's tree, stacked as
    JAX stacks them.  bf16 leaves come back as float32 (numpy has no
    bfloat16; the values are exact)."""
    return _stack(model.cfg, model.state_dict().items())


# ---------------------------------------------------------------------------
# Optimizer states (repro_torch.optim.optimizers)
# ---------------------------------------------------------------------------

def _is_factored(v) -> bool:
    return isinstance(v, dict) and ("v" in v or "vr" in v)


def opt_state_from_numpy(cfg, optimizer: str, tree,
                         device: DeviceLike = None) -> dict:
    """The reference optimizer's state of a zoo model (numpy leaves, the
    layers stacked) -> the port's: ``sgd``'s momentum tree (``()`` without
    momentum) and ``adamw``'s ``{"m", "v"}`` trees split per layer like the
    parameters, ``adafactor``'s ``{"vr", "vc"}`` / ``{"v"}`` leaves keyed by
    the reference leaf path (``"layers.attn.wq"``) in the reference's
    shapes.  All f32."""
    dev = resolve_device(device)
    if optimizer == "sgd":
        return _split(cfg, tree, dev) if len(tree) else {}
    if optimizer == "adamw":
        return {k: _split(cfg, tree[k], dev) for k in ("m", "v")}
    if optimizer == "adafactor":
        return {".".join(path): {k: _tensor(a, dev) for k, a in s.items()}
                for path, s in _leaves(tree, is_leaf=_is_factored)}
    raise ValueError(optimizer)


def opt_state_to_numpy(cfg, optimizer: str, state: dict):
    """The port's optimizer state -> the reference's tree (numpy leaves),
    the inverse of ``opt_state_from_numpy``."""
    if optimizer == "sgd":
        return _stack(cfg, state.items()) if state else ()
    if optimizer == "adamw":
        return {k: _stack(cfg, state[k].items()) for k in ("m", "v")}
    if optimizer == "adafactor":
        tree: dict = {}
        for leaf, s in state.items():
            _put(tree, leaf.split("."), {k: _numpy(t) for k, t in s.items()})
        return tree
    raise ValueError(optimizer)


def _put(tree: dict, path: Sequence[str], value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value
