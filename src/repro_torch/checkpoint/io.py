"""Checkpoints of nested trees of tensors: an npz payload and a json
manifest; port of ``repro.checkpoint.io``.

A tree is dicts, lists and tuples of tensors (the campaign's params tuple of
``[{"w", "b"}]`` layers, its ``{param index: layers}`` error-feedback state,
its metric buffers).  Its leaves are flattened to keys by path, as the
reference names them: dict keys sorted, list and tuple positions, joined by
``/`` (``params/0/0/w``).  A bf16 tensor is stored as a ``uint16`` view
(npz has no bfloat16).

Saves are atomic: each file is written to a ``.tmp`` sibling and renamed
into place with ``os.replace``, the npz first and the json manifest LAST.
The manifest is the commit point: a manifest on disk always names a
complete payload (``launch/resilience.py`` relies on it).

``restore`` writes the stored values INTO the tensors of the tree it is
given, in place: the campaign's CUDA graphs read those very tensors.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path key, tensor) of every leaf, in the reference's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}{i}/")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not a tensor")
    return [(prefix[:-1], tree)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _describe(tree: Any) -> Any:
    """The tree's structure for the manifest (leaves as ``*``)."""
    if isinstance(tree, dict):
        return {str(k): _describe(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_describe(v) for v in tree]
    return "*"


def save(path, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` to ``path``.npz and its manifest to ``path``.json
    (payload first, manifest last, each through a ``.tmp`` sibling and
    ``os.replace``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree)}
    npz = path.with_suffix(".npz")
    tmp_npz = npz.with_name(npz.stem + ".tmp.npz")
    np.savez(tmp_npz, **flat)
    os.replace(tmp_npz, npz)
    manifest_ = {
        "tree": _describe(tree),
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    man = path.with_suffix(".json")
    tmp_man = man.with_name(man.stem + ".tmp.json")
    tmp_man.write_text(json.dumps(manifest_, indent=1))
    os.replace(tmp_man, man)


def _check_keys(stored, wanted, path) -> None:
    """A ValueError naming the missing and the extra keys."""
    missing = sorted(set(wanted) - set(stored))
    extra = sorted(set(stored) - set(wanted))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path} does not match the restore structure: "
            f"missing keys {missing or '[]'}, extra keys {extra or '[]'} "
            f"(checkpoint has {len(stored)} arrays, restore tree wants "
            f"{len(wanted)})")


def restore(path, like: Any) -> Any:
    """Copy the checkpoint at ``path`` into the tensors of ``like`` (in
    place, each keeping its dtype and device) and return ``like``.  A key
    or shape mismatch raises a ValueError before any tensor is written."""
    path = Path(path)
    with np.load(path.with_suffix(".npz")) as data:
        leaves = _flatten(like)
        _check_keys(list(data.files), [k for k, _ in leaves], path)
        arrays = {k: data[k] for k, _ in leaves}
    for key, t in leaves:
        if tuple(arrays[key].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arrays[key].shape} vs {tuple(t.shape)}")
    for key, t in leaves:
        arr = arrays[key]
        if t.dtype == torch.bfloat16:
            src = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                   if arr.dtype == np.uint16
                   else torch.from_numpy(arr).to(torch.bfloat16))
        else:
            src = torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype)
        t.copy_(src)
    return like


def load_arrays(path) -> Dict[str, np.ndarray]:
    """A checkpoint's payload as a flat ``{key: array}`` dict (no tree
    needed: the campaign's metric buffers)."""
    with np.load(Path(path).with_suffix(".npz")) as data:
        return {k: data[k] for k in data.files}


def manifest(path) -> dict:
    return json.loads(Path(path).with_suffix(".json").read_text())
