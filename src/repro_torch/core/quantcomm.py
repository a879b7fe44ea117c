"""Wire formats of the masked-FedAvg aggregation payload; port of
``repro.core.quantcomm``.

Three formats, bound into a framework spec by ``engine.make_spec(quant=)``:

* ``none`` — f32, the round unchanged;
* ``bf16`` — the payload rounded to bfloat16 and widened back (16 wire
  bits an element, deterministic);
* ``int8`` — stochastic rounding onto a per-tensor max-abs grid of 255
  levels, with an f32 error-feedback accumulator: each round adds the
  residual it could not express last round before quantizing again, so
  ``deq + ef_new == v + ef_old`` and the error telescopes.

``int8`` is a simulated wire format, as in the reference: the values lie
on the 255-level grid but are carried as f32, and the comm models count
``wire_bits`` analytically (``engine.make_policy(quant=)`` scales S_m and
d_model_bits by ``wire_bits / 32``).

Randomness is an input: the int8 uniforms arrive as a tensor (the port
cannot reproduce JAX's threefry draws), flat over the payload's leaves in
the reference's ``jax.tree.flatten`` order (``tree_leaves``: dict keys
sorted, so a layer's ``"b"`` before its ``"w"``).  Plain tensor ops only:
the reference has no kernel here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple, Union

import torch

_WIRE_BITS = {"none": 32, "bf16": 16, "int8": 8}


@dataclass(frozen=True)
class CommQuant:
    """Wire format of the aggregation payload.  ``error_feedback`` only
    affects ``int8``; ``levels`` is the half-range of the signed grid (127:
    the symmetric int8 range [-127, 127])."""
    mode: str = "none"            # none | bf16 | int8
    error_feedback: bool = True
    levels: int = 127

    def __post_init__(self):
        if self.mode not in _WIRE_BITS:
            raise KeyError(f"unknown CommQuant mode {self.mode!r}; "
                           f"have {quant_names()}")

    @property
    def wire_bits(self) -> int:
        return _WIRE_BITS[self.mode]

    @property
    def wire_scale(self) -> float:
        """Payload size relative to f32 (multiplies bit counts)."""
        return self.wire_bits / 32.0

    @property
    def stochastic(self) -> bool:
        return self.mode == "int8"

    @property
    def stateful(self) -> bool:
        """True when rounds carry an error-feedback accumulator."""
        return self.stochastic and self.error_feedback


NONE = CommQuant()
BF16 = CommQuant(mode="bf16")
INT8 = CommQuant(mode="int8")

_NAMED = {"none": NONE, "bf16": BF16, "int8": INT8}

QuantLike = Union[None, str, CommQuant]


def quant_names() -> Tuple[str, ...]:
    return tuple(_NAMED)


def get_quant(quant: QuantLike = None) -> CommQuant:
    """Normalize ``None`` / mode name / ``CommQuant`` to a ``CommQuant``."""
    if quant is None:
        return NONE
    if isinstance(quant, str):
        try:
            return _NAMED[quant]
        except KeyError:
            raise KeyError(f"unknown CommQuant mode {quant!r}; "
                           f"have {quant_names()}") from None
    return quant


# ---------------------------------------------------------------------------
# Trees: nested dicts / lists / tuples of tensors
# ---------------------------------------------------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree.flatten`` order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees: Any) -> Any:
    """``fn`` over the matching leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def _unflatten_like(tree: Any, leaves) -> Any:
    """``tree``'s structure holding ``leaves`` (given in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


# ---------------------------------------------------------------------------
# Wire-format simulation
# ---------------------------------------------------------------------------

def _per_client(vec: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (m,) per-client vector shaped to broadcast over a (m, ...) leaf."""
    return vec.reshape((-1,) + (1,) * (like.dim() - 1))


def apply_client_gain(tree: Any, gain: torch.Tensor) -> Any:
    """Each client's payload slice (leading axis = client) times its gain:
    the wire-corruption channel of the fault scenarios."""
    return tree_map(lambda l: l * _per_client(gain, l), tree)


def clip_client_norm(tree: Any, max_norm: float) -> Any:
    """Per-client global-norm clip of an update payload (leaves (m, ...);
    the norm over everything but the client axis, summed across leaves).
    A non-finite client norm gives a non-finite scale, so NaN-poisoned
    updates stay NaN."""
    leaves = tree_leaves(tree)
    sq = sum(torch.sum(torch.square(l), dim=tuple(range(1, l.dim())))
             for l in leaves)
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(sq), min=1e-12),
                        max=1.0)
    return tree_map(lambda l: l * _per_client(scale, l), tree)


def simulate_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Every leaf rounded through ``dtype`` and widened back."""
    return tree_map(lambda v: v.to(dtype).to(v.dtype), tree)


def _sr_quantize_leaf(v: torch.Tensor, ef, u: torch.Tensor, levels: int,
                      lead: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic rounding of one payload tensor onto a max-abs grid, given
    its uniforms ``u`` (same shape, in [0, 1)).  The scale is per tensor,
    or per slice of the ``lead`` leading dims (a seed-stacked payload: each
    seed its own tensor).  Returns (dequantized wire value, new residual);
    ``deq + ef_new == v + ef_old`` up to one f32 subtraction."""
    tot = v + ef if ef is not None else v
    dims = tuple(range(lead, tot.dim()))
    amax = tot.abs().amax(dim=dims, keepdim=True) if dims else tot.abs()
    scale = torch.clamp(amax, min=1e-12) / levels
    q = torch.clamp(torch.floor(tot / scale + u), -levels, levels)
    deq = q * scale
    return deq, tot - deq


def n_elements(tree: Any, lead: int = 0) -> int:
    """Uniforms ``fake_quant_int8`` takes for ``tree`` (per slice of the
    ``lead`` leading dims)."""
    return sum(l[(0,) * lead].numel() for l in tree_leaves(tree))


def fake_quant_int8(tree: Any, state: Any, uniforms: torch.Tensor,
                    quant: CommQuant, lead: int = 0) -> Tuple[Any, Any]:
    """Quantize a payload tree to the int8 wire grid (stochastic rounding,
    per-tensor scale, optional error feedback).

    ``uniforms``: f32 in [0, 1), ``(*lead dims, n_elements(tree, lead))``,
    consumed leaf by leaf in ``tree_leaves`` order (the reference draws one
    key per leaf in that order).  ``state``: the EF accumulator, shaped like
    ``tree`` (``()`` when ``quant.stateful`` is False).  ``lead`` leading
    dims of every leaf are independent payloads with a scale each (the
    folded seeds of the campaign's round).  Returns the dequantized payload
    and the new state."""
    total = n_elements(tree, lead)
    if uniforms.shape[-1] != total:
        raise ValueError(f"{uniforms.shape[-1]} uniforms for a payload of "
                         f"{total} elements")
    leaves = tree_leaves(tree)
    efs = tree_leaves(state) if quant.stateful else [None] * len(leaves)
    out, new_ef, at = [], [], 0
    for leaf, ef in zip(leaves, efs):
        n = leaf[(0,) * lead].numel()
        u = uniforms[..., at:at + n].reshape(leaf.shape)
        at += n
        deq, resid = _sr_quantize_leaf(leaf, ef, u, quant.levels, lead)
        out.append(deq)
        new_ef.append(resid)
    new_state = _unflatten_like(tree, new_ef) if quant.stateful else state
    return _unflatten_like(tree, out), new_state
