"""SGD, AdamW and Adafactor with the JAX package's formulas; twin of
``repro.optim.optimizers``.

Each factory returns ``(init, update)``:

    state = init(params)                       # params: {name: tensor}
    state = update(params, grads, state, step)  # params updated in place

``params`` and ``grads`` map the port's parameter names (a zoo model's
``named_parameters()``) to tensors; ``step`` is an int32 tensor on the
parameters' device, so the bias corrections and Adafactor's decay are f32
device scalars, as in the reference, and a step reads nothing back to the
host.  Updates run in f32 on the f32 or widened parameter and are cast back
to the parameter's dtype; the moments are f32.  torch's own classes differ
(``AdamW`` decays the weights before the update, ``Adafactor`` has no RMS
clip of the update and another ``eps``), so none is used.

The reference stacks a zoo model's layers on a leading axis (one leaf a
parameter name, ``lax.scan``); the port keeps one tensor a layer.  That is
the same optimizer for SGD and AdamW, which act elementwise, but not for
Adafactor: it factors every leaf of two or more dims, and its update clip
is the RMS of the whole leaf.  So Adafactor takes ``stacks``
(``convert.layer_stacks(cfg)``: the stacked subtrees and their leading dims),
stacks each reference leaf's per-layer tensors (``leaf_groups``) and
computes its statistics and clip over that stack.  Its state is keyed by
the reference leaf (``"layers.attn.wq"``) with the reference's shapes;
SGD's and AdamW's by the port's parameter names.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.sharding.partition import laid_out_like

Named = Mapping[str, torch.Tensor]
Stacks = Optional[Mapping[str, Tuple[int, ...]]]


def leaf_groups(names, stacks: Stacks = None
                ) -> Dict[str, Tuple[Tuple[int, ...], List[str]]]:
    """The reference's leaves over the port's parameter names: leaf path ->
    (leading dims, the names stacked on them in order).  ``layers.3.attn.wq``
    belongs to the leaf ``layers.attn.wq`` at index 3 when ``layers`` is in
    ``stacks``; a name outside them is a leaf of its own with dims ()."""
    stacks = stacks or {}
    found: Dict[str, Tuple[Tuple[int, ...], Dict[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        dims = stacks.get(parts[0])
        if dims is None:
            found[name] = ((), {0: name})
            continue
        leaf = ".".join([parts[0]] + parts[2:])
        found.setdefault(leaf, (tuple(dims), {}))[1][int(parts[1])] = name
    out = {}
    for leaf, (dims, by_index) in found.items():
        n = math.prod(dims)
        if dims and sorted(by_index) != list(range(n)):
            raise ValueError(f"{leaf}: layers {sorted(by_index)} do not "
                             f"fill the stack {dims}")
        out[leaf] = (dims, [by_index[i] for i in range(len(by_index))])
    return out


def _grad(grads: Named, name: str, p: torch.Tensor) -> torch.Tensor:
    """The gradient of ``name``; a parameter the loss does not reach has a
    zero gradient, as under ``jax.grad``."""
    g = grads.get(name)
    return torch.zeros_like(p) if g is None else g


def sgd(lr: float, momentum: float = 0.0):
    def init(params: Named) -> dict:
        if momentum == 0.0:
            return {}
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}

    @torch.no_grad()
    def update(params: Named, grads: Named, state: dict, step) -> dict:
        del step
        for n, p in params.items():
            g = _grad(grads, n, p)
            if momentum == 0.0:
                p.sub_(lr * g.to(p.dtype))
                continue
            m = state[n]
            m.mul_(momentum).add_(g.float())
            p.sub_((lr * m).to(p.dtype))
        return state

    return init, update


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params: Named) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(params: Named, grads: Named, state: dict, step) -> dict:
        t = (step + 1).float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        for n, p in params.items():
            g = _grad(grads, n, p).float()
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        return state

    return init, update


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, stacks: Stacks = None):
    """Factored second moments (row and column running averages) for the
    leaves of two or more dims, the full second moment for the others;
    leaves as the reference stacks them (``stacks``, see the module)."""

    def stacked(tensors: List[torch.Tensor], dims) -> torch.Tensor:
        if not dims:
            return tensors[0]
        return torch.stack(tensors).reshape(tuple(dims) + tensors[0].shape)

    def init(params: Named) -> dict:
        state = {}
        for leaf, (dims, names) in leaf_groups(params, stacks).items():
            p = params[names[0]]
            shape = tuple(dims) + tuple(p.shape)
            f32 = dict(dtype=torch.float32, device=p.device)
            if len(shape) >= 2:
                state[leaf] = {"vr": torch.zeros(shape[:-1], **f32),
                               "vc": torch.zeros(shape[:-2] + shape[-1:],
                                                 **f32)}
            else:
                state[leaf] = {"v": torch.zeros(shape, **f32)}
        return state

    @torch.no_grad()
    def update(params: Named, grads: Named, state: dict, step) -> dict:
        t = step.float() + 1.0
        beta = 1.0 - torch.pow(t, -decay)
        for leaf, (dims, names) in leaf_groups(params, stacks).items():
            ps = [params[n] for n in names]
            p = stacked(ps, dims)
            g = stacked([_grad(grads, n, q) for n, q in zip(names, ps)],
                        dims).float()
            g2 = g * g + eps
            s = state[leaf]
            if p.ndim >= 2:
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(-2))
                denom = torch.clamp_min(s["vr"].mean(-1, keepdim=True), eps)
                v = (s["vr"][..., None] * s["vc"][..., None, :]
                     / denom[..., None])
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                v = s["v"]
            u = g / torch.sqrt(torch.clamp_min(v, eps))  # guard f32 underflow
            norm = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp_min(norm / clip_threshold, 1.0)
            # a DTensor update laid out as its parameter, so a stack's
            # layers part without a gather
            new = laid_out_like((p.float() - lr * u).to(p.dtype), p)
            if dims:
                for q, row in zip(ps, new.reshape((-1,) + ps[0].shape)):
                    q.copy_(row)
            else:
                p.copy_(new)
        return state

    return init, update


def get_optimizer(name: str, lr: float, stacks: Stacks = None
                  ) -> Tuple[Callable, Callable]:
    """The reference's three by name (sgd with momentum 0.9); ``stacks``
    goes to Adafactor."""
    if name == "sgd":
        return sgd(lr, momentum=0.9)
    if name == "adamw":
        return adamw(lr)
    if name == "adafactor":
        return adafactor(lr, stacks=stacks)
    raise ValueError(name)
