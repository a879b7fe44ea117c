"""Kernel dispatch + precision policy — the switchboard between the plain
PyTorch versions and the hand-written CUDA kernels; twin of
``repro.kernels.dispatch``.

Every hot-path op with both a plain and a kernel implementation is called
THROUGH this module (``kl_loss``, ``gram``, ``gram_pair``, ``rwkv6_wkv``,
``mamba2_scan``), selected by a ``KernelPolicy``:

* a bit True — the kernel wrapper, which launches the CUDA kernel on a CUDA
  tensor and runs the plain version on a CPU tensor (inside the same
  ``autograd.Function`` for the KL, so the CPU tests exercise the
  closed-form gradient the card uses).  This is "auto";
* False — the plain PyTorch graph everywhere (the ``"reference"`` preset).

The JAX package reaches its WKV and SSD kernels through the mixers'
``use_kernel=True`` branch; the port reaches them through the policy's
``rwkv6_wkv`` / ``mamba2_scan`` bits.  Both branches compute the same
function.

Presets: ``"reference"`` (plain ops, f32) and ``"kernel"`` (kernels, f32).
``"kernel_bf16"`` and the ``BF16`` precision belong to a later slice of the
port and raise ``NotImplementedError``.  ``None`` resolves to ``"kernel"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from repro_torch.kernels.kl_mutual import ops as _kl_ops
from repro_torch.kernels.kl_mutual.ref import kl_rows_ref
from repro_torch.kernels.mamba2_scan import ops as _ssd_ops
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
from repro_torch.kernels.ridge_gram import ops as _rg_ops
from repro_torch.kernels.ridge_gram.ref import gram_ref
from repro_torch.kernels.rwkv6_wkv import ops as _wkv_ops
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref


@dataclass(frozen=True)
class Precision:
    """Activations / matmul inputs in ``compute``, accumulation and loss
    reductions in ``accum``; master parameters are always f32."""
    compute: str = "float32"
    accum: str = "float32"

    @property
    def is_mixed(self) -> bool:
        return self.compute != self.accum


F32 = Precision()
BF16 = Precision(compute="bfloat16", accum="float32")


@dataclass(frozen=True)
class KernelPolicy:
    """Per-op kernel bits + precision (f32 only in this slice)."""
    kl_mutual: bool = True
    ridge_gram: bool = True
    rwkv6_wkv: bool = True
    mamba2_scan: bool = True
    precision: Precision = F32

    def __post_init__(self):
        if self.precision.is_mixed:
            raise NotImplementedError(
                "later slice: mixed (bf16) precision is not ported yet")


REFERENCE = KernelPolicy(kl_mutual=False, ridge_gram=False, rwkv6_wkv=False,
                         mamba2_scan=False)
KERNEL = KernelPolicy()

_NAMED = {"reference": REFERENCE, "kernel": KERNEL}
_LATER = ("kernel_bf16",)

PolicyLike = Union[None, str, KernelPolicy]


def policy_names() -> tuple:
    return tuple(_NAMED)


def get_policy(policy: PolicyLike = None) -> KernelPolicy:
    """Normalize ``None`` / preset name / ``KernelPolicy``."""
    if policy is None:
        return KERNEL
    if isinstance(policy, str):
        if policy in _LATER:
            raise NotImplementedError(
                f"later slice: policy {policy!r} is not ported yet")
        try:
            return _NAMED[policy]
        except KeyError:
            raise KeyError(f"unknown kernel policy {policy!r}; "
                           f"have {policy_names()}") from None
    return policy


def kl_loss(x_feat: torch.Tensor, y_feat: torch.Tensor, *,
            temperature: float = 1.0,
            policy: PolicyLike = None) -> torch.Tensor:
    """Mean over the rows (axis -2) of D_KL(x ‖ y), y = stop-gradient
    target (the paper's eq. 5 order).  ``x_feat``/``y_feat`` are
    ``(..., rows, d)``; a stacked ``(M, B, d)`` cohort gives the ``(M,)``
    per-client losses from ONE kernel launch over all M·B rows."""
    pol = get_policy(policy)
    y = y_feat.detach()
    if pol.kl_mutual:
        d = x_feat.shape[-1]
        rows = _kl_ops.KLRows.apply(x_feat.reshape(-1, d), y.reshape(-1, d),
                                    temperature)
        rows = rows.reshape(x_feat.shape[:-1])
    else:
        rows = kl_rows_ref(x_feat, y, temperature)
    return rows.mean(-1)


def gram(x: torch.Tensor, y: torch.Tensor, *,
         policy: PolicyLike = None) -> torch.Tensor:
    """G = XᵀY with f32 accumulation (x: (n, d1), y: (n, d2))."""
    if get_policy(policy).ridge_gram:
        return _rg_ops.gram(x, y)
    return gram_ref(x, y)


def gram_pair(o: torch.Tensor, z: torch.Tensor, *,
              policy: PolicyLike = None) -> tuple:
    """(OᵀO, OᵀZ) with f32 accumulation (o: (n, d1), z: (n, d2)); one
    kernel launch for both on the card."""
    if get_policy(policy).ridge_gram:
        return _rg_ops.gram_pair(o, z)
    return gram_ref(o, o), gram_ref(o, z)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *,
              policy: PolicyLike = None) -> torch.Tensor:
    """RWKV6 WKV recurrence; r, k, v, w: (b, L, nh, P), u: (nh, P) ->
    y (b, L, nh, P) f32."""
    if get_policy(policy).rwkv6_wkv:
        return _wkv_ops.rwkv6_wkv(*(a.float().contiguous()
                                    for a in (r, k, v, w, u)))
    return rwkv6_wkv_ref(r, k, v, w, u)


def mamba2_scan(decay: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, x: torch.Tensor, *,
                policy: PolicyLike = None) -> torch.Tensor:
    """Mamba2 SSD scan; decay, dt: (b, L, nh), B, C: (b, L, N), x:
    (b, L, nh, P) -> y (b, L, nh, P) f32."""
    if get_policy(policy).mamba2_scan:
        return _ssd_ops.mamba2_scan(*(a.float().contiguous()
                                      for a in (decay, dt, B, C, x)))
    return mamba2_scan_ref(decay, dt, B, C, x)
