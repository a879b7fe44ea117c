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

The ``Precision`` rides on the policy: ``compute`` is the dtype of the
forwards' matmul inputs and activations (bf16 under ``BF16``), ``accum``
the dtype of their products' accumulation, of the bias add and of every
loss reduction (f32); master parameters stay f32.

Presets: ``"reference"`` (plain ops, f32), ``"kernel"`` (kernels, f32) and
``"kernel_bf16"`` (kernels, a bf16 REQUEST: applied where the run's device
is a CUDA card, resolved to f32 on the CPU, where the casts buy nothing;
twin of the reference's ``mixed_precision_supported``).  The request is
resolved where the device is known (``resolved(device)``, called by
``engine.make_spec``); ``KernelPolicy(precision=BF16)`` forces bf16 on any
device.  ``None`` resolves to ``"kernel"``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Union

import torch

from repro_torch.kernels.kl_mutual import ops as _kl_ops
from repro_torch.kernels.kl_mutual.ref import kl_rows_ref
from repro_torch.kernels.mamba2_scan import ops as _ssd_ops
from repro_torch.kernels.mamba2_scan.ref import (mamba2_scan_chunked_ref,
                                                 mamba2_scan_ref)
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
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute)

    @property
    def accum_dtype(self) -> torch.dtype:
        return getattr(torch, self.accum)

    @property
    def is_mixed(self) -> bool:
        return self.compute != self.accum


F32 = Precision()
BF16 = Precision(compute="bfloat16", accum="float32")


def mixed_precision_supported(device=None) -> bool:
    """Whether a bf16 request applies: on a CUDA device (its tensor cores
    take bf16 products), not on the CPU.  ``None`` asks about the default
    device of the port's entry points, the card where there is one."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@dataclass(frozen=True)
class KernelPolicy:
    """Per-op kernel bits + precision.  ``auto_precision`` marks the
    precision as a request that ``resolved`` drops to f32 where mixed
    precision does not apply."""
    kl_mutual: bool = True
    ridge_gram: bool = True
    rwkv6_wkv: bool = True
    mamba2_scan: bool = True
    precision: Precision = F32
    auto_precision: bool = False

    def resolved(self, device=None) -> "KernelPolicy":
        """The policy with its precision request settled for ``device``."""
        if not self.auto_precision:
            return self
        prec = (self.precision if mixed_precision_supported(device)
                else F32)
        return replace(self, precision=prec, auto_precision=False)


REFERENCE = KernelPolicy(kl_mutual=False, ridge_gram=False, rwkv6_wkv=False,
                         mamba2_scan=False)
KERNEL = KernelPolicy()
# the preset REQUESTS bf16: applied on a card, f32 on the CPU.  Construct
# KernelPolicy(precision=BF16) to force bf16 anywhere (the parity tests do)
KERNEL_BF16 = KernelPolicy(precision=BF16, auto_precision=True)

_NAMED = {"reference": REFERENCE, "kernel": KERNEL,
          "kernel_bf16": KERNEL_BF16}

PolicyLike = Union[None, str, KernelPolicy]


def policy_names() -> tuple:
    return tuple(_NAMED)


def get_policy(policy: PolicyLike = None) -> KernelPolicy:
    """Normalize ``None`` / preset name / ``KernelPolicy`` (a precision
    request stays unresolved: see ``KernelPolicy.resolved``)."""
    if policy is None:
        return KERNEL
    if isinstance(policy, str):
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
    ``(..., rows, d)``, each f32 or bf16 (computed in f32, the gradient in
    x's dtype); a stacked ``(M, B, d)`` cohort gives the ``(M,)`` per-client
    losses from ONE kernel launch over all M·B rows."""
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
    """G = XᵀY with f32 accumulation (x: (n, d1), y: (n, d2); a bf16
    operand is widened to f32, as the JAX op widens it)."""
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
    (b, L, nh, P) -> y (b, L, nh, P) f32.  On ``meta`` tensors outside
    autograd (the dry-run's prefill) the plain version is the chunked
    form, the kernel's order: the card's work to count, a Python step a
    token fewer times over; training keeps the sequential form, as the
    reference trains."""
    if x.is_meta and not torch.is_grad_enabled():
        return mamba2_scan_chunked_ref(decay, dt, B, C, x)
    if get_policy(policy).mamba2_scan:
        return _ssd_ops.mamba2_scan(*(a.float().contiguous()
                                      for a in (decay, dt, B, C, x)))
    return mamba2_scan_ref(decay, dt, B, C, x)
