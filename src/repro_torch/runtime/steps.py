"""Train, prefill and serve steps of the model zoo; twin of
``repro.runtime.steps``.

The JAX steps take the parameters as an argument; here they live in the
model, so a step closes over it and a train step updates it in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import layer_stacks
from repro_torch.optim.optimizers import get_optimizer

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` under f32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()


def lm_loss(cfg: ArchConfig, logits: torch.Tensor, tokens: torch.Tensor,
            extras: Dict[str, Any]) -> torch.Tensor:
    """Causal next-token CE.  With a multimodal prefix the logits cover
    [prefix ; tokens]: only the token positions (shifted) count.  Adds
    ``MTP_WEIGHT`` x the t+2 loss of DeepSeek-V3's MTP head and
    ``MOE_AUX_WEIGHT`` x the MoE load-balance term."""
    n_tok = tokens.shape[1]
    loss = _nll(logits[:, -n_tok:][:, :-1], tokens[:, 1:])
    if cfg.mtp and "mtp_logits" in extras:
        # predict t+2 from position t (DeepSeek-V3 MTP aux objective)
        mtp = extras["mtp_logits"][:, -n_tok:]
        loss = loss + MTP_WEIGHT * _nll(mtp[:, :-2], tokens[:, 2:])
    return loss + MOE_AUX_WEIGHT * extras.get("aux", 0.0)


def _kernel_scans(model) -> Optional[str]:
    """The scan a model's policy routes to its CUDA kernel, which has no
    backward (None when there is none)."""
    fam, pol = model.cfg.family, model.policy
    if fam == "ssm" and pol.rwkv6_wkv:
        return "rwkv6_wkv"
    if fam == "hybrid" and pol.mamba2_scan:
        return "mamba2_scan"
    return None


def make_train_step(model: torch.nn.Module, optimizer: str = "adamw",
                    lr: float = 3e-4, grad_dtype: Optional[str] = None
                    ) -> Tuple[Callable, Callable]:
    """Returns ``(init_state, train_step)``:

    * ``init_state()`` turns on the gradients of the model's parameters and
      returns ``(opt_state, step)``, ``step`` an int32 tensor on the model's
      device;
    * ``train_step(opt_state, step, batch)`` takes one optimizer step on the
      model in place and returns ``(opt_state, step + 1, {"loss": loss})``.

    ``grad_dtype="bfloat16"`` casts the gradients before the update (the
    optimizer still accumulates in f32).  The scan kernels have no
    backward, as in the JAX package, whose models train on the plain scans:
    a model whose policy routes a scan to its kernel is refused; build it
    with ``policy="reference"``."""
    scan = _kernel_scans(model)
    if scan is not None:
        raise ValueError(
            f"{model.cfg.name}: the policy routes {scan} to its CUDA kernel, "
            f"which has no backward; build the model with "
            f"policy='reference' (the plain scans) to train it")
    cfg = model.cfg
    opt_init, opt_update = get_optimizer(optimizer, lr,
                                         stacks=layer_stacks(cfg))
    gdt = None if grad_dtype is None else getattr(torch, grad_dtype)
    params = dict(model.named_parameters())

    def init_state():
        for p in params.values():
            p.requires_grad_(True)
        return (opt_init(params),
                torch.zeros((), dtype=torch.int32, device=model.device))

    def train_step(opt_state, step, batch):
        for p in params.values():
            p.grad = None
        logits, extras = model.forward(batch)
        loss = lm_loss(cfg, logits, batch["tokens"], extras)
        loss.backward()
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
        if gdt is not None:
            grads = {n: g.to(gdt) for n, g in grads.items()}
        opt_state = opt_update(params, grads, opt_state, step)
        for p in params.values():
            p.grad = None
        return opt_state, step + 1, {"loss": loss.detach()}

    return init_state, train_step


def make_prefill_step(model: torch.nn.Module) -> Callable:
    """(batch) -> next-token logits (b, vocab) after the whole prompt.  The
    batch goes to ``forward`` whole: a vlm's or an enc-dec's ``embeds``
    with its ``tokens``."""
    def prefill_step(batch):
        logits, _ = model.forward(batch)
        return logits[:, -1]
    return prefill_step


def make_serve_step(model: torch.nn.Module) -> Callable:
    """One decode step: (tokens (b, 1), cache) -> (logits (b, vocab), cache)."""
    def serve_step(tokens, cache):
        logits, cache = model.decode_step(tokens, cache)
        return logits[:, -1], cache
    return serve_step


def default_optimizer(cfg: ArchConfig) -> str:
    # Adafactor for the 671B config: AdamW's f32 moments (8 bytes a
    # parameter) do not fit where its factored moments do
    return "adafactor" if cfg.n_params() > 1e11 else "adamw"
