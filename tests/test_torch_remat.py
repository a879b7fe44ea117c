"""Remat in the port's zoo models (``build_model(remat=, remat_policy=)``):
the backward pass recomputes what the JAX package wraps in
``jax.checkpoint``, and the result is the same.

On the CPU every recomputation runs the same kernels on the same inputs,
so ``remat=True`` and ``remat_policy="dots"`` equal ``remat=False`` bit
for bit: the loss, every gradient and the parameters after two AdamW
steps, for all ten reduced zoo configs.  The recomputation is seen at the
dispatcher: the backward pass of a remat model runs the forward's GEMMs
again; under ``"dots"`` (``checkpoint_dots_with_no_batch_dims``) it runs
no weight GEMM (``aten.mm``) of the forward again but does recompute the
batched attention products (``aten.bmm``).  Serving is untouched: remat
acts only under autograd with the parameters' gradients on.
"""
import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import get_config
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import lm_loss, make_train_step

from torch_parity import one_torch_thread  # noqa: F401

ARCHS = ("smollm-135m", "qwen3-14b", "granite-20b", "nemotron-4-15b",
         "internvl2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "seamless-m4t-medium", "rwkv6-1.6b", "zamba2-2.7b")
DECODERS = {"dense", "vlm", "moe"}
MODES = ((False, None), (True, None), (True, "dots"))


def _batch(cfg, seed=0, B=2, S=12):
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.frontend:
        b["embeds"] = torch.randn(B, cfg.frontend_positions, cfg.d_model,
                                  generator=g)
    return b


def _model(cfg, remat, policy):
    return build_model(cfg, device="cpu", policy="reference", remat=remat,
                       remat_policy=policy)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(model, batch, count=False):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    logits, extras = model.forward(batch)
    loss = lm_loss(model.cfg, logits, batch["tokens"], extras)
    mode = _Count()
    if count:
        with mode:
            loss.backward()
    else:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), grads, mode.ops


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg = get_config(arch).reduced()
    batch = _batch(cfg)
    runs = {}
    for remat, policy in MODES:
        model = _model(cfg, remat, policy)
        loss, grads, ops = _loss_and_grads(model, batch, count=True)
        init_state, train_step = make_train_step(model, "adamw", lr=1e-3)
        state, step = init_state()
        for k in range(2):
            state, step, _ = train_step(state, step, _batch(cfg, 1 + k))
        runs[(remat, policy)] = (loss, grads, ops, {
            n: p.detach().clone() for n, p in model.named_parameters()})
    loss0, grads0, ops0, params0 = runs[(False, None)]
    for mode, (loss, grads, ops, params) in runs.items():
        assert torch.equal(loss, loss0), mode
        assert grads.keys() == grads0.keys()
        for n in grads0:
            assert torch.equal(grads[n], grads0[n]), (mode, n)
        for n in params0:
            assert torch.equal(params[n], params0[n]), (mode, n)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # full remat: the backward pass runs the forward's GEMMs again
    assert runs[(True, None)][2][mm] > ops0[mm]
    if cfg.family in DECODERS:
        dots = runs[(True, "dots")][2]
        assert dots[mm] == ops0[mm]          # the weight GEMMs were kept
        assert dots[bmm] > ops0[bmm]         # the attention products not


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b",
                                  "seamless-m4t-medium", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_serving_is_unchanged_with_remat(arch):
    """Prefill logits and decode steps of a remat model equal those of the
    same weights without remat, with autograd on or off."""
    cfg = get_config(arch).reduced()
    plain = _model(cfg, False, None)
    out = {}
    for name, model in (("plain", plain), ("remat", _model(cfg, True, None)),
                        ("dots", _model(cfg, True, "dots"))):
        model.load_state_dict(plain.state_dict())
        batch = _batch(cfg, 5)
        with torch.no_grad():
            logits, _ = model.forward(batch)
            if cfg.is_enc_dec:
                cache = model.init_cache(2, memory=model.encode(
                    batch["embeds"]))
            else:
                cache = model.init_cache(2)
            steps = []
            for t in range(4):
                d, cache = model.decode_step(batch["tokens"][:, t:t + 1],
                                             cache)
                steps.append(d)
        grad_on, _ = model.forward(batch)     # autograd on, no gradients
        out[name] = (logits, torch.cat(steps, 1), grad_on)
    for name in ("remat", "dots"):
        for a, b in zip(out[name], out["plain"]):
            assert torch.equal(a, b), name


def test_remat_only_under_autograd():
    """No recomputation without the parameters' gradients, and an unknown
    policy is refused."""
    cfg = get_config("smollm-135m").reduced()
    model = _model(cfg, True, None)
    batch = _batch(cfg)
    logits, _ = model.forward(batch)
    assert not logits.requires_grad
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(cfg, device="cpu", remat_policy="everything")
