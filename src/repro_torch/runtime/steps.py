"""Prefill and serve steps of the model zoo; twin of ``repro.runtime.steps``.

The JAX steps take the parameters as an argument; here they live in the
model, so a step closes over it.  ``lm_loss`` and ``make_train_step`` come
with the training slice of the port.
"""
from __future__ import annotations

from typing import Callable

import torch


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
