"""Abstract inputs of the dry-run: every model input and parameter as a
``meta`` tensor (shape and dtype, no storage); twin of
``repro.launch.specs``, where ``jax.ShapeDtypeStruct`` and
``jax.eval_shape`` play the part of the ``meta`` device.

``build_for(arch, shape)`` builds the full-size model on ``meta``
(``transformer.build_abstract_model``: plain scans, since the CUDA ops take
no meta tensors); ``batch_specs`` is the train / prefill batch and
``abstract_cache`` the decode cache.  Nothing here allocates, so
DeepSeek-V3's 671 B parameters at full depth cost nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config)
from repro_torch.models.transformer import build_abstract_model

META = torch.device("meta")


def decode_window_for(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """long_500k must be sub-quadratic: the ring-buffer window of the
    attention archs; the other decode shapes keep the full cache."""
    if shape.name == "long_500k":
        return cfg.sliding_window
    return None


def batch_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """The abstract train / prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend and not cfg.is_enc_dec:
        # VLM: [patch prefix ; tokens] fills the sequence budget
        n_tok = S - cfg.frontend_positions
        return {"tokens": torch.empty((B, n_tok), dtype=torch.int32,
                                      device=META),
                "embeds": torch.empty((B, cfg.frontend_positions,
                                       cfg.d_model), dtype=dt, device=META)}
    if cfg.is_enc_dec:
        # audio: encoder frames (stub frontend) + decoder tokens of seq_len
        return {"tokens": torch.empty((B, S), dtype=torch.int32, device=META),
                "embeds": torch.empty((B, cfg.frontend_positions,
                                       cfg.d_model), dtype=dt, device=META)}
    return {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}


def abstract_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters, ``{state-dict key: meta tensor}`` (one a
    layer: ``convert.layer_stacks`` maps them onto the reference's stacked
    leaves)."""
    return dict(model.named_parameters())


def abstract_cache(model, shape: InputShape):
    """The decode cache of ``shape`` (its batch, pre-filled to its
    length) on ``meta``; the ring buffers' host integers stay integers."""
    return model.init_cache(shape.global_batch, prefill_len=shape.seq_len)


def build_for(arch: str, shape_name: str, **model_kw) -> Tuple[object,
                                                                InputShape]:
    """The full-size ``arch`` on ``meta`` for ``shape_name``, with its
    decode window (``decode_window_for``)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    model = build_abstract_model(cfg, decode_window=decode_window_for(
        cfg, shape), **model_kw)
    return model, shape
