"""Parameters between the JAX package's layout and the port's tensors.

The JAX package holds an MLP as a list of ``{"w", "b"}`` arrays; after
``jax.device_get`` they are numpy arrays, which is what these functions
take and give.  This module does not import jax.
"""
from __future__ import annotations

from typing import List, Sequence

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
