"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where no card is present
    raises: the port never carries on silently on the CPU.

    On CUDA, TF32 is switched off explicitly for matmuls and cuDNN: the f32
    paths are held to the JAX reference at 1e-5 and TF32 keeps only about
    three decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
