"""The paper's own model: 10-layer DNN for COMMAG O-RAN traffic classification.

Paper §V-A: a ten-layer DNN (as in [38]) solves slice traffic classification
(eMBB / mMTC / URLLC). 20% of layers (two) stay on the near-RT-RIC (client),
the rest go to the non-RT-RIC (server): split_index = 2, ω = 1/5.
Copy of ``repro.configs.splitme_dnn``.
"""
from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ArchConfig, register


@dataclass(frozen=True)
class DNNConfig:
    name: str = "splitme-dnn10"
    n_features: int = 30          # KPI feature vector per traffic sample
    n_classes: int = 3            # eMBB / mMTC / URLLC
    hidden: Tuple[int, ...] = (256, 256, 128, 128, 64, 64, 32, 32, 16)
    split_index: int = 2          # first 2 layers on the client (omega = 1/5)
    activation: str = "relu"

    @property
    def layer_dims(self) -> Tuple[int, ...]:
        return (self.n_features,) + self.hidden + (self.n_classes,)

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims) - 1  # 10


DNN10 = DNNConfig()

# A transformer-family alias so the paper's model also flows through the
# generic --arch machinery (the paper experiments use DNN10 directly; the
# zoo's build_model refuses its family, as the JAX package's does).
CONFIG = register(ArchConfig(
    name="splitme-dnn10",
    family="mlp",
    n_layers=10,
    d_model=256,
    n_heads=1,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=3,
    attention_kind="none",
    source="paper §V-A / [38]",
    dtype="float32",
))
