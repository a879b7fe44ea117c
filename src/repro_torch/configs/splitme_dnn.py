"""The paper's own model: 10-layer DNN for COMMAG O-RAN traffic classification.

Paper §V-A: a ten-layer DNN (as in [38]) solves slice traffic classification
(eMBB / mMTC / URLLC). 20% of layers (two) stay on the near-RT-RIC (client),
the rest go to the non-RT-RIC (server): split_index = 2, ω = 1/5.
Copy of ``repro.configs.splitme_dnn.DNNConfig`` without the arch registry.
"""
from dataclasses import dataclass
from typing import Tuple


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
