"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4),
    shared_attn_every=6,     # one shared transformer block applied every 6 Mamba2 layers
    attention_kind="gqa",
    activation="swiglu",
    sliding_window=8192,     # long_500k decode uses a ring-buffer window for the shared attn
    source="arXiv:2411.15242",
))
