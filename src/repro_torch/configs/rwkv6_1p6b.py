"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                      # 2048 / head_size 64
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attention_kind="none",
    ssm=SSMConfig(state_dim=64, head_dim=64),
    activation="squared_relu",       # rwkv channel-mix uses relu^2
    source="arXiv:2404.05892",
))
