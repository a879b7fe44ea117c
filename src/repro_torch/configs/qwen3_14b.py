"""qwen3-14b — dense, GQA kv=8, qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
    sliding_window=8192,
    source="hf:Qwen/Qwen3-8B",
))
