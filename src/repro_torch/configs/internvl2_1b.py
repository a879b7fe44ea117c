"""internvl2-1b — VLM: InternViT (stub frontend) + Qwen2-0.5B LM backbone [arXiv:2404.16821].

Per the brief, the vision encoder is a STUB: ``input_specs`` provides
precomputed patch embeddings of shape (batch, frontend_positions, d_model)
which the LM backbone consumes as prefix tokens.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    activation="swiglu",
    tie_embeddings=True,
    frontend="vision",
    frontend_positions=256,          # 256 patch embeddings per image
    sliding_window=8192,
    source="arXiv:2404.16821",
))
