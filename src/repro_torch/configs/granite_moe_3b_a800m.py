"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                        # per-expert FFN width
    vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, n_shared=0),
    activation="swiglu",
    tie_embeddings=True,
    sliding_window=8192,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
