"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    activation="swiglu",
    tie_embeddings=True,
    sliding_window=8192,
    source="hf:HuggingFaceTB/SmolLM-135M",
))
