"""seamless-m4t-medium — enc-dec, multimodal audio [arXiv:2308.11596].

Backbone only: the mel-spectrogram + conv feature extractor is a STUB;
``input_specs`` provides precomputed frame embeddings (batch, frames, d_model)
as the encoder input. 12 encoder + 12 decoder layers.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                     # decoder layers
    enc_layers=12,                   # encoder layers
    is_enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="gelu",
    frontend="audio",
    frontend_positions=512,          # conv-downsampled audio frames
    sliding_window=8192,
    source="arXiv:2308.11596",
))
