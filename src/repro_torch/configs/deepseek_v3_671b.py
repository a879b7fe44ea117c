"""deepseek-v3-671b — MLA + MoE 256e top-8 + 1 shared + MTP [arXiv:2412.19437]."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,                       # per-expert FFN width
    vocab_size=129280,
    attention_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    mtp=True,
    activation="swiglu",
    sliding_window=8192,
    source="arXiv:2412.19437",
))
