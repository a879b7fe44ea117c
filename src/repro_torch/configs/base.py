"""Architecture configs of the model zoo; copy of ``repro.configs.base``.

Every architecture gets one module in ``repro_torch/configs`` that registers
an :class:`ArchConfig` with the exact published dimensions (the JAX
package's modules, ``source`` kept).  ``n_params()`` / ``n_active_params()``
count and ``reduced()`` (<=2 layers, d_model<=512, <=4 experts) cuts each
family as the JAX package does; the reduced variants back the CPU parity
tests.  ``INPUT_SHAPES`` are the dry-run's four input shapes
(``repro_torch.launch.dryrun``), the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Input shapes of the dry-run (the JAX package's)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 dims (zamba2) or RWKV6 dims."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    activation: str = "swiglu"              # swiglu | squared_relu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attention_kind: str = "gqa"             # gqa | mla | none
    # hybrid (zamba2): a shared transformer block is applied every
    # `shared_attn_every` ssm layers, reusing one set of parameters.
    shared_attn_every: int = 0
    # enc-dec (seamless)
    enc_layers: int = 0
    is_enc_dec: bool = False
    # multimodal stub frontends: number of prefix embedding positions the
    # stub provides per example (patch / frame embeddings).
    frontend: Optional[str] = None          # None | vision | audio
    frontend_positions: int = 0
    # multi-token prediction aux head (deepseek-v3)
    mtp: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None    # decode ring-buffer window cap
    source: str = ""                        # citation from the assignment
    dtype: str = "bfloat16"

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def n_params(self) -> int:
        """Analytic total parameter count (embedding included once)."""
        d, h = self.d_model, self.resolved_head_dim
        p = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            p += self.vocab_size * d
        def attn_params() -> int:
            if self.attention_kind == "mla":
                m = self.mla
                qh = m.qk_nope_head_dim + m.qk_rope_head_dim
                pa = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qh
                pa += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                pa += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                pa += self.n_heads * m.v_head_dim * d
                return pa
            return d * h * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * h * d

        def ffn_params(d_ff: int) -> int:
            mult = 3 if self.activation == "swiglu" else 2
            return mult * d * d_ff

        def moe_params() -> int:
            m = self.moe
            p = d * m.n_experts  # router
            p += m.n_experts * ffn_params(m.d_ff_expert)
            p += m.n_shared * ffn_params(m.d_ff_expert if self.family == "moe" else self.d_ff)
            return p

        def mamba_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            return (d * (2 * d_in + 2 * s.state_dim + nh)  # in_proj -> z,x,B,C,dt
                    + s.conv_kernel * (d_in + 2 * s.state_dim)
                    + d_in * d + 2 * nh)  # out_proj, A, D

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,w projections + output; channel-mix: k,v
            return 6 * d * d + d * self.d_ff + self.d_ff * d + 8 * d

        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + ffn_params(self.d_ff)
        elif self.family == "moe":
            per_layer = attn_params() + moe_params()
        elif self.family == "ssm":
            per_layer = rwkv_params()
        elif self.family == "hybrid":
            per_layer = mamba_params()
        elif self.family == "audio":
            per_layer = attn_params() + ffn_params(self.d_ff)

        p += self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            p += attn_params() + ffn_params(self.d_ff)  # one shared block
        if self.is_enc_dec:
            # encoder layers + decoder cross attention
            p += self.enc_layers * (attn_params() + ffn_params(self.d_ff))
            p += self.n_layers * attn_params()
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top_k + shared)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        full = self.n_params()
        mult = 3 if self.activation == "swiglu" else 2
        all_expert = self.n_layers * m.n_experts * mult * self.d_model * m.d_ff_expert
        active_expert = self.n_layers * m.top_k * mult * self.d_model * m.d_ff_expert
        return full - all_expert + active_expert

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        head_dim = max(d_model // n_heads, 32)
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if self.n_kv_heads else 0
        if self.n_kv_heads and n_heads % n_kv:
            n_kv = 1
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1))
        if self.mla:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=32)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 1
        if self.is_enc_dec:
            kw["enc_layers"] = 2
        if self.frontend:
            kw["frontend_positions"] = 8
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import side-effect registration
    from repro_torch.configs import (  # noqa: F401
        zamba2_2p7b, qwen3_14b, deepseek_v3_671b, granite_moe_3b_a800m,
        nemotron_4_15b, granite_20b, internvl2_1b, seamless_m4t_medium,
        smollm_135m, rwkv6_1p6b, splitme_dnn)
