"""Architecture configs of the model zoo; copy of ``repro.configs.base``.

The port holds the configs of the families it has ported: ``ssm`` (RWKV6)
and ``hybrid`` (Zamba2).  :class:`ArchConfig` keeps the fields those
families read, ``n_params()`` and ``reduced()`` count and cut them as the
JAX package does, and the registry holds the two ported configs.  The other
families (dense, moe, vlm, audio) and their fields come with later slices
of the port (ROADMAP queue A, item 13).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


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
    family: str            # ssm | hybrid (the others: later slices)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    activation: str = "swiglu"              # swiglu | squared_relu
    tie_embeddings: bool = False
    ssm: Optional[SSMConfig] = None
    attention_kind: str = "gqa"             # gqa | none
    # hybrid (zamba2): a shared transformer block is applied every
    # `shared_attn_every` ssm layers, reusing one set of parameters.
    shared_attn_every: int = 0
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
            return d * h * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * h * d

        def ffn_params(d_ff: int) -> int:
            mult = 3 if self.activation == "swiglu" else 2
            return mult * d * d_ff

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

        if self.family == "ssm":
            per_layer = rwkv_params()
        elif self.family == "hybrid":
            per_layer = mamba_params()
        else:
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet (ROADMAP queue A, "
                f"item 13)")
        p += self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            p += attn_params() + ffn_params(self.d_ff)  # one shared block
        return p

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512."""
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
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=32)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 1
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
        raise KeyError(f"arch {name!r} is not ported; have {sorted(_REGISTRY)} "
                       f"(the others are later slices, ROADMAP queue A, "
                       f"item 13)")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import side-effect registration
    from repro_torch.configs import rwkv6_1p6b, zamba2_2p7b  # noqa: F401
