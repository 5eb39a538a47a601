"""Model configuration schema covering all assigned architecture families —
port of `src/repro/models/config.py` (all of it: `LayerSpec`, `ModelConfig`
with its properties, `InputShape`, `INPUT_SHAPES`, `reduced`). The port keeps
its own copy; the reference module imports no JAX but is not imported here.

A model is a stack of ``n_periods`` repeated *periods*; a period is a short
list of layer descriptors (attention / mamba / cross-attention, each with an
FFN that is dense or MoE). Uniform models have a 1-layer period; Jamba uses
an 8-layer period (1 attn : 7 mamba); the vision model a 5-layer period
(1 cross : 4 self). The reference stacks each period-position's parameters
over periods and scans over them; the port keeps that stacked layout in its
parameter carry-over and its caches, and loops over periods.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: Literal["attn", "mamba", "cross"] = "attn"
    moe: bool = False                 # MoE FFN instead of dense FFN
    sliding_window: int = 0           # >0: sliding-window attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    # core dims
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # attention
    attn_type: Literal["gqa", "mla"] = "gqa"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek/MiniCPM3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0               # 0 -> head_dim
    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001  # load-balance loss weight
    # SSM (Mamba2 SSD)
    ssm_d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # stacking pattern
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    # modality frontends (stubs by design — see DESIGN.md carve-out)
    n_image_tokens: int = 0           # vlm: precomputed patch embeddings
    n_codebooks: int = 0              # audio: EnCodec codebooks
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 2048            # blockwise-attention KV chunk for long seq
    loss_chunk: int = 1024            # cross-entropy chunking over tokens
    # §Perf variants (see EXPERIMENTS.md):
    triangular_attention: bool = False  # skip fully-masked causal tiles
    serve_weight_stationary: bool = False  # decode: resident 2D-sharded experts

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by period "
            f"{len(self.period)}"
        )

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def is_ssm_only(self) -> bool:
        return all(l.kind == "mamba" for l in self.period)

    @property
    def has_attention(self) -> bool:
        return any(l.kind in ("attn", "cross") for l in self.period)

    @property
    def has_moe(self) -> bool:
        return any(l.moe for l in self.period)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def supports_long_context_decode(self) -> bool:
        """Sub-quadratic/sub-linear-memory decode path available?

        True for SSM-only (O(1) state) and hybrid (sequence-sharded KV for
        the sparse attention layers). Pure full-attention stacks skip
        long_500k (DESIGN.md §5).
        """
        frac_attn = sum(l.kind != "mamba" for l in self.period) / len(self.period)
        return frac_attn < 0.5 or all(
            l.sliding_window > 0 for l in self.period if l.kind != "mamba"
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 periods,
    d_model<=512, <=4 experts)."""
    kw: dict = dict(
        n_layers=2 * len(cfg.period),
        d_model=256,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=64,
        v_head_dim=64,   # must track head_dim (frozen post_init already ran)
        d_ff=512,
        vocab_size=512,
        compute_dtype="float32",
        remat=False,
        attn_chunk=512,
        loss_chunk=256,
    )
    if cfg.attn_type == "mla":
        kw.update(kv_lora_rank=64, rope_head_dim=32, q_lora_rank=0)
    if cfg.n_routed_experts:
        kw.update(
            n_routed_experts=4,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            moe_top_k=2,
            moe_d_ff=128,
        )
    if cfg.ssm_d_state:
        kw.update(ssm_d_state=16, ssm_head_dim=32, ssm_chunk=64)
    if cfg.n_image_tokens:
        kw.update(n_image_tokens=16)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
