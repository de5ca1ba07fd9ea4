"""ModelConfig: one dataclass covering the 10 assigned architectures
(port of ``repro.models.config``, field for field).

Every config in repro_torch/configs instantiates this with the exact
published numbers; ``reduced()`` derives the CPU smoke-test variant.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .layers import round_up


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    softmax_after_topk: bool = False   # deepseek-style
    first_k_dense: int = 0             # leading dense layers
    every: int = 1                     # MoE every Nth layer (jamba: 2)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                     # d_inner = expand * d_model
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                   # 0 ⇒ d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0                # hybrid: 1 attn layer per period
    attn_index: int = 0                 #   at this index within the period
    n_encoder_layers: int = 0           # encdec only
    prefix_tokens: int = 0              # vlm/audio stub frontend length
    vocab_pad_to: int = 256
    max_seq: int = 8192                 # rope table default
    sub_quadratic: bool = False         # True ⇒ eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, self.vocab_pad_to)

    def padded_heads(self, mp: int) -> int:
        return round_up(self.n_heads, mp)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny dims."""
        def shrink(x, lo, hi):
            return max(lo, min(x, hi))
        moe = self.moe
        if moe is not None:
            moe = replace(moe, n_experts=min(moe.n_experts, 8),
                          top_k=min(moe.top_k, 2), d_expert=64,
                          first_k_dense=min(moe.first_k_dense, 1))
        mla = self.mla
        if mla is not None:
            mla = MLAConfig(q_lora=64, kv_lora=32, nope_dim=16, rope_dim=8,
                            v_dim=16)
        ssm = self.ssm
        if ssm is not None:
            ssm = SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16)
        period = self.attn_period
        n_layers = (2 * period if period
                    else shrink(self.n_layers, 2, 2))
        return replace(
            self, n_layers=n_layers, d_model=128,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32, d_ff=256, vocab=512, vocab_pad_to=64,
            moe=moe, mla=mla, ssm=ssm,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            prefix_tokens=8 if self.prefix_tokens else 0,
            max_seq=256)
