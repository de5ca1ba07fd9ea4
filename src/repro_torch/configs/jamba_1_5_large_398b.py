"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2, Mamba:attn 7:1 interleave (1 attn per 8-layer
period, MoE every 2nd layer).  [arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128),
    attn_period=8, attn_index=3, sub_quadratic=True,
)
