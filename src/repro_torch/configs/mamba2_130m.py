"""mamba2-130m [ssm]: 24L d_model=768, attn-free, SSD d_state=128,
vocab=50280 (padded to 50432).  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab=50280, head_dim=64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128),
    sub_quadratic=True,
)
