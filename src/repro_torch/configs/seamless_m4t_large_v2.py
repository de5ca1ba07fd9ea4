"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206; the speech frontend is a STUB — input_specs
provides precomputed frame embeddings.  [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=256206, head_dim=64, norm="layernorm",
    prefix_tokens=0,
)
