"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend is a STUB — input_specs provides
precomputed patch embeddings.  [hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=160, rope_theta=1000000000.0,
    prefix_tokens=256,
)
