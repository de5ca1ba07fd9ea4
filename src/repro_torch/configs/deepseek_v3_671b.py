"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA d_ff=2048(expert)
vocab=129280, 1 shared + 256 routed top-8, first 3 layers dense.
[arXiv:2412.19437; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab=129280, head_dim=128,
    mla=MLAConfig(q_lora=1536, kv_lora=512, nope_dim=128, rope_dim=64,
                  v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  softmax_after_topk=True, first_k_dense=3),
)
