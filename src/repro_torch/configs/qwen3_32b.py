"""qwen3-32b — dense, qk-norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="decoder",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    layer_pattern=(ATTN,),
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=False,
    fsdp=True,
    sub_quadratic=False,
)
