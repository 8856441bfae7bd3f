"""rwkv6-1.6b — Finch, attn-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="decoder",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # head_dim 64 (RWKV convention d_model/64)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    layer_pattern=(RWKV,),
    tie_embeddings=False,
    sub_quadratic=True,   # recurrent state -> O(1) decode cache
    rope_theta=0.0,       # no rope
)
