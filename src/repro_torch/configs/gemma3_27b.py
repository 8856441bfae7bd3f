"""gemma3-27b — 5:1 local:global, 128k context [hf:google/gemma-3 family]."""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="decoder",
    n_layers=62,                    # 10 x (5L+1G) + 2 local remainder
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, ATTN),
    window=1024,
    rope_theta=10_000.0,            # local layers
    rope_theta_global=1e6,          # global layers
    qk_norm=True,
    act="gelu",
    tie_embeddings=True,
    fsdp=True,
    sub_quadratic=True,   # 5/6 local; global cache seq-shards at 500k
)
