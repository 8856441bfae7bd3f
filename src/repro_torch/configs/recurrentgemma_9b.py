"""recurrentgemma-9b — RG-LRU + local attention, 2:1 [arXiv:2402.19427]."""
from repro_torch.configs.base import LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="decoder",
    n_layers=38,                    # 12 x (R,R,A) + 2 recurrent remainder
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                   # MQA
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL),
    window=2048,
    act="gelu",
    tie_embeddings=True,
    fsdp=True,
    sub_quadratic=True,   # recurrent state + ring caches only
)
