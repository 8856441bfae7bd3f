"""gemma2-2b — local/global alternating, logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="decoder",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    layer_pattern=(LOCAL, ATTN),  # 1:1 alternating (13 repeats)
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    sub_quadratic=True,   # half the layers are local; global cache seq-shards
)
