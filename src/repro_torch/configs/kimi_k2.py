"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 (paper-table)."""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="decoder",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,               # per-expert ffn (MoE every layer per spec)
    vocab=163840,
    layer_pattern=(ATTN,),
    rope_theta=5e6,
    moe=MoEConfig(num_experts=384, top_k=8, expert_ffn=2048),
    tie_embeddings=False,
    fsdp=True,
    sub_quadratic=False,     # pure full attention -> long_500k skipped
)
