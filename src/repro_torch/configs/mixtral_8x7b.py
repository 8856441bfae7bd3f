"""mixtral-8x7b — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import LOCAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="decoder",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    layer_pattern=(LOCAL,),   # SWA on every layer
    window=4096,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ffn=14336),
    tie_embeddings=False,
    fsdp=True,                # 47B params
    sub_quadratic=True,       # SWA -> ring cache only
)
