"""llava-next-mistral-7b — VLM, anyres tiling (stub frontend)
[hf:llava-hf/llava-v1.6-mistral-7b-hf].  The vision tower is a stub by
assignment: input_specs supplies precomputed patch embeddings (anyres:
base 576 + 4 tiles x 576 = 2880 patch tokens) prepended to the text."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="decoder",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    layer_pattern=(ATTN,),
    rope_theta=1e6,
    tie_embeddings=False,
    frontend="patch_stub",
    n_frontend_tokens=2880,
    sub_quadratic=False,
)
