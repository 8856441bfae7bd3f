"""whisper-medium — encoder-decoder, conv frontend stub [arXiv:2212.04356].

24 encoder + 24 decoder layers; the conv mel frontend is a STUB by
assignment (input_specs supplies precomputed frame embeddings)."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder depth
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    layer_pattern=(ATTN,),
    rope_theta=0.0,       # sinusoidal positions, no rope
    act="gelu",
    tie_embeddings=True,
    frontend="audio_stub",
    sub_quadratic=False,
)
