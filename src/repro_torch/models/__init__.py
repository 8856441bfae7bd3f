"""The LM substrate's models, ported from ``repro.models``: the dense
decoder families (``attn`` and ``local`` layers) in plain PyTorch.  The
step factories are in :mod:`repro_torch.train` (the reference re-exports
them here too, which makes ``import repro_torch.train`` first circular)."""
from repro_torch.models import model
from repro_torch.models.model import (copy_cache, decode_step, forward, init,
                                     init_cache, lm_loss, lm_loss_fused)
