"""Optimizers and gradient compression, ported from ``repro.optim``."""
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compress import int8_compress, int8_decompress

OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}
