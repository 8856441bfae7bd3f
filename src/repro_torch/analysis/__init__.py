"""Model analysis: parameter counts.  The reference's ``roofline`` module
reads compiled XLA and has no counterpart in the port."""
from repro_torch.analysis.params import param_counts
