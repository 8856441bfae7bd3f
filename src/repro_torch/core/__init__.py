"""Selection engine of the port: objective, transforms and selection."""
from repro_torch.core.selection import (
    EXACT_HIT,
    HYBRID_SORT,
    NOT_CONVERGED,
    TIE_FALLBACK,
    SelectResult,
    median,
    order_statistic,
    quantile,
    select_rows,
    topk_threshold,
)
