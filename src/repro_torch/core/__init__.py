"""Selection engine of the port: objective, transforms, selection and the
warm-started stream helpers."""
from repro_torch.core.objective import SharedEvaluator
from repro_torch.core.selection import (
    EXACT_HIT,
    HYBRID_SORT,
    NOT_CONVERGED,
    TIE_FALLBACK,
    Prior,
    SelectResult,
    as_prior,
    median,
    multi_order_statistic,
    order_statistic,
    quantile,
    quantiles,
    select_rows,
    topk_threshold,
    weighted_median,
    weighted_multi_order_statistic,
    weighted_order_statistic,
    weighted_quantile,
    weighted_quantiles,
    weighted_select_rows,
)
from repro_torch.core.stream import QuantileTracker, reselect
