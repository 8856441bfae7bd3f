"""Selection engine of the port: objective, transforms, selection, the
warm-started stream helpers, segmented selection, the robust consumers
(``repro_torch.core.robust``) and the distributed layer on
``torch.distributed`` (``repro_torch.core.distributed``)."""
from repro_torch.core.objective import (
    FG,
    WFG,
    Evaluator,
    FnEvaluator,
    RowsEvaluator,
    ShardedEvaluator,
    SharedEvaluator,
    eval_fg,
    eval_fg_batched,
    eval_partials,
    fg_from_partials,
    os_weights,
    wfg_from_partials,
)
from repro_torch.core.selection import (
    EXACT_HIT,
    HYBRID_SORT,
    METHODS,
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
    segmented_order_statistic,
    segmented_quantiles,
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

__all__ = [
    "FG", "WFG", "eval_fg", "eval_fg_batched", "eval_partials",
    "fg_from_partials", "os_weights", "wfg_from_partials",
    "Evaluator", "FnEvaluator", "RowsEvaluator", "SharedEvaluator",
    "ShardedEvaluator", "Prior", "as_prior", "QuantileTracker", "reselect",
    "SelectResult", "order_statistic", "select_rows",
    "multi_order_statistic", "quantiles", "median", "quantile",
    "topk_threshold", "segmented_order_statistic", "segmented_quantiles",
    "weighted_order_statistic", "weighted_select_rows",
    "weighted_multi_order_statistic", "weighted_median",
    "weighted_quantile", "weighted_quantiles",
    "METHODS", "EXACT_HIT", "HYBRID_SORT", "TIE_FALLBACK", "NOT_CONVERGED",
]
