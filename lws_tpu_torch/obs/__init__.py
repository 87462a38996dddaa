"""The port's observability and decision planes (counterpart of lws_tpu/obs),
with the names JAX's package exports: the device plane, the history ring
and its signals, the scale recommender, the rollout ledger and canary
analyzer, and the decision ledger with its actuators. Request journeys
live in obs/journey.py.

    from lws_tpu_torch import obs
    ring = obs.HistoryRing(interval_s=5.0, retention_s=900.0)
    ring.ingest(metrics.REGISTRY.render())          # or the fleet exposition
    rec = obs.ScaleRecommender(ring).evaluate()     # the decision
    obs.ScaleActuator(store).apply(rec)             # ...and the actuation

None of these modules imports torch.
"""

from lws_tpu_torch.obs.decisions import (
    DECISIONS,
    DecisionLedger,
    DecisionRecord,
    RolloutActuator,
    ScaleActuator,
    default_rollout_actuator,
    default_scale_actuator,
    evaluate_and_actuate,
)
from lws_tpu_torch.obs.device import (
    CompileLedger,
    arm_from_env,
    compile_site,
    debug_compile,
    record_transfer,
    refresh_device_memory,
    register_pool_provider,
    set_pool_bytes,
)
from lws_tpu_torch.obs.device import LEDGER as COMPILE_LEDGER
from lws_tpu_torch.obs.history import (
    DEFAULT_INTERVAL_S,
    DEFAULT_RETENTION_S,
    HISTORY,
    HistoryRing,
    start_from_env,
)
from lws_tpu_torch.obs.recommend import (
    AnnotationAdapter,
    Recommendation,
    ScaleRecommender,
)
from lws_tpu_torch.obs.rollout import (
    LEDGER,
    CanaryAnalyzer,
    CanaryReport,
    RevisionVerdict,
    RolloutActuationAdapter,
    RolloutLedger,
    default_canary_analyzer,
    install,
    revision_attainment,
    revision_burn,
    revision_good_fraction,
    revision_prefix_fraction,
    revision_quantile,
    revision_samples,
    revision_spec_fraction,
    revision_values,
)
from lws_tpu_torch.obs.signals import (
    DEFAULT_BURN_WINDOWS,
    BurnVerdict,
    BurnWindow,
    breach_fraction,
    burn_rate_from_counters,
    burn_rate_from_gauge,
    burn_windows,
    error_series,
    ewma,
    histogram_quantile,
    increase,
    mean,
    multiwindow_burn,
    quantile_over_window,
    rate,
    slope,
)

__all__ = [
    "COMPILE_LEDGER",
    "DECISIONS",
    "DEFAULT_BURN_WINDOWS",
    "DEFAULT_INTERVAL_S",
    "DEFAULT_RETENTION_S",
    "HISTORY",
    "LEDGER",
    "AnnotationAdapter",
    "BurnVerdict",
    "BurnWindow",
    "CanaryAnalyzer",
    "CanaryReport",
    "CompileLedger",
    "DecisionLedger",
    "DecisionRecord",
    "HistoryRing",
    "Recommendation",
    "RevisionVerdict",
    "RolloutActuationAdapter",
    "RolloutActuator",
    "RolloutLedger",
    "ScaleActuator",
    "ScaleRecommender",
    "arm_from_env",
    "breach_fraction",
    "burn_rate_from_counters",
    "burn_rate_from_gauge",
    "burn_windows",
    "compile_site",
    "debug_compile",
    "default_canary_analyzer",
    "default_rollout_actuator",
    "default_scale_actuator",
    "error_series",
    "evaluate_and_actuate",
    "ewma",
    "histogram_quantile",
    "increase",
    "install",
    "mean",
    "multiwindow_burn",
    "quantile_over_window",
    "rate",
    "record_transfer",
    "refresh_device_memory",
    "register_pool_provider",
    "revision_attainment",
    "revision_burn",
    "revision_good_fraction",
    "revision_prefix_fraction",
    "revision_quantile",
    "revision_samples",
    "revision_spec_fraction",
    "revision_values",
    "set_pool_bytes",
    "slope",
    "start_from_env",
]
