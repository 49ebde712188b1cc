"""The tuning cost model's health signal.

The port's start of the JAX package's ``tuning/cost_model.py``: the
sustained-divergence signal ``engine.health()`` reports in its
``cost_model`` section, with the JAX package's constants and metric names.
The model itself (calibration, predictions, pruning) comes with ROADMAP.md
queue A 5; until then nothing records a prediction, so the signal reads 0
samples and ``divergent: false``, as a fresh process of the JAX package
does.
"""

from __future__ import annotations

from typing import Any

# Sustained-divergence regression signal (divergence_health): median
# |log10(predicted/measured)| over the observation window beyond this,
# with at least MIN_SAMPLES observations, marks the model divergent —
# either the machine changed (recalibrate) or a schedule regressed.
DIVERGENCE_LOG10 = 1.0
DIVERGENCE_MIN_SAMPLES = 8

# Metric names (the obs `cost model` panel and divergence_health read
# these; the tuner's per-candidate records will write them).
RATIO_HISTOGRAM = "tuning_predicted_vs_measured_ratio"
DIVERGENCE_HISTOGRAM = "tuning_cost_model_abs_log10_ratio"
DIVERGENCE_GAUGE = "tuning_cost_model_divergence"
PRUNED_COUNTER = "tuning_pruned_candidates_total"


def divergence_health(registry=None) -> dict[str, Any]:
    """The sustained-divergence regression signal (``engine.health()``'s
    ``cost_model`` section): the windowed median
    |log10(predicted/measured)| against :data:`DIVERGENCE_LOG10`, marked
    ``divergent`` only past :data:`DIVERGENCE_MIN_SAMPLES` observations
    (a single noisy candidate is not a regression). Reads the process
    default registry (the tuner's emitter) unless given one."""
    from ..obs.registry import get_registry

    reg = registry if registry is not None else get_registry()
    div = reg.histogram(
        DIVERGENCE_HISTOGRAM,
        "|log10(predicted/measured)| per tuning candidate",
    )
    n = div.count
    median = div.percentile(50) if n else float("nan")
    return {
        "samples": n,
        "median_abs_log10_ratio": median,
        "threshold_log10": DIVERGENCE_LOG10,
        "min_samples": DIVERGENCE_MIN_SAMPLES,
        "divergent": bool(
            n >= DIVERGENCE_MIN_SAMPLES and median > DIVERGENCE_LOG10
        ),
    }
