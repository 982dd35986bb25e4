"""repro_torch.obs — the port's observability plane (port of
``repro.obs``).

  * round-granular device tracing (``roundlog`` +
    ``DeviceSearchParams.trace_rounds``): exact per-round records of the
    batched round loop, a lossless refinement of ``IOStats``;
  * host span/event tracing (``trace``, injectable ``clock``) and the
    serving ``metrics`` registry the coordinator, servers, stores, hot
    tier, scheduler and router report through;
  * ``export`` (Chrome-trace-event / Perfetto JSON) and ``calibrate``
    (measured-vs-modeled ``CostModel`` fitting into stored presets).
"""
from repro_torch.obs.calibrate import (CalibrationPreset, CalibrationSample,
                                       calibrate, fit_cost_model,
                                       load_calibrated)
from repro_torch.obs.clock import ManualClock, WallClock
from repro_torch.obs.export import (chrome_trace, timeline_from_round_log,
                                    validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.roundlog import (N_ROUND_COLS, ROUND_LOG_COLS,
                                      RoundRecord, fold_round_log,
                                      round_log_totals)
from repro_torch.obs.trace import TraceEvent, Tracer, manual_tracer

__all__ = [
    "CalibrationPreset", "CalibrationSample", "calibrate",
    "fit_cost_model", "load_calibrated", "ManualClock", "WallClock",
    "chrome_trace",
    "timeline_from_round_log", "validate_chrome_trace",
    "write_chrome_trace", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "N_ROUND_COLS", "ROUND_LOG_COLS", "RoundRecord",
    "fold_round_log", "round_log_totals", "TraceEvent", "Tracer",
    "manual_tracer",
]
