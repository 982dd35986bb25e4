"""repro_torch.obs — the port's observability plane. It holds the round
log's fold (``roundlog``), the exact per-round refinement of
``core.iostats.IOStats``, and the stored cost-model calibrations
(``calibrate``: ``CalibrationPreset``, ``load_calibrated``)."""
from repro_torch.obs.calibrate import CalibrationPreset, load_calibrated
from repro_torch.obs.roundlog import (N_ROUND_COLS, ROUND_LOG_COLS,
                                      RoundRecord, fold_round_log,
                                      round_log_totals)

__all__ = ["CalibrationPreset", "load_calibrated", "N_ROUND_COLS",
           "ROUND_LOG_COLS", "RoundRecord", "fold_round_log",
           "round_log_totals"]
