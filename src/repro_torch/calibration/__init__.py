"""Measurement-driven calibration of the cost model (the port of
``repro/calibration``; docs/port.md, "Calibration and the memory report").

Three stages close the tune -> execute -> measure loop:

* ``measure`` — run cells end to end through ``lower_plan`` ->
  ``make_train_step`` on the device and record warmed median step times
  and allocator / modeled memory.
* ``fit`` — attribute the measurements back to the named time-tape items,
  fit ``CostParams`` group scales and refit ``InterferenceModel.factors``
  via its ``calibrate()``.
* ``profile`` — persist the result as a per-platform JSON
  ``CalibrationProfile`` consumed by ``StageCostModel`` / ``TuneSpec``.

``driver.run_calibration`` composes them.
"""
from repro_torch.calibration.profile import (DEFAULT_PROFILE, PROFILE_VERSION,
                                             CalibrationProfile,
                                             default_platform, load_profile,
                                             profile_dir, profile_path)

__all__ = [
    "CalibrationProfile", "DEFAULT_PROFILE", "PROFILE_VERSION",
    "default_platform", "load_profile", "profile_dir", "profile_path",
]
