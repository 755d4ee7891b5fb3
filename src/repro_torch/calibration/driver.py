"""End-to-end calibration driver: measure -> fit -> report -> persist (the
port of ``repro/calibration/driver.py``).

``launch/train.py --calibrate`` runs it; the report keeps the
reference's shape.  ``fit_kernels`` adds the kernel anchors
(``fit.calibrate_kernels``: the Hopper kernels' bench on the device).
The reference's driver also takes tuning knobs of the fit that no caller
of the port sets, and ``write_report``, whose callers (the reference's
calibration tool and accuracy benchmark) are not ported.

One rule is the port's own: a cell of an arch the port builds that fails
to run (an OOM, a kernel build or launch error) fails the whole run — the
report carries an ``error`` and no profile is written.  Only an arch the
port has no builders for may sit on the skip list of a good run.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch.calibration.measure import (DEFAULT_SEQ, GOLDEN_ARCHS,
                                             NOT_IN_ZOO)


def run_calibration(*, archs: Sequence[str] = GOLDEN_ARCHS,
                    steps: int = 4, seq_len: int = DEFAULT_SEQ,
                    reduced: bool = True, layers: Optional[int] = None,
                    device=None, fit_kernels: bool = False,
                    write_profile: Optional[str] = None) -> Dict:
    """Measure the cells on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``), fit a profile for that device's platform against the
    port's H100 spec, and return the full report (cells, errors, profile,
    skip reasons).  ``fit_kernels``: anchor the kernel roofline's scales
    on the device's kernel bench as well (the report's ``kernels``).

    ``write_profile``: a path, or ``"auto"`` for the platform's default
    location (``profile_path``)."""
    from repro_torch.calibration.fit import calibrate_kernels, fit_profile
    from repro_torch.calibration.measure import measure_cells
    from repro_torch.calibration.profile import default_platform, profile_path

    platform = default_platform(device)
    cells, skipped = measure_cells(archs, steps=steps, seq_len=seq_len,
                                   reduced=reduced, layers=layers,
                                   device=device)
    if not cells:
        return {"platform": platform, "n_cells": 0, "cells": [],
                "skipped_cells": skipped, "improved": False,
                "error": "no cell ran to completion"}
    kc = (calibrate_kernels(archs, reduced=reduced, device=device)
          if fit_kernels else None)
    profile, report = fit_profile(cells, platform=platform,
                                  kernel_coeffs=kc)
    if kc is not None:
        report["kernels"] = dict(profile.kernels)
    report["skipped_cells"] = skipped
    report["measured_cells"] = [c.to_doc() for c in cells]
    report["profile"] = profile.to_doc()
    failed = [s for s in skipped if s["label"] != NOT_IN_ZOO]
    if failed:
        report["error"] = (f"{len(failed)} cell(s) failed to run; no "
                           "profile written")
    elif write_profile:
        path = (profile_path(platform) if write_profile == "auto"
                else Path(write_profile))
        profile.save(path)
        report["profile_path"] = str(path)
    return report


def format_table(report: Dict) -> str:
    """Human-readable uncalibrated-vs-fitted error table."""
    lines = []
    if report.get("error"):
        lines.append(f"calibration failed: {report['error']}")
    for row in report.get("cells", []):
        lines.append(
            f"{row['label']:42s} measured {row['t_measured'] * 1e3:9.2f} ms"
            f"  pred(uncal) {row['t_pred_uncalibrated'] * 1e3:9.2f} ms"
            f"  pred(fit) {row['t_pred_fitted'] * 1e3:9.2f} ms"
            f"  err {row['err_uncalibrated']:8.1%} -> "
            f"{row['err_fitted']:7.1%}")
    if "mean_err_uncalibrated" in report:
        lines.append(
            f"{'MEAN (' + str(report['n_cells']) + ' cells)':42s} "
            f"err {report['mean_err_uncalibrated']:8.1%} -> "
            f"{report['mean_err_fitted']:7.1%}  "
            f"improved={report['improved']}")
    for s in report.get("skipped_cells", []):
        lines.append(f"SKIPPED {s['arch']}/{s['label']}: {s['error']}")
    return "\n".join(lines)
