"""The port's calibration loop against the reference's, on the CPU.

- Profile: the frozen default changes nothing (the same ``CostParams``
  object, bitwise model outputs, the default auto threshold); JSON round
  trip; unknown fields and newer versions refused, and so is a profile
  the reference wrote; ``load_profile`` resolves an explicit path, then
  the port's environment variable, then the platform file in the port's
  directory, then the default, and never reads the reference's
  variables; a profile is hashable, pickles inside ``TuneSpec`` and moves
  the memo store's addresses.
- Fit: ``ITEM_GROUP`` covers the port's items; the scaled surrogate equals
  the rebuilt model; synthetic scales are recovered; the keep-if-better
  guard holds.  On the same measured cells (times drawn from a seeded
  numpy generator) the port's ``fit_profile`` against the reference's
  hardware gives the reference's cost and interference overrides, scales
  and per-cell errors exactly; the profiles differ only in their platform
  and in the auto-threshold field (``torch_auto_threshold`` here,
  ``jax_auto_threshold`` there); the interference refit gives the
  reference's factors.  Tuning with the two fitted profiles selects the
  same plan in both packages.
- End to end: ``train --calibrate --smoke --device cpu`` measures the two
  one-device cells, writes a cpu profile and exits 0; without
  ``--device cpu`` it raises on a machine without CUDA.

The reference's runs sit in module-scoped fixtures.
"""
import dataclasses
import json
import math
import pickle

import numpy as np
import pytest
import torch

from repro.calibration.fit import ITEM_GROUP as JAX_ITEM_GROUP
from repro.calibration.fit import fit_profile as jax_fit_profile
from repro.calibration.measure import MeasuredCell as JMeasuredCell
from repro.calibration.profile import CalibrationProfile as JProfile
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_arch as jax_get_arch
from repro.core.hardware import V5E
from repro.core.interference import InterferenceModel as JInterferenceModel
from repro.core.plan import Plan as JPlan
from repro.core.tuner import tune as jax_tune
from repro_torch.calibration import (DEFAULT_PROFILE, CalibrationProfile,
                                     default_platform, load_profile)
from repro_torch.calibration import profile as PROF
from repro_torch.calibration.fit import (ITEM_GROUP, attribute_cell,
                                         calibrate_kernels, fit_profile,
                                         predict_step_scaled,
                                         scales_to_overrides)
from repro_torch.calibration import measure as MEASURE
from repro_torch.calibration.measure import (NOT_IN_ZOO, MeasuredCell,
                                             _cell_plans, measure_cells)
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.costmodel import (TORCH_AUTO_THRESHOLD, CostParams,
                                        StageCostModel, estimate_plan)
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.interference import _DEFAULT, InterferenceModel
from repro_torch.core.memo_store import report_key, tuner_fingerprint
from repro_torch.core.costmodel_params import KernelCoeffs
from repro_torch.core.plan import KernelConfig
from repro_torch.core.tuner import MistTuner, TuneSpec, tune
from repro_torch.launch import train as train_launch

V5E_VALUES = HardwareSpec(**dataclasses.asdict(V5E))
TUNE_WORKLOAD = dict(stage_counts=(1, 2), grad_accums=(4,))


def _cells(n_dev=4, arch="granite-3-8b"):
    """Measured cells with their plans only (no execution)."""
    cfg = get_arch(arch).reduced()
    out = []
    for label, plan in _cell_plans(cfg, n_dev):
        st0 = plan.stages[0]
        out.append(MeasuredCell(
            label=f"{arch}/{label}", arch=arch, reduced=True, seq_len=128,
            global_batch=st0.dp * st0.micro_batch * plan.grad_accum,
            plan=plan, steps=0, step_seconds=(), t_measured=0.0))
    return out


def _env():
    return dict(b=2.0, dp=8.0, tp=2.0, zero=1.0, ckpt=4.0, wo=0.0, go=0.0,
                oo=0.0, ao=0.0, L=40.0, G=4.0, inflight=1.0)


# -- the profile --------------------------------------------------------------


def test_frozen_default_changes_nothing():
    base = CostParams()
    assert DEFAULT_PROFILE.cost_params(base) is base
    assert DEFAULT_PROFILE.with_cost().cost_params(base) is base
    assert DEFAULT_PROFILE.interference_model().factors == _DEFAULT
    cfg = get_arch("granite-3-8b")
    a = StageCostModel(cfg, 4096)
    b = StageCostModel(cfg, 4096, profile=DEFAULT_PROFILE)
    ra, rb = a.evaluate(_env()), b.evaluate(_env())
    for k in ("t_step", "t_stable", "d_delta", "mem_peak"):
        assert ra[k].tobytes() == rb[k].tobytes()
    assert a.torch_auto_threshold == b.torch_auto_threshold == \
        TORCH_AUTO_THRESHOLD


def test_profile_pins_the_torch_auto_threshold_and_cost():
    p = CalibrationProfile.make(platform="cuda", cost={"mxu_eff_peak": 0.3},
                                torch_auto_threshold=1024)
    scm = StageCostModel(get_arch("granite-3-8b").reduced(), 128, profile=p)
    assert scm.torch_auto_threshold == 1024 and scm.cp.mxu_eff_peak == 0.3


def test_with_cost_merges_and_validates():
    base = CalibrationProfile.make(platform="cuda",
                                   cost={"mxu_eff_peak": 0.41})
    merged = base.with_cost(runtime_reserved=2.0 * 2**30)
    assert dict(merged.cost) == {"mxu_eff_peak": 0.41,
                                 "runtime_reserved": 2.0 * 2**30}
    cp = merged.cost_params(CostParams())
    for f in dataclasses.fields(CostParams):
        if f.name not in ("mxu_eff_peak", "runtime_reserved"):
            assert getattr(cp, f.name) == getattr(CostParams(), f.name)
    with pytest.raises(ValueError, match="unknown CostParams"):
        DEFAULT_PROFILE.with_cost(runtime_reservd=1.0)


def test_round_trip_save_and_load(tmp_path):
    p = CalibrationProfile.make(
        platform="cuda", source="test",
        cost={"mxu_eff_peak": 0.5, "ici_eff": 0.3, "coll_latency_us": 90.0},
        kernels={"attn_scale": 1.5},
        interference={(0, 1): (1.1, 1.2), (0, 1, 2): (1.2, 1.3, 1.4)},
        torch_auto_threshold=1024)
    q = CalibrationProfile.from_json(p.to_json())
    assert q == p and hash(q) == hash(p)
    cp = q.cost_params()
    assert (cp.mxu_eff_peak, cp.coll_latency_us, cp.kernels.attn_scale) == \
        (0.5, 90.0, 1.5)
    assert cp.vpu_tax == CostParams().vpu_tax
    assert q.interference_model().factors[(0, 1)] == (1.1, 1.2)
    assert CalibrationProfile.load(p.save(tmp_path / "sub" / "x.json")) == p


@pytest.mark.parametrize("text,match", [
    ('{"cost": {"not_a_field": 1.0}}', "CostParams"),
    ('{"kernels": {"nope": 1.0}}', "KernelCoeffs"),
    ('{"version": 999}', "version"),
    ('{"jax_auto_threshold": 16384}', "jax_auto_threshold"),
])
def test_unknown_fields_and_newer_versions_are_refused(text, match):
    with pytest.raises(ValueError, match=match):
        CalibrationProfile.from_json(text)


def test_a_reference_profile_never_reaches_the_port(tmp_path, monkeypatch):
    ref = JProfile.make(platform="cpu", cost={"ici_eff": 0.2})
    ref.save(tmp_path / "cpu.json")
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CALIBRATION_PROFILE", str(tmp_path / "cpu.json"))
    monkeypatch.delenv(PROF.PROFILE_ENV, raising=False)
    monkeypatch.setenv(PROF.DIR_ENV, str(tmp_path / "port"))
    assert load_profile("cpu") is DEFAULT_PROFILE
    with pytest.raises(ValueError, match="jax_auto_threshold"):
        load_profile(path=tmp_path / "cpu.json")
    monkeypatch.delenv(PROF.DIR_ENV)
    assert PROF.profile_dir() == PROF.DEFAULT_DIR
    assert PROF.DEFAULT_DIR.parts[-2:] == ("build", "calibration")


def test_load_profile_resolution_order(tmp_path, monkeypatch):
    monkeypatch.setenv(PROF.DIR_ENV, str(tmp_path))
    monkeypatch.delenv(PROF.PROFILE_ENV, raising=False)
    assert load_profile("cuda") is DEFAULT_PROFILE
    p = CalibrationProfile.make(platform="cuda", cost={"ici_eff": 0.2})
    p.save(tmp_path / "cuda.json")
    assert load_profile("cuda") == p
    assert load_profile(device="cpu") is DEFAULT_PROFILE
    q = CalibrationProfile.make(platform="other", cost={"ici_eff": 0.3})
    q.save(tmp_path / "explicit.json")
    monkeypatch.setenv(PROF.PROFILE_ENV, str(tmp_path / "explicit.json"))
    assert load_profile("cuda") == q
    r = CalibrationProfile.make(platform="cpu", cost={"ici_eff": 0.4})
    assert load_profile("cuda", path=r.save(tmp_path / "r.json")) == r


def test_platform_is_the_callers_device(monkeypatch):
    assert default_platform("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_platform()


def test_profile_pickles_in_the_spec_and_moves_the_memo_address():
    p = CalibrationProfile.make(platform="cuda", cost={"mxu_eff_peak": 0.4},
                                interference={(0, 1): (1.2, 1.3)})
    spec = TuneSpec(arch=get_arch("granite-3-8b").reduced(), seq_len=128,
                    global_batch=8, n_devices=4, profile=p)
    spec2 = pickle.loads(pickle.dumps(spec))
    assert spec2.profile == p and hash(spec2) == hash(spec)
    with_p = MistTuner(spec2)
    assert with_p.cp.mxu_eff_peak == 0.4
    assert with_p.scm(True, True).intf.factors[(0, 1)] == (1.2, 1.3)
    without = MistTuner(dataclasses.replace(spec, profile=None))
    assert tuner_fingerprint(with_p) != tuner_fingerprint(without)
    assert report_key(with_p) != report_key(without)
    other = MistTuner(dataclasses.replace(
        spec, profile=p.with_cost(mxu_eff_peak=0.41)))
    assert report_key(other) != report_key(with_p)


# -- the fit ------------------------------------------------------------------


def test_item_groups_cover_the_ports_items():
    scm = StageCostModel(get_arch("granite-3-8b").reduced(), 128)
    assert set(ITEM_GROUP) == set(scm.items)
    assert ITEM_GROUP == JAX_ITEM_GROUP


def test_attribution_matches_estimate_plan():
    cell = _cells()[0]
    attr = attribute_cell(cell)
    assert attr.t_step_pred == estimate_plan(cell.config(), cell.shape(),
                                             cell.plan)["t_step"]


def test_scaled_surrogate_equals_rebuilt_model():
    for cell in _cells():
        scales = (1e-3, 1e-2, 1.0)
        prof = CalibrationProfile.make(
            platform="cpu", cost=scales_to_overrides(scales, CostParams()))
        real = estimate_plan(cell.config(), cell.shape(), cell.plan,
                             profile=prof)["t_step"]
        sur = predict_step_scaled(attribute_cell(cell), scales,
                                  InterferenceModel())
        assert sur == pytest.approx(real, rel=1e-9)


def test_fit_recovers_synthetic_scales():
    cells = _cells()
    true = CalibrationProfile.make(
        platform="cpu",
        cost=scales_to_overrides((3e-4, 2e-3, 1.0), CostParams()))
    for c in cells:
        c.t_measured = estimate_plan(c.config(), c.shape(), c.plan,
                                     profile=true)["t_step"]
    prof, report = fit_profile(cells, platform="cpu")
    assert report["improved"] and report["mean_err_fitted"] < 0.02
    assert report["mean_err_uncalibrated"] > 0.9
    for c in cells:
        assert estimate_plan(c.config(), c.shape(), c.plan, profile=prof)[
            "t_step"] == pytest.approx(c.t_measured, rel=0.05)


def test_fit_keeps_the_base_when_it_is_better():
    cells = _cells(n_dev=2)
    for c in cells:
        c.t_measured = estimate_plan(c.config(), c.shape(), c.plan)["t_step"]
    _prof, report = fit_profile(cells, platform="cpu")
    assert report["mean_err_fitted"] <= \
        report["mean_err_uncalibrated"] + 1e-12


def test_non_default_kernel_cell_refused_and_kernels_wait(tmp_path):
    """A cell off the default kernel tuple is refused (the scalar fit
    needs the roofline delta at 0); the kernel anchors come from the
    kernel bench instead: on the CPU, of the plain versions."""
    cell = _cells()[0]
    cell.plan = cell.plan.replace(kernel=KernelConfig(attn_q_block=256))
    with pytest.raises(ValueError, match="kernel"):
        attribute_cell(cell)
    kc = calibrate_kernels(("granite-3-8b", "zamba2-2.7b"), seq_len=128,
                           device="cpu", cache_path=tmp_path / "bench.json")
    assert isinstance(kc, KernelCoeffs)
    for f in ("attn_scale", "rms_scale", "ssd_scale"):
        v = getattr(kc, f)
        assert math.isfinite(v) and v > 0 and v != 1.0, (f, v)


def test_cell_plans_run_flash_attention_on_one_device():
    cfg = get_arch("granite-3-8b").replace(num_layers=8)
    plans = dict(_cell_plans(cfg, 1))
    assert sorted(plans) == ["dp1_z0", "dp1_z2_ckpt"]
    for p in plans.values():
        assert (p.attn_impl, p.use_pallas, p.grad_accum) == ("pallas", True, 2)
    assert [p.stages[0].ckpt_layers for p in plans.values()] == [0, 8]
    cell = MeasuredCell(label="x", arch="granite-3-8b", reduced=False,
                        seq_len=4096, global_batch=2, plan=plans["dp1_z0"],
                        steps=1, step_seconds=(1.0,), t_measured=1.0,
                        layers=8)
    assert cell.config() == cfg
    assert json.loads(json.dumps(cell.to_doc()))["layers"] == 8


@pytest.fixture(scope="module")
def measured_pair():
    """The same cells in both packages (n_dev 4: ZeRO-2 and TP cells run
    two channels at once, so the interference refit runs), with step
    times drawn from a seeded generator around the uncalibrated
    predictions."""
    rng = np.random.default_rng(19)
    cells = _cells(n_dev=4)
    jcells = []
    for c in cells:
        pred = estimate_plan(c.config(), c.shape(), c.plan,
                             hw=V5E_VALUES)["t_step"]
        c.t_measured = float(pred * rng.uniform(1.5, 4.0))
        jcells.append(JMeasuredCell(
            label=c.label, arch=c.arch, reduced=True, seq_len=c.seq_len,
            global_batch=c.global_batch,
            plan=JPlan.from_json(c.plan.to_json()), steps=0,
            step_seconds=(), t_measured=c.t_measured))
    ref = jax_fit_profile(jcells, platform="cpu")
    return cells, ref


def test_fit_matches_the_reference_on_the_same_cells(measured_pair):
    cells, (jprof, jreport) = measured_pair
    prof, report = fit_profile(cells, platform="cpu", hw=V5E_VALUES)
    assert report["interference_samples"] >= 2
    assert report["interference_refit"] == jreport["interference_refit"]
    assert report["scales"] == jreport["scales"]
    assert prof.cost == jprof.cost and prof.interference == jprof.interference
    assert prof.kernels == jprof.kernels == ()
    for key in ("mean_err_uncalibrated", "mean_err_fitted", "improved",
                "n_cells", "platform"):
        assert report[key] == jreport[key], key
    assert [{k: r[k] for k in r if k != "memory"} for r in report["cells"]] \
        == [{k: r[k] for k in r if k != "memory"} for r in jreport["cells"]]
    # what may differ: the auto-threshold field (named for each package's
    # tape backend) and, on the card, the platform
    doc, jdoc = prof.to_doc(), jprof.to_doc()
    assert set(doc) ^ set(jdoc) == {"torch_auto_threshold",
                                    "jax_auto_threshold"}
    assert {k: doc[k] for k in jdoc if k in doc} == \
        {k: jdoc[k] for k in doc if k in jdoc}
    cuda, _ = fit_profile(cells, platform="cuda", hw=V5E_VALUES)
    assert cuda.torch_auto_threshold == TORCH_AUTO_THRESHOLD
    assert dataclasses.replace(cuda, platform="cpu",
                               torch_auto_threshold=None) == prof


def test_interference_refit_matches_the_reference(measured_pair):
    """The refit fit_profile runs on cells whose stable phase overlaps two
    channels (here the keep-if-better guard keeps the scaled profile, so
    the refit factors are compared on their own)."""
    cells, _ = measured_pair
    samples = []
    for c in cells:
        ch = attribute_cell(c, hw=V5E_VALUES).phases["stable"]
        if int((ch > 1e-12).sum()) >= 2:
            samples.append((tuple(float(v) for v in ch), c.t_measured / 2))
    assert len(samples) >= 2
    port, ref = InterferenceModel(), JInterferenceModel()
    assert port.calibrate(samples) == ref.calibrate(samples)
    assert port.factors == ref.factors != _DEFAULT


def test_tune_with_the_fitted_profiles_matches_the_reference(measured_pair):
    cells, (jprof, _) = measured_pair
    prof, _ = fit_profile(cells, platform="cpu", hw=V5E_VALUES)
    args = ("t", 2048, 16, "train")
    rep = tune(get_arch("granite-3-8b"), ShapeConfig(*args), 8,
               space="mist", hw=V5E_VALUES, profile=prof, **TUNE_WORKLOAD)
    ref = jax_tune(jax_get_arch("granite-3-8b"), JShapeConfig(*args), 8,
                   space="mist", profile=jprof, **TUNE_WORKLOAD)
    assert rep.plan.to_json() == ref.plan.to_json()
    assert rep.objective == ref.objective


# -- end to end ---------------------------------------------------------------


def test_calibrate_smoke_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "prof.json"
    assert train_launch.main(["--arch", "granite-3-8b", "--calibrate",
                              "--smoke", "--steps", "2", "--device", "cpu",
                              "--calibration-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "granite-3-8b/dp1_z0" in text and "dp1_z2_ckpt" in text
    assert "improved=" in text and "SKIPPED" not in text
    prof = CalibrationProfile.load(out)
    assert prof.platform == "cpu" and prof.source == "measured (2 cells)"


def test_calibrate_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.main(["--arch", "granite-3-8b", "--calibrate",
                           "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_cells(("granite-3-8b",))


def test_measure_cells_reports_what_it_cannot_run():
    cells, skipped = measure_cells(
        ("xlstm-1.3b", "granite-3-8b"), steps=1, warmup=1, seq_len=16,
        device="cpu")
    assert [(s["arch"], s["label"]) for s in skipped] == \
        [("xlstm-1.3b", NOT_IN_ZOO)]
    assert "not in the port's zoo" in skipped[0]["error"]
    assert [c.label for c in cells] == ["granite-3-8b/dp1_z0",
                                        "granite-3-8b/dp1_z2_ckpt"]
    for cell in cells:
        assert len(cell.step_seconds) == 1
        assert cell.memory["allocator_peak_bytes"] is None
        assert cell.memory["executable_bytes"] is None
        assert cell.memory["modeled_peak_bytes"] > 0


def test_measure_cells_runs_one_device_cells_however_many_cards_show(
        monkeypatch):
    """The port executes dp = tp = 1 only: two visible cards must not turn
    the cells into dp2 / tp2 plans that cannot run."""
    from repro_torch.models import common

    ran = []

    def fake_measure(cfg, shape, plan, **kw):
        ran.append((shape.name, [(s.dp, s.tp) for s in plan.stages]))
        return 1.0, (1.0,), {"modeled_peak_bytes": 1.0,
                             "executable_bytes": None,
                             "allocator_peak_bytes": 1.0}

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(common, "resolve_device",
                        lambda device=None, **kw: torch.device("cuda"))
    monkeypatch.setattr(MEASURE, "measure_plan", fake_measure)
    cells, skipped = measure_cells(("granite-3-8b",))
    assert skipped == []
    assert ran == [("dp1_z0", [(1, 1)]), ("dp1_z2_ckpt", [(1, 1)])]
    assert [c.global_batch for c in cells] == [2, 2]


def test_calibrate_fails_when_a_cell_fails(tmp_path, monkeypatch, capsys):
    """A cell that raises (an OOM, a kernel error) is on the skip list, and
    the launcher then exits non-zero and writes no profile: the skip list
    may not hide a failure of an arch the port builds."""
    real = MEASURE.measure_plan

    def failing(cfg, shape, plan, **kw):
        if shape.name == "dp1_z2_ckpt":
            raise RuntimeError("CUDA out of memory (planted)")
        return real(cfg, shape, plan, **kw)

    monkeypatch.setattr(MEASURE, "measure_plan", failing)
    out = tmp_path / "prof.json"
    assert train_launch.main(["--arch", "granite-3-8b", "--calibrate",
                              "--smoke", "--steps", "1", "--device", "cpu",
                              "--calibration-out", str(out)]) == 1
    text = capsys.readouterr().out
    assert "calibration failed: 1 cell(s) failed to run" in text
    assert ("SKIPPED granite-3-8b/dp1_z2_ckpt: RuntimeError: CUDA out of "
            "memory (planted)") in text
    assert not out.exists()
