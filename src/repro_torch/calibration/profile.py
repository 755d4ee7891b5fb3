"""Per-platform calibration profiles: fitted cost-model constants (the
port of ``repro/calibration/profile.py``).

The tune -> execute -> measure loop fits the time-side constants of the
cost model — ``CostParams`` scalars, ``KernelCoeffs`` anchors,
``InterferenceModel.factors`` — from measured step times, and persists
them as a versioned JSON ``CalibrationProfile`` keyed by platform: the
type of the device the measurements ran on, ``"cuda"`` or ``"cpu"``.

``StageCostModel(profile=...)``, ``estimate_plan(profile=...)`` and
``TuneSpec.profile`` layer the profile's overrides over the frozen
defaults.  The default profile carries no overrides and returns the
caller's ``CostParams`` object unchanged, so every golden fixture is
byte-identical with or without it.

Overrides are stored as sorted ``(name, value)`` tuples rather than
dicts so the dataclass stays hashable (``TuneSpec`` is frozen and is
pickled to sweep workers) and serialization is deterministic.

Two differences from the reference: the profile pins the port's
``torch_auto_threshold`` (the tape-backend crossover,
``core/costmodel.py``) where the reference pins ``jax_auto_threshold``,
and profiles live in the port's own directory
(``$REPRO_TORCH_CALIBRATION_DIR``, by default ``build/calibration/`` of
the checkout) under the port's own environment variables, so a profile
the reference fitted on its backend is never picked up here.
``from_json`` refuses unknown keys, a reference profile's
``jax_auto_threshold`` among them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.core.costmodel import CostParams
from repro_torch.core.costmodel_params import KernelCoeffs
from repro_torch.core.interference import InterferenceModel

PROFILE_VERSION = 1

COST_FIELDS = tuple(f.name for f in dataclasses.fields(CostParams)
                    if f.name != "kernels")
KERNEL_FIELDS = tuple(f.name for f in dataclasses.fields(KernelCoeffs))
_DOC_KEYS = ("version", "platform", "source", "cost", "kernels",
             "interference", "torch_auto_threshold")

DIR_ENV = "REPRO_TORCH_CALIBRATION_DIR"
PROFILE_ENV = "REPRO_TORCH_CALIBRATION_PROFILE"
DEFAULT_DIR = Path(__file__).resolve().parents[3] / "build" / "calibration"

Overrides = Tuple[Tuple[str, float], ...]


def _as_overrides(d, allowed, what) -> Overrides:
    if not d:
        return ()
    d = dict(d)
    bad = sorted(set(d) - set(allowed))
    if bad:
        raise ValueError(f"unknown {what} field(s) {bad}; "
                         f"have {sorted(allowed)}")
    return tuple(sorted((k, float(v)) for k, v in d.items()))


@dataclass(frozen=True)
class CalibrationProfile:
    """Fitted constants for ONE platform.

    ``cost`` / ``kernels`` override individual ``CostParams`` /
    ``KernelCoeffs`` fields; ``interference`` replaces the slowdown-factor
    table wholesale (it is fit as a unit); ``torch_auto_threshold`` pins
    the tape-backend crossover for the platform.  Empty/None everywhere
    means "use the frozen defaults"."""
    version: int = PROFILE_VERSION
    platform: str = "default"
    source: str = "frozen-default"
    cost: Overrides = ()
    kernels: Overrides = ()
    interference: Tuple[Tuple[Tuple[int, ...], Tuple[float, ...]], ...] = ()
    torch_auto_threshold: Optional[int] = None

    @classmethod
    def make(cls, *, platform: str = "default", source: str = "measured",
             cost=None, kernels=None, interference=None,
             torch_auto_threshold: Optional[int] = None
             ) -> "CalibrationProfile":
        """Build from plain dicts, validating field names eagerly (a typo'd
        override must fail at fit time, not silently at apply time)."""
        intf: Tuple = ()
        if interference:
            items = (interference.items() if isinstance(interference, dict)
                     else interference)
            intf = tuple(sorted(
                (tuple(int(i) for i in combo),
                 tuple(float(x) for x in fac)) for combo, fac in items))
        return cls(
            platform=platform, source=source,
            cost=_as_overrides(cost, COST_FIELDS, "CostParams"),
            kernels=_as_overrides(kernels, KERNEL_FIELDS, "KernelCoeffs"),
            interference=intf,
            torch_auto_threshold=(None if torch_auto_threshold is None
                                  else int(torch_auto_threshold)))

    # -- incremental updates -------------------------------------------------
    def with_cost(self, **overrides) -> "CalibrationProfile":
        """This profile with additional/updated ``CostParams`` overrides
        merged in.  Field names are validated; existing overrides for
        other fields are preserved."""
        merged = dict(self.cost)
        merged.update(overrides)
        return dataclasses.replace(
            self, cost=_as_overrides(merged, COST_FIELDS, "CostParams"))

    # -- application ---------------------------------------------------------
    def cost_params(self, base: CostParams = CostParams()) -> CostParams:
        """``base`` with this profile's overrides applied.  The no-override
        profile returns ``base`` ITSELF (not a copy) — the frozen-default
        guarantee the golden fixtures rely on."""
        if not self.cost and not self.kernels:
            return base
        kw: Dict[str, float] = dict(self.cost)
        out = dataclasses.replace(base, **kw) if kw else base
        if self.kernels:
            out = dataclasses.replace(
                out, kernels=base.kernels.replace(**dict(self.kernels)))
        return out

    def interference_model(self) -> InterferenceModel:
        m = InterferenceModel()
        if self.interference:
            m.factors = {tuple(c): tuple(f) for c, f in self.interference}
        return m

    # -- serialization -------------------------------------------------------
    def to_doc(self) -> Dict:
        return {
            "version": self.version,
            "platform": self.platform,
            "source": self.source,
            "cost": dict(self.cost),
            "kernels": dict(self.kernels),
            "interference": {",".join(str(i) for i in c): list(f)
                             for c, f in self.interference},
            "torch_auto_threshold": self.torch_auto_threshold,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        doc = json.loads(text)
        version = int(doc.get("version", 0))
        if version > PROFILE_VERSION:
            raise ValueError(f"calibration profile version {version} is "
                             f"newer than supported {PROFILE_VERSION}")
        bad = sorted(set(doc) - set(_DOC_KEYS))
        if bad:
            raise ValueError(f"unknown calibration profile key(s) {bad}; "
                             f"have {sorted(_DOC_KEYS)}")
        intf = {tuple(int(i) for i in key.split(",")): tuple(fac)
                for key, fac in (doc.get("interference") or {}).items()}
        return cls.make(
            platform=doc.get("platform", "default"),
            source=doc.get("source", "measured"),
            cost=doc.get("cost"), kernels=doc.get("kernels"),
            interference=intf,
            torch_auto_threshold=doc.get("torch_auto_threshold"))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path) -> "CalibrationProfile":
        return cls.from_json(Path(path).read_text())


DEFAULT_PROFILE = CalibrationProfile()


# -- discovery ---------------------------------------------------------------


def profile_dir() -> Path:
    env = os.environ.get(DIR_ENV)
    return Path(env).expanduser() if env else DEFAULT_DIR


def profile_path(platform: str) -> Path:
    return profile_dir() / f"{platform}.json"


def default_platform(device=None) -> str:
    """The platform of the device the caller uses: ``"cuda"`` unless it
    asks for the CPU (raises with no CUDA device, as every entry point of
    the port does)."""
    from repro_torch.models.common import resolve_device
    return resolve_device(device).type


def load_profile(platform: Optional[str] = None, path=None, *,
                 device=None) -> CalibrationProfile:
    """Resolve the active profile: explicit ``path`` >
    ``$REPRO_TORCH_CALIBRATION_PROFILE`` > the per-platform file under
    ``profile_dir()`` > the frozen ``DEFAULT_PROFILE``.  The platform
    defaults to that of ``device`` (``default_platform``)."""
    env_path = os.environ.get(PROFILE_ENV)
    if path is not None or env_path:
        return CalibrationProfile.load(path or env_path)
    f = profile_path(platform or default_platform(device))
    if f.exists():
        return CalibrationProfile.load(f)
    return DEFAULT_PROFILE
