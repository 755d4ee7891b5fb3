"""Golden-plan fixtures, read by the port: the pinned fingerprints of the
tuner's selected plan + objective for every search-space preset (the
port's copy of ``repro/core/golden.py``).

The reference writes one fixture per (SPACES preset, model config) cell
under ``tests/golden/`` (``python tools/regen_golden.py``); the port only
reads them.  ``compute_doc`` runs the port's tuner for one cell and
canonicalizes the result exactly as the reference does, so equal
fingerprints mean the port selected the reference's plan with the same
objective (``%.12g``) on every (S, G) cell.  The hardware spec is an
argument: the fixtures were made with the reference's TPU spec, which the
parity test rebuilds from the reference's values; the port's own default
is the H100.

Fingerprints are sha256 over a canonical JSON document.  Floats are
formatted with ``%.12g`` — coarse enough to absorb last-ulp noise across
BLAS/platforms, fine enough that any real modeling change flips the
fingerprint.  The selection itself depends on the MILP solver's
tie-breaking on degenerate-optimum cells, so the fixtures hold only under
the scipy minor they were generated with.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import get_arch
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.tuner import SPACES, MistTuner, TuneSpec

# the reference pins a dense GQA decoder and an MoE
GOLDEN_ARCHS: Tuple[str, ...] = ("granite-3-8b", "qwen2-moe-a2.7b")
GOLDEN_SPACES: Tuple[str, ...] = SPACES

# small but non-trivial workload: 8 devices leave room for S in {1, 2}
# and a real (dp, tp, zero, ckpt, offload) grid per stage
_WORKLOAD = dict(seq_len=2048, global_batch=16, n_devices=8,
                 stage_counts=(1, 2), grad_accums=(2, 4))

GOLDEN_DIR = Path(__file__).resolve().parents[3] / "tests" / "golden"


def golden_spec(space: str, arch: str) -> TuneSpec:
    return TuneSpec(arch=get_arch(arch), space=space, **_WORKLOAD)


def golden_path(space: str, arch: str, base: Optional[Path] = None) -> Path:
    return (base or GOLDEN_DIR) / f"{space}__{arch.replace('.', 'p')}.json"


def _fmt(x: float) -> str:
    return f"{float(x):.12g}"


def compute_doc(space: str, arch: str, hw: HardwareSpec = H100) -> Dict:
    """Run the tuner for one golden cell on ``hw`` and canonicalize its
    result."""
    rep = MistTuner(golden_spec(space, arch), hw=hw).tune()
    plan = None
    if rep.plan is not None:
        plan = json.loads(rep.plan.to_json())
    return {
        "space": space,
        "arch": arch,
        "workload": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in _WORKLOAD.items()},
        "objective": _fmt(rep.objective),
        "best_S": rep.best_S,
        "best_G": rep.best_G,
        "infeasible": rep.infeasible,
        "per_sg": [[S, G, _fmt(obj)] for S, G, obj in rep.per_sg],
        "plan": plan,
    }


def fingerprint(doc: Dict) -> str:
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def diff_docs(want: Dict, got: Dict, prefix: str = "") -> List[str]:
    """Readable field-level differences between two golden documents."""
    if type(want) is not type(got):
        return [f"{prefix or '<root>'}: {want!r} != {got!r}"]
    if isinstance(want, dict):
        out: List[str] = []
        for k in sorted(set(want) | set(got)):
            p = f"{prefix}.{k}" if prefix else str(k)
            if k not in want:
                out.append(f"{p}: <absent in golden> != {got[k]!r}")
            elif k not in got:
                out.append(f"{p}: {want[k]!r} != <absent>")
            else:
                out.extend(diff_docs(want[k], got[k], p))
        return out
    if isinstance(want, list):
        if len(want) != len(got):
            return [f"{prefix}: length {len(want)} != {len(got)}"]
        out = []
        for i, (a, b) in enumerate(zip(want, got)):
            out.extend(diff_docs(a, b, f"{prefix}[{i}]"))
        return out
    if want != got:
        return [f"{prefix}: {want!r} != {got!r}"]
    return []
