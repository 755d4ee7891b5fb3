"""Content-addressed on-disk store for frontier memos and tune reports.

The in-process frontier memo (`MistTuner._frontier_memo`) becomes a
persistent cache shared across `tune()` calls and processes.  Two entry
kinds live under one directory (`TuneSpec.memo_dir` /
`launch/train.py --memo-dir`):

  units/<hh>/<hash>.pkl    one IntraStageResult — a stage-hypothesis
                           frontier, keyed by unit_key()
  reports/<hh>/<hash>.pkl  one TuneReport — a whole solved query,
                           keyed by report_key()

Keys are sha256 digests of canonical JSON (tuples→lists, dataclasses→
sorted dicts, floats via repr for bit-exactness), so equality is
structural — no pickle-bytes fragility — and any semantic input change
moves the address:

* ``unit_key`` covers the tuner fingerprint (arch config, workload
  shape, hardware spec, post-profile CostParams **including kernel
  coeffs**, the calibration profile document itself, max_tp/max_front)
  plus the tuner's ``_memo_key`` (layers, n_dev, G, role, inflight, knob
  grids, kernel grid).  Changing the hardware, a calibration profile,
  the knob grid, or the kernel grid therefore *invalidates* — old
  entries are simply never addressed again.
* ``report_key`` covers the whole TuneSpec **minus** the
  execution-routing fields (engine, backend, device, workers, hosts,
  memo_dir): those do not change the selected plan (every engine,
  backend and worker count selects the same plan bitwise), so a report
  computed with any routing serves every routing.  scipy's version is
  folded in because HiGHS tie-breaking is part of the answer.

Schema changes bump MEMO_SCHEMA_VERSION, which is folded into every
digest — old trees are abandoned in place, never misread.  The port's
entries pickle the port's classes, so its schema tag names the port: a
directory shared with the reference's store never serves one package's
entries to the other.

Concurrency/corruption: writes go to a same-directory temp file then
``os.replace`` (atomic on POSIX), so readers never observe partial
entries; a corrupt or truncated entry is treated as a miss (and
unlinked) rather than an error.  Multiple writers racing on one key
write identical bytes, so last-writer-wins is harmless.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import tempfile
from typing import Dict, Optional, Tuple

MEMO_SCHEMA_VERSION = "repro_torch/1"


def _canonical(obj):
    """Reduce to JSON-able structure with deterministic ordering.  Floats
    go through repr(): round-trip exact, so 0.75*2**30 and 805306368.0
    hash identically iff they are the same double."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dc__": type(obj).__name__,
                **{f.name: _canonical(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {"__map__": sorted((json.dumps(_canonical(k), sort_keys=True),
                                   _canonical(v)) for k, v in obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(x) for x in obj]
    if isinstance(obj, float):
        return {"__f__": repr(obj)}
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    # anything exotic (e.g. numpy scalar) — stringify rather than crash;
    # worst case is a needless cache miss, never a false hit
    return {"__repr__": type(obj).__name__ + ":" + repr(obj)}


def digest(obj) -> str:
    doc = json.dumps(_canonical(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()


def _scipy_version() -> Optional[str]:
    try:
        import scipy
        return scipy.__version__
    except Exception:
        return None


def tuner_fingerprint(tuner) -> Dict:
    """Everything besides the memo key that determines a unit's frontier.
    ``tuner.cp`` is post-profile (MistTuner applies overrides in
    __init__), and the profile document is folded in anyway so
    interference/torch_auto_threshold overrides also move the address."""
    spec = tuner.spec
    return {
        "schema": MEMO_SCHEMA_VERSION,
        "arch": tuner.spec.arch,
        "seq_len": spec.seq_len,
        "global_batch": spec.global_batch,
        "max_tp": spec.max_tp,
        "max_front": spec.max_front,
        "imbalance_aware": spec.imbalance_aware,
        "hw": tuner.hw,
        "cp": tuner.cp,
        "profile": spec.profile.to_doc() if spec.profile is not None else None,
    }


def unit_key(fingerprint: Dict, memo_key: Tuple) -> str:
    return digest({"fp": fingerprint, "memo_key": memo_key})


# TuneSpec fields that route execution without affecting the answer —
# excluded from report_key so a report computed under any (engine,
# backend, workers, hosts) combination serves all of them.
_EXEC_FIELDS = ("engine", "backend", "device", "workers", "hosts",
                "memo_dir")


def report_key(tuner) -> str:
    spec = tuner.spec
    doc = {f.name: getattr(spec, f.name)
           for f in dataclasses.fields(spec) if f.name not in _EXEC_FIELDS}
    doc["profile"] = (spec.profile.to_doc()
                      if spec.profile is not None else None)
    return digest({"schema": MEMO_SCHEMA_VERSION, "spec": doc,
                   "hw": tuner.hw, "cp": tuner.cp,
                   "scipy": _scipy_version()})


class MemoStore:
    """Directory-backed content-addressed store; all methods are safe to
    call concurrently from multiple processes."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.unit_hits = 0
        self.unit_misses = 0
        self.report_hits = 0

    # -- raw entry IO --------------------------------------------------------
    def _path(self, kind: str, key: str) -> str:
        return os.path.join(self.root, kind, key[:2], key + ".pkl")

    def _get(self, kind: str, key: str):
        path = self._path(kind, key)
        try:
            with open(path, "rb") as f:
                value = pickle.load(f)
            # refresh the entry's timestamp on every hit so gc() evicts
            # by last ACCESS, not write order (atime is unreliable under
            # noatime mounts; mtime is ours to repurpose)
            try:
                os.utime(path)
            except OSError:
                pass
            return value
        except FileNotFoundError:
            return None
        except Exception:
            # truncated/corrupt entry: treat cold and clear the slot so the
            # refreshed write below isn't racing a poisoned file forever
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    def _put(self, kind: str, key: str, value) -> None:
        path = self._path(kind, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def count(self, kind: str = "units") -> int:
        n = 0
        base = os.path.join(self.root, kind)
        for dirpath, _dirs, files in os.walk(base):
            n += sum(f.endswith(".pkl") for f in files)
        return n

    def gc(self, max_bytes: int) -> Dict[str, int]:
        """Prune the store down to ``max_bytes``, oldest-ACCESS entries
        first (``_get`` refreshes an entry's timestamp on every hit).

        Each eviction is one atomic ``unlink``: a reader racing a gc sees
        either the whole entry or a miss, never a partial file.  Entries
        that vanish mid-scan (another gc, a writer's ``os.replace``) are
        skipped.  Returns {scanned, removed, bytes_before, bytes_after}.
        """
        if max_bytes < 0:
            raise ValueError("max_bytes must be >= 0")
        entries = []          # (mtime, size, path)
        for kind in ("units", "reports"):
            base = os.path.join(self.root, kind)
            for dirpath, _dirs, files in os.walk(base):
                for f in files:
                    if not f.endswith(".pkl"):
                        continue
                    path = os.path.join(dirpath, f)
                    try:
                        st = os.stat(path)
                    except OSError:
                        continue
                    entries.append((st.st_mtime, st.st_size, path))
        total = sum(e[1] for e in entries)
        stats = {"scanned": len(entries), "removed": 0,
                 "bytes_before": total, "bytes_after": total}
        entries.sort()
        for _mtime, size, path in entries:
            if stats["bytes_after"] <= max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue               # already gone: someone else's gc
            stats["removed"] += 1
            stats["bytes_after"] -= size
        return stats

    # -- frontier-memo units -------------------------------------------------
    def preload(self, tuner, cells, knobs) -> int:
        """Load warm stage-hypothesis frontiers into the tuner's in-memory
        memo so `plan_units` drops them from the sweep.  Enumerates
        exactly the keys the (S, G) loop will need (via `plan_units` on a
        scratch view) and returns the number of entries loaded."""
        from repro_torch.core.sweep import plan_units
        fp = tuner_fingerprint(tuner)
        plan = plan_units(tuner, cells, knobs)
        loaded = 0
        for i, unit in enumerate(plan.units):
            layers, n_dev, role, inflight = unit
            for G in plan.gs_per_unit[i]:
                memo_key = tuner._memo_key(
                    layers=layers, n_dev=n_dev, G=G, role=role,
                    inflight=inflight, knobs=knobs)
                res = self._get("units", unit_key(fp, memo_key))
                if res is not None:
                    tuner._frontier_memo[memo_key] = res
                    loaded += 1
                    self.unit_hits += 1
                else:
                    self.unit_misses += 1
        return loaded

    def flush(self, tuner, cells, knobs) -> int:
        """Persist the frontiers this tune populated for the given cells.
        Re-derives the needed memo keys the same way preload did (the
        in-memory memo may also hold entries for other knob grids from
        earlier tune() calls on the same tuner; those were flushed by
        their own tune).  Returns the number of entries written."""
        from repro_torch.core.sweep import SweepPlan, plan_units  # noqa: F401
        fp = tuner_fingerprint(tuner)
        spec = tuner.spec
        L, N = spec.arch.num_layers, spec.n_devices
        written = 0
        seen = set()

        def flush_one(layers, n_dev, role, inflight, G):
            nonlocal written
            memo_key = tuner._memo_key(layers=layers, n_dev=n_dev, G=G,
                                       role=role, inflight=inflight,
                                       knobs=knobs)
            if memo_key in seen:
                return
            seen.add(memo_key)
            res = tuner._frontier_memo.get(memo_key)
            if res is None:
                return
            key = unit_key(fp, memo_key)
            if self._get("units", key) is None:
                self._put("units", key, res)
                written += 1

        for S, G in cells:
            if spec.space == "uniform" and S > 1:
                if L % S or N % S:
                    continue
                flush_one(L // S, N // S, (True, True), float(S), G)
                continue
            for i in range(S):
                role = (i == 0, i == S - 1)
                inflight = float(S - i)
                for lyr in tuner._layer_options(S):
                    flush_one(lyr, N // S, role, inflight, G)
        return written

    # -- whole-report cache (the millisecond warm path) ----------------------
    def load_report(self, tuner):
        rep = self._get("reports", report_key(tuner))
        if rep is not None:
            self.report_hits += 1
        return rep

    def save_report(self, tuner, report) -> None:
        self._put("reports", report_key(tuner), report)
