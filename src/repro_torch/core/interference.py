"""Batched interference estimation — paper Algorithm 1, ported verbatim.

Four channels run concurrently on a chip: MXU compute (C), ICI collectives
(G2G), device->host DMA (D2H), host->device DMA (H2D).  Each combination of
co-running channels has slowdown factors; the algorithm progressively
resolves the overlap from 4-way concurrency down to 2-way, then adds the
serial remainder.

Vectorized over a leading batch of configurations (numpy arrays in, array
out), which is what makes Mist's brute-force intra-stage sweep cheap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

CHANNELS = ("C", "G2G", "D2H", "H2D")

# default slowdown factors per co-running combination, literature-informed
# (compute slows mildly under concurrent DMA/collectives; the two PCIe/DMA
# directions contend more strongly with each other).  ``calibrate`` refits
# these from measurements on real hardware.
_DEFAULT = {
    # 4-way
    (0, 1, 2, 3): (1.25, 1.30, 1.45, 1.45),
    # 3-way
    (0, 1, 2): (1.15, 1.20, 1.30),
    (0, 1, 3): (1.15, 1.20, 1.30),
    (0, 2, 3): (1.10, 1.35, 1.35),
    (1, 2, 3): (1.15, 1.35, 1.35),
    # 2-way
    (0, 1): (1.08, 1.12),
    (0, 2): (1.05, 1.15),
    (0, 3): (1.05, 1.15),
    (1, 2): (1.08, 1.20),
    (1, 3): (1.08, 1.20),
    (2, 3): (1.30, 1.30),
}


# packed-activity weights: channel i active contributes 1 << i, so a row's
# co-running pattern is one small int compared against each combo's code
_CODE_W = np.array([1, 2, 4, 8], np.int64)


@dataclass
class InterferenceModel:
    factors: Dict[Tuple[int, ...], Tuple[float, ...]] = field(
        default_factory=lambda: dict(_DEFAULT))

    def predict(self, c, g2g, d2h, h2d) -> np.ndarray:
        """Algorithm 1 (PredINTF): total latency of four concurrent streams.

        Inputs broadcastable arrays of per-channel serial times (e.g. the
        per-phase channel totals a compiled cost-model tape produces);
        returns the overlapped wall time per element.
        """
        x = np.stack(np.broadcast_arrays(
            np.asarray(c, np.float64), np.asarray(g2g, np.float64),
            np.asarray(d2h, np.float64), np.asarray(h2d, np.float64)), -1)
        return self.predict_stacked(x)

    def _tables(self):
        """Factor lookup tables indexed by packed activity code: per-channel
        slowdown (1.0 outside the combo), in-combo mask, and a validity bit
        for codes that have a factor set.  Rebuilt whenever the factor
        contents change — keyed on the dict's items, so both replacing the
        dict (calibrate) and mutating entries in place are detected."""
        src = tuple(self.factors.items())
        if getattr(self, "_tab_src", None) != src:
            F = np.ones((16, 4), np.float64)
            M = np.zeros((16, 4), bool)
            V = np.zeros(16, bool)
            for combo, fac in self.factors.items():
                if len(combo) < 2:      # Alg. 1 resolves levels 4..2 only;
                    continue            # a lone stream is never scaled
                code = int(_CODE_W[list(combo)].sum())
                F[code, list(combo)] = fac
                M[code, list(combo)] = True
                V[code] = True
            self._tab_src, self._tab = src, (F, M, V)
        return self._tab

    def predict_stacked(self, x: np.ndarray) -> np.ndarray:
        """Batched Alg. 1 on a pre-stacked (..., 4) channel array.

        Level-synchronous formulation: each pass resolves every row's
        current co-running combination at once (factor vectors gathered by
        the row's packed activity code), and resolving always deactivates
        the shortest stream, so three passes reach 2-way or done.  The
        per-row arithmetic is exactly the reference per-combo formulation,
        hence results are bitwise identical.
        """
        lead = x.shape[:-1]
        x = np.ascontiguousarray(x, np.float64).reshape(-1, 4)
        F, M, V = self._tables()
        t = np.zeros(x.shape[0], np.float64)
        for _ in range(3):                      # 4-way -> 3-way -> 2-way
            code = (x > 1e-12) @ _CODE_W
            valid = V[code]
            if not valid.any():
                break
            f = F[code]
            m = M[code]
            scaled = np.where(m, x * f, np.inf)
            overlap = np.where(valid, scaled.min(-1), 0.0)
            rem = np.where(m, (scaled - overlap[:, None]) / f, x)
            x = np.where(valid[:, None], rem, x)
            t += overlap
        return (t + x.sum(-1)).reshape(lead)

    def predict_reference(self, c, g2g, d2h, h2d) -> np.ndarray:
        """The pre-refactor per-combination mask formulation, kept verbatim
        as the legacy-engine baseline (benchmarks/tuning_time.py measures
        the compiled engine against it).  Bitwise identical to `predict`
        — `tests/test_interference.py` asserts it."""
        import itertools
        x = np.stack(np.broadcast_arrays(
            np.asarray(c, np.float64), np.asarray(g2g, np.float64),
            np.asarray(d2h, np.float64), np.asarray(h2d, np.float64)), -1)
        x = x.copy()
        t = np.zeros(x.shape[:-1], np.float64)
        for n in range(4, 1, -1):                      # concurrency level
            for combo in itertools.combinations(range(4), n):
                fac = self.factors.get(combo)
                if fac is None:          # partial factor sets: no overlap
                    continue             # data at this level -> resolved
                mask = np.zeros(4, bool)  # pairwise (or serially) later
                mask[list(combo)] = True
                factors = np.asarray(fac, np.float64)
                self._update(x, t, mask, factors, combo)
        t += x.sum(-1)                                 # serial remainder
        return t

    @staticmethod
    def _update(x, t, mask, factors, combo):
        active = x > 1e-12
        ids = (active == mask).all(-1)                 # rows matching combo
        if not ids.any():
            return
        scaled = x[ids][:, list(combo)] * factors
        overlap = scaled.min(-1)
        rem = (scaled - overlap[:, None]) / factors
        xi = x[ids]
        xi[:, list(combo)] = rem
        x[ids] = xi
        t[ids] += overlap

    # -- data-driven fitting --------------------------------------------------
    def calibrate(self, samples) -> float:
        """Fit slowdown factors from measured (times, wall) pairs.

        samples: list of ((c, g2g, d2h, h2d), measured_wall).  Returns the
        post-fit mean relative error.  Minimizes squared wall error with
        Nelder-Mead over the factor offsets (scipy when available, a pure
        numpy simplex otherwise — the calibration subsystem must run in
        environments without scipy)."""
        keys = sorted(self.factors)
        sizes = [len(self.factors[k]) for k in keys]

        def loss(theta):
            m = InterferenceModel(factors={
                k: tuple(1.0 + max(v, 0.0) for v in theta[i:i + n])
                for (k, n, i) in zip(keys, sizes,
                                     np.cumsum([0] + sizes[:-1]))})
            err = 0.0
            for (ch, wall) in samples:
                pred = m.predict(*ch)
                err += float((pred - wall) ** 2)
            return err

        x0 = np.concatenate([np.asarray(self.factors[k]) - 1.0 for k in keys])
        th = _minimize_simplex(loss, x0, maxiter=2000, fatol=1e-12)
        offs = np.cumsum([0] + sizes[:-1])
        self.factors = {
            k: tuple(1.0 + max(v, 0.0) for v in th[i:i + n])
            for (k, n, i) in zip(keys, sizes, offs)}
        rel = []
        for (ch, wall) in samples:
            pred = float(self.predict(*ch))
            rel.append(abs(pred - wall) / max(wall, 1e-12))
        return float(np.mean(rel))


def _scipy_minimize(loss, x0, *, maxiter, fatol) -> np.ndarray:
    import scipy.optimize as so

    res = so.minimize(loss, x0, method="Nelder-Mead",
                      options={"maxiter": maxiter, "fatol": fatol})
    return np.asarray(res.x, np.float64)


def _minimize_simplex(loss, x0, *, maxiter=2000, fatol=1e-12) -> np.ndarray:
    """Nelder-Mead with graceful degradation: scipy's implementation when
    installed, else the pure-numpy fallback below (same initial simplex
    convention, so the two paths converge to comparable minima)."""
    try:
        return _scipy_minimize(loss, x0, maxiter=maxiter, fatol=fatol)
    except ImportError:
        return _nelder_mead(loss, x0, maxiter=maxiter, fatol=fatol)


def _nelder_mead(loss, x0, *, maxiter=2000, fatol=1e-12) -> np.ndarray:
    """Compact downhill-simplex (Nelder & Mead 1965) — standard reflection /
    expansion / contraction / shrink coefficients and scipy's initial-simplex
    construction (each vertex perturbs one coordinate by 5%, or 0.00025 for
    zero coordinates)."""
    x0 = np.asarray(x0, np.float64)
    n = x0.size
    simplex = np.tile(x0, (n + 1, 1))
    for i in range(n):
        if simplex[i + 1, i] != 0.0:
            simplex[i + 1, i] *= 1.05
        else:
            simplex[i + 1, i] = 0.00025
    f = np.array([loss(v) for v in simplex])
    for _ in range(maxiter):
        order = np.argsort(f, kind="stable")
        simplex, f = simplex[order], f[order]
        if abs(f[-1] - f[0]) <= fatol:
            break
        centroid = simplex[:-1].mean(0)
        xr = centroid + (centroid - simplex[-1])           # reflect
        fr = loss(xr)
        if fr < f[0]:
            xe = centroid + 2.0 * (centroid - simplex[-1])  # expand
            fe = loss(xe)
            simplex[-1], f[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < f[-2]:
            simplex[-1], f[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)  # contract
            fc = loss(xc)
            if fc < f[-1]:
                simplex[-1], f[-1] = xc, fc
            else:                                           # shrink
                simplex[1:] = simplex[0] + 0.5 * (simplex[1:] - simplex[0])
                f[1:] = [loss(v) for v in simplex[1:]]
    return simplex[int(np.argmin(f))]


DEFAULT_MODEL = InterferenceModel()


def pred_intf(c, g2g, d2h, h2d, model: Optional[InterferenceModel] = None
              ) -> np.ndarray:
    return (model or DEFAULT_MODEL).predict(c, g2g, d2h, h2d)
