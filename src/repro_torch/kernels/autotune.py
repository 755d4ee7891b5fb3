"""Kernel-config autotuning on Hopper: legality, bench-and-cache, verify,
calibration (the port of ``repro/kernels/autotune.py``).

The concrete half of the kernel-config plan dimension.  The symbolic half
lives in the cost model: ``core/costmodel.py`` compiles the shared
formulas (``core/costmodel_params.kernel_time_terms`` /
``kernel_smem_terms``) over the ``qb``/``kvb``/``rnb``/``sch`` knob
symbols, so the candidate grid prices tile choices by tape.  This module:

* **enumerates the legal grid** (`legal_kernel_grid`): tuples of the Hopper
  tile menu (``kernels/tiles.py``: what the kernels launch, forward and
  backward), each non-default tile dividing the sequence, each op's shared
  memory a block within ``max(hw.vmem_bytes, smem(default))`` (the cost
  model's feasibility mask), ranked by the concrete roofline and capped,
  the default tuple always first;
* **benches the kernels** (`bench_config`): on a CUDA device the Hopper
  kernels, forward and backward, timed with CUDA events after a warm-up;
  on the CPU their plain versions (as the reference times interpret mode
  off the TPU); memoized in a JSON cache keyed by (op, shape, tiles,
  backend);
* **verifies selections** (`verify_config`): on the card every kernel the
  arch uses, at the chosen tiles, forward and backward, against its plain
  version; on the CPU the plain versions, finite and of the right shape;
* **calibrates the roofline** (`calibrate`): anchors the per-kernel
  ``*_scale`` so predicted(default) == measured(default).  The cost model
  prices kernels as a delta against the default config, so calibration
  reshapes the sweep without moving any frozen-default plan.

Everything but the bench/verify functions is pure python (torch is
imported inside them), importable from the sweep workers.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import time
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional, Tuple

from repro_torch.core.costmodel_params import (KERNEL_CONCRETE_OPS,
                                               KernelCoeffs,
                                               kernel_smem_terms,
                                               kernel_time_terms, ssd_dims)
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.plan import DEFAULT_KERNEL_CONFIG, KernelConfig
from repro_torch.kernels import tiles

if TYPE_CHECKING:
    from repro_torch.configs.base import ArchConfig

KernelTuple = Tuple[int, int, int, int]   # (qb, kvb, rnb, sch)

# the tolerances chip_smoke.py holds each kernel to against its plain
# version: bf16 outputs, the flash lse, the flash gradients (elementwise,
# and max err / max |ref|), the SSD gradients (max err / max |ref|)
BF16_TOL = dict(atol=2e-2, rtol=3e-2)
LSE_TOL = dict(atol=1e-3, rtol=1e-3)
FLASH_BWD_TOL = dict(atol=5e-2, rtol=5e-2)
FLASH_BWD_REL = 1e-2
SSD_BWD_REL = 1e-2


# ---------------------------------------------------------------------------
# concrete roofline prediction (shared formulas, float ops)
# ---------------------------------------------------------------------------


def predict_times(cfg: "ArchConfig", *, seq_len: int,
                  config: KernelConfig = DEFAULT_KERNEL_CONFIG,
                  b: float = 1.0, tp: float = 1.0, sp_div: float = 1.0,
                  hw: HardwareSpec = H100,
                  kc: Optional[KernelCoeffs] = None) -> Dict[str, float]:
    """Per-layer per-microbatch kernel seconds by op, evaluated with the
    SAME formulas (same arithmetic order) the cost model tapes -- over
    floats instead of ``Expr``s, so symbolic and concrete evaluation agree
    bitwise at equal bindings."""
    kc = kc if kc is not None else KernelCoeffs()
    sd_h, sd_p, sd_n = ssd_dims(cfg)
    qb, kvb, rnb, sch = (float(v) for v in config.astuple())
    terms = kernel_time_terms(
        seq=seq_len, b=float(b), tp=float(tp), sp_div=float(sp_div),
        qb=qb, kvb=kvb, rnb=rnb, sch=sch,
        num_heads=cfg.num_heads, head_dim=cfg.head_dim, d_model=cfg.d_model,
        ssd_heads=sd_h, ssd_head_dim=sd_p, ssd_state=sd_n,
        hbm_bw=hw.hbm_bw, peak_flops=hw.peak_flops_bf16, kc=kc,
        ops=KERNEL_CONCRETE_OPS, tile_edge=float(hw.mxu_min_dim))
    attn_frac = _attn_frac(cfg)
    total = terms["rms"]
    if attn_frac:
        total = total + attn_frac * terms["attn"]
    if sd_h:
        total = total + terms["ssd"]
    return {"attn": terms["attn"], "rms": terms["rms"], "ssd": terms["ssd"],
            "total": total}


def _attn_frac(cfg: "ArchConfig") -> float:
    # mirrors core/costmodel.arch_stats gating without importing it
    if cfg.family == "hybrid":
        return 1.0 / cfg.shared_attn_every if cfg.shared_attn_every else 0.0
    if cfg.family == "ssm":
        return 0.0
    return 1.0


def predict_smem(cfg: "ArchConfig",
                 config: KernelConfig = DEFAULT_KERNEL_CONFIG
                 ) -> Dict[str, float]:
    """Per-op shared memory a block (bytes), forward and backward's larger:
    the concrete twin of the cost model's ``vmem_peak`` tape output."""
    _sd_h, sd_p, sd_n = ssd_dims(cfg)
    qb, kvb, rnb, sch = (float(v) for v in config.astuple())
    return kernel_smem_terms(qb=qb, kvb=kvb, rnb=rnb, sch=sch,
                             head_dim=cfg.head_dim, d_model=cfg.d_model,
                             ssd_head_dim=sd_p, ssd_state=sd_n,
                             ops=KERNEL_CONCRETE_OPS)


# the reference's name
predict_vmem = predict_smem


# ---------------------------------------------------------------------------
# legal grid enumeration
# ---------------------------------------------------------------------------


def field_values(cfg: "ArchConfig", seq_len: int) -> Dict[str, Tuple]:
    """The plan values the grid draws each field from: the reference's
    default first, then every Hopper menu entry that runs another tile,
    launches at the arch's dims (flash head dim; SSD P and N, forward and
    backward) and divides ``seq_len``."""
    d = DEFAULT_KERNEL_CONFIG
    out = {}
    for f in ("attn_q_block", "attn_kv_block", "rmsnorm_block"):
        menu = tiles.MENU[f]
        if f == "attn_kv_block":
            menu = tiles.kv_block_menu(cfg.head_dim) if _attn_frac(cfg) \
                else ()
        if f == "attn_q_block" and not _attn_frac(cfg):
            menu = ()
        out[f] = (getattr(d, f),) + tuple(
            v for v in menu if v != tiles.HOPPER_DEFAULT[f]
            and seq_len % v == 0)
    sd_h, sd_p, sd_n = ssd_dims(cfg)
    chunks = tiles.ssd_chunk_menu(sd_p, sd_n) if sd_h else ()
    out["ssd_chunk"] = (d.ssd_chunk,) + tuple(
        c for c in chunks if c != d.ssd_chunk and seq_len % c == 0)
    return out


def legal_kernel_grid(cfg: "ArchConfig", *, seq_len: int,
                      hw: HardwareSpec = H100, cp=None,
                      max_tuples: int = 8) -> Tuple[KernelTuple, ...]:
    """The (qb, kvb, rnb, sch) tuples the tuner sweeps jointly with every
    candidate: tuples of ``field_values`` (each a tile the kernels launch,
    forward and backward), per-op shared memory a block within
    ``max(hw.vmem_bytes, smem(default))`` -- the floored budget the cost
    model's feasibility mask uses, so the default tuple is always legal --
    ranked by the concrete roofline (the formula the tapes compile) and
    capped at ``max_tuples``, the default tuple first.  Deterministic:
    sweep workers recompute it from the pickled spec and must agree."""
    kc = cp.kernels if cp is not None else KernelCoeffs()
    d = DEFAULT_KERNEL_CONFIG
    sdef = predict_smem(cfg, d)
    budget = {op: max(float(hw.vmem_bytes), v) for op, v in sdef.items()}
    vals = field_values(cfg, seq_len)

    scored = []
    for qb in vals["attn_q_block"]:
        for kvb in vals["attn_kv_block"]:
            for rnb in vals["rmsnorm_block"]:
                for sch in vals["ssd_chunk"]:
                    kcfg = KernelConfig(qb, kvb, rnb, sch)
                    sm = predict_smem(cfg, kcfg)
                    if any(sm[op] > budget[op] for op in sm):
                        continue
                    t = predict_times(cfg, seq_len=seq_len, hw=hw, kc=kc,
                                      config=kcfg)["total"]
                    scored.append((t, kcfg.astuple()))
    scored.sort(key=lambda e: (e[0], e[1]))

    default = d.astuple()
    grid: list = [default]
    for _t, tup in scored:
        if tup != default and len(grid) < max(1, int(max_tuples)):
            grid.append(tup)
    return tuple(grid)


# ---------------------------------------------------------------------------
# bench-and-cache
# ---------------------------------------------------------------------------

# the cache's default place: the git-ignored build/ of the checkout
_DEF_CACHE = Path(__file__).resolve().parents[3] / "build" \
    / "kernel_bench.json"


def _cache_path(path=None) -> Path:
    p = path or os.environ.get("REPRO_TORCH_KERNEL_BENCH_CACHE", _DEF_CACHE)
    return Path(p).expanduser()


def _load_cache(path: Path) -> Dict[str, float]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_cache(path: Path, cache: Dict[str, float]) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                      # the cache is an accelerator, never a gate


# a device-side spin ahead of each timed call (~0.5 ms on an H100), longer
# than the host takes to enqueue the call: the events bracket device work
SPIN_CYCLES = 1_000_000


def time_call(fn, device: str, reps: int = 3, warmup: int = 2) -> float:
    """Median seconds of one call after ``warmup`` calls (the first builds
    the kernels).  CUDA: per-call CUDA events behind a spin kernel, as
    ``chip_smoke.time_ms(device_only=True)`` times, inputs as warm in L2
    as the calls before left them.  CPU: wall time."""
    import torch

    for _ in range(max(1, warmup)):
        fn()
    ts = []
    for _ in range(max(1, reps)):
        if device == "cuda":
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _device(device) -> str:
    """"cuda" or "cpu": ``device``'s type, or a CUDA device where there is
    one."""
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def _backend(device: str) -> str:
    import torch

    if device == "cuda":
        return "cuda:" + torch.cuda.get_device_name(0).replace(" ", "_")
    return "cpu"


def _bench_shapes(cfg: "ArchConfig", seq_len: int):
    """Small-but-representative bench shapes (the reference's): a few
    heads and up to 2048 rows rank tiles; measurements calibrate per-op
    scales, not absolute throughput."""
    seq = min(int(seq_len), 2048)
    heads = min(max(1, cfg.num_heads), 4)
    return seq, heads


def _inputs(cfg: "ArchConfig", seq: int, heads: int, device: str, seed: int):
    """bf16 inputs of each op the arch runs at the bench shapes, made from
    ``seed`` on ``device``: flash q/k/v/dO (GQA kept), RMSNorm x/scale/dy,
    SSD x/dt/a/B/C/dy (B, C shared by the heads)."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    out = {}
    if _attn_frac(cfg):
        hd = cfg.head_dim
        kv = max(1, heads // max(1, cfg.q_per_kv))
        out["attn"] = (rn(1, seq, heads, hd), rn(1, seq, kv, hd),
                       rn(1, seq, kv, hd), rn(1, seq, heads, hd))
    out["rms"] = (rn(seq, cfg.d_model),
                  1.0 + 0.1 * rn(cfg.d_model), rn(seq, cfg.d_model))
    sd_h, sd_p, sd_n = ssd_dims(cfg)
    if sd_h:
        hs = min(sd_h, 4)
        row = torch.randn((1, seq, hs * sd_p + 2 * sd_n), generator=g,
                          device=device).to(bf)
        x = row[..., :hs * sd_p].reshape(1, seq, hs, sd_p)
        bb = row[..., hs * sd_p:hs * sd_p + sd_n].reshape(1, seq, 1, sd_n)
        cc = row[..., hs * sd_p + sd_n:].reshape(1, seq, 1, sd_n)
        dt = torch.nn.functional.softplus(
            torch.randn((1, seq, hs), generator=g, device=device))
        a = -torch.exp(0.5 * torch.randn((hs,), generator=g, device=device))
        out["ssd"] = (x, dt, a, bb, cc, rn(1, seq, hs, sd_p))
    return out


def _ops(kcfg: KernelConfig, impl: str):
    """Forward and backward thunk makers per op at ``kcfg``'s tiles, through
    the public wrappers (``impl`` "kernel": the Hopper kernels on CUDA
    tensors, the plain versions on CPU ones)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS

    qb, kvb, rnb = kcfg.attn_q_block, kcfg.attn_kv_block, kcfg.rmsnorm_block

    def attn_fwd(q, k, v, _do):
        return FA.flash_attention(q, k, v, causal=True, q_block=qb,
                                  kv_block=kvb, impl=impl)

    def attn_bwd(q, k, v, do, o, lse):
        return FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                      q_block=qb, kv_block=kvb, impl=impl)

    def rms_fwd(x, s, _dy):
        return RN.rmsnorm(x, s, impl=impl, block=rnb)

    def rms_bwd(x, s, dy):
        return RN.rmsnorm_bwd(x, s, dy, impl=impl)

    def ssd_fwd(x, dt, a, bb, cc, _dy):
        return SS.SSDScan.apply(x, dt, a, bb, cc, kcfg.ssd_chunk, impl)

    def ssd_grads(x, dt, a, bb, cc, dy):
        import torch

        leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bb, cc)]
        y, _ = SS.SSDScan.apply(*leaves, kcfg.ssd_chunk, impl)
        return torch.autograd.grad(y, leaves, dy)

    return dict(attn_fwd=attn_fwd, attn_bwd=attn_bwd, rms_fwd=rms_fwd,
                rms_bwd=rms_bwd, ssd_fwd=ssd_fwd, ssd_grads=ssd_grads)


def bench_config(cfg: "ArchConfig", *, seq_len: int,
                 config: KernelConfig = DEFAULT_KERNEL_CONFIG,
                 reps: int = 3, cache_path=None, refresh: bool = False,
                 device: Optional[str] = None) -> Dict[str, float]:
    """Measured seconds per op for one kernel config: ``attn``, ``rms``,
    ``ssd`` (the forwards, what the roofline prices) and ``attn_bwd``,
    ``rms_bwd``, ``ssd_bwd`` (the backwards; the SSD's with its forward,
    through its autograd Function), for the ops the arch runs.  On a CUDA
    device (the default where there is one) the Hopper kernels at the
    config's tiles; on the CPU the plain versions.  Memoized in a JSON
    cache keyed by (op, shape, tiles, backend)."""
    import torch

    device = _device(device)
    backend = _backend(device)
    kcfg = config
    qr, kn, rw, sch = (tiles.hopper_tiles(kcfg) if device == "cuda"
                       else kcfg.astuple())
    seq, heads = _bench_shapes(cfg, seq_len)
    sd_h, sd_p, sd_n = ssd_dims(cfg)
    path = _cache_path(cache_path)
    cache = {} if refresh else _load_cache(path)
    out: Dict[str, float] = {}
    dirty = False

    def measure(key: str, thunk) -> float:
        nonlocal dirty
        if not refresh and key in cache:
            return float(cache[key])
        val = time_call(thunk, device, reps=reps)
        cache[key] = val
        dirty = True
        return val

    ops = _ops(kcfg, "kernel")
    data = _inputs(cfg, seq, heads, device, seed=0)
    with torch.no_grad():
        if "attn" in data:
            q, k, v, do = data["attn"]
            shape = f"s{seq}:h{heads}:kv{k.shape[2]}:d{cfg.head_dim}"
            tile = f"q{qr}:k{kn}"
            out["attn"] = measure(f"attn:{backend}:{shape}:{tile}",
                                  lambda: ops["attn_fwd"](q, k, v, do))
            o, lse = ops["attn_fwd"](q, k, v, do)
            out["attn_bwd"] = measure(
                f"attn_bwd:{backend}:{shape}:{tile}",
                lambda: ops["attn_bwd"](q, k, v, do, o, lse))
        x, s, dy = data["rms"]
        key = f"r{seq}:d{cfg.d_model}:b{rw}"
        out["rms"] = measure(f"rms:{backend}:{key}",
                             lambda: ops["rms_fwd"](x, s, dy))
        out["rms_bwd"] = measure(f"rms_bwd:{backend}:r{seq}:d{cfg.d_model}",
                                 lambda: ops["rms_bwd"](x, s, dy))
        if sd_h:
            args = data["ssd"]
            key = f"s{seq}:h{args[0].shape[2]}:p{sd_p}:n{sd_n}:c{sch}"
            out["ssd"] = measure(f"ssd:{backend}:{key}",
                                 lambda: ops["ssd_fwd"](*args))
    if sd_h:
        args = data["ssd"]
        out["ssd_bwd"] = measure(f"ssd_fwd_bwd:{backend}:{key}",
                                 lambda: ops["ssd_grads"](*args))
    if dirty:
        _store_cache(path, cache)
    return out


def _close(got, want, atol, rtol) -> Tuple[bool, float]:
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(((err <= atol + rtol * want.abs()) & torch.isfinite(got)).all())
    return ok, float(err.max()) if err.numel() else 0.0


def _rel_close(got, want, rel) -> Tuple[bool, float]:
    import torch

    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    return bool(torch.isfinite(got).all()) and err <= rel * top, err


def verify_config(cfg: "ArchConfig", *, seq_len: int, config: KernelConfig,
                  device: Optional[str] = None,
                  report: Optional[Dict[str, float]] = None) -> bool:
    """The gate for a tuner-selected config: every kernel the arch uses
    runs at the chosen tiles, forward and backward.  On a CUDA device (the
    default where there is one) each Hopper kernel is held to its plain
    version on the same inputs within ``chip_smoke.py``'s tolerances; on
    the CPU the plain versions must give finite outputs of the right
    shapes.  Raises on failure; returns True.  ``report`` collects each
    output's max |kernel - plain| (on the card)."""
    import torch

    device = _device(device)
    seq = min(int(seq_len), 1024)
    heads = min(max(1, cfg.num_heads), 2)
    data = _inputs(cfg, seq, heads, device, seed=1)
    ops = _ops(config, "kernel")
    plain = _ops(config, "plain")
    report = report if report is not None else {}

    def check(name, got, want, rule):
        for i, (g, w) in enumerate(zip(got, want)):
            if tuple(g.shape) != tuple(w.shape):
                raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} "
                                     f"!= {tuple(w.shape)}")
            if device == "cuda":
                ok, err = rule(g, w)
            else:
                ok, err = bool(torch.isfinite(g.float()).all()), 0.0
            report[f"{name}[{i}]"] = max(report.get(f"{name}[{i}]", 0.0),
                                         err)
            if not ok:
                raise AssertionError(
                    f"{name}[{i}] at {config.astuple()}: max err {err:.3e} "
                    f"against the plain version")

    def f32(ts):
        return [t.float() if t.dtype == torch.bfloat16 else t for t in ts]

    with torch.no_grad():
        if "attn" in data:
            q, k, v, do = data["attn"]
            o, lse = ops["attn_fwd"](q, k, v, do)
            wo, wlse = plain["attn_fwd"](*f32((q, k, v)), None)
            check("attn", (o,), (wo,), lambda g, w: _close(g, w, **BF16_TOL))
            check("attn_lse", (lse,), (wlse,),
                  lambda g, w: _close(g, w, **LSE_TOL))
            got = ops["attn_bwd"](q, k, v, do, o, lse)
            want = plain["attn_bwd"](*f32((q, k, v, do, o)), lse)

            def flash_rule(g, w):
                ok, err = _close(g, w, **FLASH_BWD_TOL)
                return ok and _rel_close(g, w, FLASH_BWD_REL)[0], err
            check("attn_bwd", got, want, flash_rule)
        x, s, dy = data["rms"]
        check("rms", (ops["rms_fwd"](x, s, dy),),
              (plain["rms_fwd"](*f32((x, s)), None),),
              lambda g, w: _close(g, w, **BF16_TOL))
        check("rms_bwd", ops["rms_bwd"](x, s, dy),
              plain["rms_bwd"](x, s, dy),
              lambda g, w: _close(g, w, **BF16_TOL))
        if "ssd" in data:
            args = data["ssd"]
            y, _ = ops["ssd_fwd"](*args)
            wy, _ = plain["ssd_fwd"](*args)
            check("ssd", (y,), (wy,), lambda g, w: _close(g, w, **BF16_TOL))
    if "ssd" in data:
        args = data["ssd"]
        check("ssd_bwd", ops["ssd_grads"](*args), plain["ssd_grads"](*args),
              lambda g, w: _rel_close(g, w, SSD_BWD_REL))
    if device == "cuda":
        torch.cuda.synchronize()
    return True


# ---------------------------------------------------------------------------
# calibration: anchor the roofline scales on measured defaults
# ---------------------------------------------------------------------------


def calibrate(cfg: "ArchConfig", *, seq_len: int, hw: HardwareSpec = H100,
              kc: Optional[KernelCoeffs] = None, reps: int = 3,
              cache_path=None, device: Optional[str] = None
              ) -> KernelCoeffs:
    """Anchor each kernel's ``*_scale`` so predicted(default config) ==
    measured(default config) on the bench shapes.  The relative shape of
    the roofline across tiles is untouched (the other coefficients set
    it); the scales pin its absolute level to this device's measurements.
    Frozen-default plans are invariant to calibration: the cost model
    prices kernels as a delta that is 0 at the default."""
    kc = kc if kc is not None else KernelCoeffs()
    measured = bench_config(cfg, seq_len=seq_len, reps=reps,
                            cache_path=cache_path, device=device)
    seq, heads = _bench_shapes(cfg, seq_len)
    # predict on the BENCH shapes (b scaled so head/row counts match)
    sd_h, _p, _n = ssd_dims(cfg)
    pred = predict_times(cfg, seq_len=seq, hw=hw, kc=kc,
                         b=max(1, heads) / max(1, cfg.num_heads))
    upd = {}
    if "attn" in measured and pred["attn"] > 0:
        upd["attn_scale"] = kc.attn_scale * measured["attn"] / pred["attn"]
    if "rms" in measured and pred["rms"] > 0:
        upd["rms_scale"] = kc.rms_scale * measured["rms"] / pred["rms"]
    if sd_h and "ssd" in measured and pred["ssd"] > 0:
        upd["ssd_scale"] = kc.ssd_scale * measured["ssd"] / pred["ssd"]
    for k, v in upd.items():
        if not (math.isfinite(v) and v > 0):
            raise ValueError(f"calibrated {k} = {v}: not a positive number")
    return kc.replace(**upd)
