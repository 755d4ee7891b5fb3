#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (sm_90).

    python3 chip_smoke.py [--profile]

Drives the port (``src/repro_torch``) only; imports nothing of JAX or of
the JAX package.  Phases, in order; any failure raises and the script exits
non-zero (no phase catches another's exception):

1. Device and build: a CUDA card of compute capability 9.0, its name and
   power limit (nvidia-smi), and the build of the hand-written kernels from
   the checkout's CUDA sources.
2. Each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at ragged ones.
3. Full-width granite-3-8b (all 40 layers, bf16, random weights from a
   seed): prefill logits with the kernels against the same model with the
   plain versions; ``generate(gen=32)`` with the launch counters checked
   exactly; and the reduced config against the CPU plain path.
4. Timings with CUDA events (kernel, plain version, one library call as a
   yardstick, data-sheet bound) and the serve loop's prefill / decode
   times, tokens per second and peak memory.
5. With ``--profile`` only: a ``torch.profiler`` window over one prefill
   and over three decode steps -- device busy time, idle share and the
   kernels that take the most device time -- written as one JSON line
   (the Chrome traces go to ``build/profile/``).
6. The ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM data sheet (dense, 700 W): bf16 tensor-core rate, f32 rate
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# serving path shapes: granite-3-8b, a batch of 4 prompts of 1024 tokens
BATCH, PROMPT_LEN, GEN = 4, 1024, 32
N_LAYERS, N_HEADS, N_KV, HEAD_DIM, D_MODEL = 40, 32, 8, 128, 4096

# kernel-vs-plain tolerances (the reference's bf16 / f32 kernel-test
# tolerances; the lse is f32 in both versions)
BF16_TOL = dict(atol=2e-2, rtol=3e-2)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
LSE_TOL = dict(atol=1e-3, rtol=1e-3)
# full-width prefill logits, kernels vs plain versions, both bf16.  The two
# round differently inside attention (the kernel's P goes to bf16 from
# register accumulators summed in another order) and every layer's output
# is rounded to bf16 again; the reference's own bf16 Pallas-vs-naive logits
# differ by ~1.2% of their size after 4 layers.  Allowed here: 5% of the
# largest logit, for the 40-layer stack.
LOGIT_REL_TOL = 5e-2
# reduced config, card (kernels) vs CPU (plain versions), teacher-forced:
# the tolerance the CPU parity tests hold the port to against the reference
REDUCED_LOGIT_ATOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def close(got, want, atol, rtol):
    """(ok, max_abs_err) of |got - want| <= atol + rtol * |want|, finite."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(((err <= atol + rtol * want.abs()) & torch.isfinite(got)).all())
    return ok, float(err.max())


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device_and_build():
    from repro_torch.kernels import _build

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card; {torch.cuda.get_device_name(0)}"
                           f" is {cap}")
    log(f"# device: {torch.cuda.get_device_name(0)} cc {cap}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi_line())
    t0 = time.perf_counter()
    _build.load_library()
    log(f"# kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS if _build.BUILD_SECONDS is not None else 'cached'})")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"#   ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _qkv(b, sq, sk, h, kv, hd, seed):
    g = torch.Generator(DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=DEVICE,  # noqa: E731
                                dtype=torch.float32).to(torch.bfloat16)
    return mk(b, sq, h, hd), mk(b, sk, kv, hd), mk(b, sk, kv, hd)


def phase_kernels_vs_plain():
    """Returns {kernel: max_abs_err at the path shape}."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN

    errs = {}
    cases = [  # (B, Sq, Sk, H, KV, hd, causal)
        (BATCH, PROMPT_LEN, PROMPT_LEN, N_HEADS, N_KV, HEAD_DIM, True),
        (BATCH, 1000, 1000, N_HEADS, N_KV, HEAD_DIM, True),
        (BATCH, 77, 300, N_HEADS, N_KV, HEAD_DIM, False),
        (2, 40, 40, 4, 1, 32, True),      # the reduced config's heads
        (2, 130, 70, 8, 2, 64, False),
    ]
    for i, (b, sq, sk, h, kv, hd, causal) in enumerate(cases):
        q, k, v = _qkv(b, sq, sk, h, kv, hd, seed=10 + i)
        o, lse = FA.flash_attention(q, k, v, causal=causal)
        sync()
        o_ref, lse_ref = FA.flash_attention(q.float(), k.float(), v.float(),
                                            causal=causal, impl="plain")
        sync()
        ok_o, err_o = close(o, o_ref, **BF16_TOL)
        ok_l, err_l = close(lse, lse_ref, **LSE_TOL)
        log(f"# flash B{b} Sq{sq} Sk{sk} H{h} KV{kv} hd{hd} causal={causal}: "
            f"o max err {err_o:.3e}, lse max err {err_l:.3e}")
        if not (ok_o and ok_l):
            raise AssertionError("flash attention kernel disagrees with its "
                                 f"plain version (case {i})")
        if i == 0:
            errs["flash_attention_fwd"] = err_o

    for rows, d in ((BATCH * PROMPT_LEN, D_MODEL), (BATCH, D_MODEL),
                    (5, 1001), (3, 1000)):
        for dtype, tol in ((torch.bfloat16, BF16_TOL),
                           (torch.float32, F32_TOL)):
            g = torch.Generator(DEVICE).manual_seed(rows + d)
            x = torch.randn((rows, d), generator=g, device=DEVICE).to(dtype)
            scale = (1 + 0.1 * torch.randn((d,), generator=g, device=DEVICE)
                     ).to(dtype)
            y = RN.rmsnorm(x, scale)
            sync()
            ok, err = close(y, RN.rmsnorm(x, scale, impl="plain"), **tol)
            sync()
            log(f"# rmsnorm rows {rows} d {d} {dtype}: max err {err:.3e}")
            if not ok:
                raise AssertionError("rmsnorm kernel disagrees with its "
                                     f"plain version ({rows}x{d} {dtype})")
            if (rows, d, dtype) == (BATCH * PROMPT_LEN, D_MODEL,
                                    torch.bfloat16):
                errs["rmsnorm"] = err
    return errs


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _plan(num_layers):
    from repro_torch.core.plan import single_stage_plan
    return single_stage_plan(num_layers, dp=1, tp=1, micro_batch=1,
                             grad_accum=1, zero=0, ckpt_layers=0,
                             attn_impl="pallas", use_pallas=True)


def phase_full_width_serve():
    """Returns (model, params, prompts, plan, launches, peak memory)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import generate
    from repro_torch.models.zoo import build_model
    from repro_torch.training.step import make_prefill_step

    cfg = get_arch("granite-3-8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (N_LAYERS, D_MODEL, N_HEADS, N_KV, HEAD_DIM)
    model = build_model(cfg, DEVICE)
    t0 = time.perf_counter()
    params, _ = model.init(torch.Generator(DEVICE).manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in params.values())
    log(f"# granite-3-8b full width, {cfg.num_layers} layers: "
        f"{n_params / 1e9:.3f} B params (bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    plan = _plan(cfg.num_layers)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=torch.Generator(DEVICE).manual_seed(1),
                            device=DEVICE, dtype=torch.int32)

    # prefill logits: kernels vs the plain versions (the impl= test hook)
    batch = {"tokens": prompts}
    got = make_prefill_step(model, plan).fn(params, batch)
    want = make_prefill_step(model, plan, kernel_impl="plain").fn(params, batch)
    sync()
    assert got.shape == want.shape == (BATCH, 1, cfg.vocab_size)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"# prefill logits, kernels vs plain: max abs diff {err:.4e}, "
        f"max |logit| {scale:.4f}, mean abs diff "
        f"{float((got - want).abs().mean()):.4e}, argmax agreement {agree}")
    if not (torch.isfinite(got).all() and err <= LOGIT_REL_TOL * scale):
        raise AssertionError(f"prefill logits: kernels vs plain {err} > "
                             f"{LOGIT_REL_TOL} * {scale}")

    # the main path, counted: every count set to 0 just before, read after
    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES = 0
    RN.LAUNCHES = 0
    toks = generate(model, params, prompts, GEN, plan)
    sync()
    launches = {"flash_attention_fwd": FA.LAUNCHES, "rmsnorm": RN.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    log(f"# generate(gen={GEN}) launches: {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    want_launches = {"flash_attention_fwd": cfg.num_layers,
                     "rmsnorm": (2 * cfg.num_layers + 1) * GEN}
    if launches != want_launches:
        raise AssertionError(f"launch counts {launches} != {want_launches}")
    assert toks.shape == (BATCH, GEN) and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"# first row: {toks[0].tolist()}")
    return model, params, prompts, plan, launches, peak


def phase_reduced_vs_cpu():
    """The reduced config (4 layers, hd 32) with the kernels on the card
    against the plain versions on the CPU, same weights, teacher-forced."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.zoo import build_model, pad_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    cfg = get_arch("granite-3-8b").reduced()
    plan = _plan(cfg.num_layers)
    b, plen, steps = 4, 64, 3
    toks = torch.randint(0, cfg.vocab_size, (b, plen + steps),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    cpu = build_model(cfg, "cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in (DEVICE, "cpu"):
        model = build_model(cfg, dev)
        p = {n: t.to(dev) for n, t in params.items()}
        t = toks.to(dev)
        logits, caches = make_prefill_step(model, plan, True).fn(
            p, {"tokens": t[:, :plen]})
        caches = pad_caches(caches, steps)
        step = make_serve_step(model, plan, batch=b, max_len=plen + steps)
        rows = [logits[:, -1]]
        for i in range(plen, plen + steps):
            logits, caches = step.fn(p, t[:, i:i + 1], caches)
            rows.append(logits[:, -1])
        out[dev] = torch.stack(rows, 1).cpu()
    err = float((out[DEVICE] - out["cpu"]).abs().max())
    log(f"# reduced config, card kernels vs CPU plain, teacher-forced "
        f"logits: max abs diff {err:.4e}")
    if not (torch.isfinite(out[DEVICE]).all() and err <= REDUCED_LOGIT_ATOL):
        raise AssertionError(f"reduced config: {err} > {REDUCED_LOGIT_ATOL}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def flash_bound(b, sq, sk, h, kv, hd, causal):
    """(bound_ms, bound_by, arithmetic) for one flash-attention forward."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * hd * pairs             # QK^T and PV, 2 flop per MAC
    nbytes = 2 * (2 * b * sq * h * hd + 2 * b * sk * kv * hd) + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    how = (f"{flops / 1e9:.2f} GFLOP / 989 TFLOP/s = {t_ops * 1e6:.1f} us; "
           f"{nbytes / 1e6:.1f} MB (q,k,v,o bf16 + lse f32) / 3.35 TB/s = "
           f"{t_bytes * 1e6:.1f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", how


def rmsnorm_bound(rows, d, esize):
    flops = 4 * rows * d                       # square, add, 2 multiplies
    nbytes = 2 * rows * d * esize + d * esize  # x read, y written, scale
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    how = (f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {t_bytes * 1e6:.1f} us; "
           f"{flops / 1e6:.1f} MFLOP f32 / 67 TFLOP/s = {t_ops * 1e6:.2f} us")
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes", how


def phase_timings(model, params, prompts, plan, launches, peak, errs):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import generate
    from repro_torch.models.zoo import pad_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    kernels = []
    # flash attention at the prefill shape
    b, s, h, kv, hd = BATCH, PROMPT_LEN, N_HEADS, N_KV, HEAD_DIM
    q, k, v = _qkv(b, s, s, h, kv, hd, seed=99)
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    ms = time_ms(lambda: FA.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                               impl="plain"), reps=5)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                         is_causal=True))
    bound, by, how = flash_bound(b, s, s, h, kv, hd, True)
    log(f"# flash bound: {how} -> {bound * 1e3:.1f} us ({by})")
    kernels.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:25",
        launches=launches["flash_attention_fwd"],
        max_abs_err=errs["flash_attention_fwd"], ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib))

    # rmsnorm at the prefill shape (and the decode shape, printed)
    for rows in (BATCH * PROMPT_LEN, BATCH):
        g = torch.Generator(DEVICE).manual_seed(rows)
        x = torch.randn((rows, D_MODEL), generator=g, device=DEVICE
                        ).to(torch.bfloat16)
        sc = torch.ones(D_MODEL, device=DEVICE, dtype=torch.bfloat16)
        r_ms = time_ms(lambda: RN.rmsnorm(x, sc), reps=50)
        r_plain = time_ms(lambda: RN.rmsnorm(x, sc, impl="plain"), reps=50)
        r_lib = time_ms(lambda: F.rms_norm(x, (D_MODEL,), weight=sc,
                                           eps=1e-6), reps=50)
        r_bound, r_by, how = rmsnorm_bound(rows, D_MODEL, 2)
        log(f"# rmsnorm {rows}x{D_MODEL} bf16: kernel {r_ms:.4f} ms, plain "
            f"{r_plain:.4f} ms, F.rms_norm {r_lib:.4f} ms; bound {how}")
        if rows == BATCH * PROMPT_LEN:
            kernels.append(dict(
                name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:16",
                launches=launches["rmsnorm"], max_abs_err=errs["rmsnorm"],
                ms=r_ms, plain_ms=r_plain, bound_ms=r_bound, bound_by=r_by,
                library_ms=r_lib))

    # the serve loop: prefill, decode per step, whole generate()
    max_len = PROMPT_LEN + GEN
    prefill = make_prefill_step(model, plan, return_cache=True)
    serve = make_serve_step(model, plan, batch=BATCH, max_len=max_len)
    batch = {"tokens": prompts}
    prefill_ms = time_ms(lambda: prefill.fn(params, batch), reps=3,
                         warmup=1)
    logits, caches = prefill.fn(params, batch)
    caches = pad_caches(caches, GEN)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    sync()
    t0 = time.perf_counter()
    for _ in range(GEN - 1):
        logits, caches = serve.fn(params, tok, caches)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (GEN - 1)
    t0 = time.perf_counter()
    generate(model, params, prompts, GEN, plan)
    sync()
    gen_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    serve_numbers = dict(
        prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
        generate_s=gen_s, generated_tok_per_s=BATCH * GEN / gen_s,
        max_memory_allocated=peak,
        decode_bound_ms=weight_bytes / PEAK_BYTES * 1e3,
        decode_bound="weights read once per step: "
                     f"{weight_bytes / 1e9:.2f} GB / 3.35 TB/s")
    log(json.dumps({"serve": serve_numbers}))
    return kernels


def _device_window(fn, trace: Path):
    """Profile one call of ``fn``: wall time, device busy time (the union of
    the CUDA kernel and memcpy intervals), idle share, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (b - a), n + 1)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_events": len(spans),
            "top": [{"name": n[:90], "ms": t / 1e3, "count": c}
                    for n, (t, c) in top]}


def phase_profile(model, params, prompts, plan):
    from repro_torch.models.zoo import pad_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    out_dir = ROOT / "build" / "profile"
    prefill = make_prefill_step(model, plan, return_cache=True)
    serve = make_serve_step(model, plan, batch=BATCH,
                            max_len=PROMPT_LEN + GEN)
    batch = {"tokens": prompts}
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill.fn(params, batch)

    def run_decode(steps=3):
        tok = state["tok"]
        for _ in range(steps):
            logits, state["caches"] = serve.fn(params, tok, state["caches"])
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    report = {"prefill": _device_window(run_prefill,
                                        out_dir / "trace_prefill.json")}
    state["caches"] = pad_caches(state["caches"], GEN)
    state["tok"] = state["logits"][:, -1].argmax(-1).to(torch.int32)[:, None]
    run_decode(1)  # warm
    report["decode_3_steps"] = _device_window(
        run_decode, out_dir / "trace_decode.json")
    log(json.dumps({"profile": report}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device_and_build()
    errs = phase_kernels_vs_plain()
    model, params, prompts, plan, launches, peak = phase_full_width_serve()
    phase_reduced_vs_cpu()
    kernels = phase_timings(model, params, prompts, plan, launches, peak,
                            errs)
    if "--profile" in sys.argv[1:]:
        phase_profile(model, params, prompts, plan)
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
