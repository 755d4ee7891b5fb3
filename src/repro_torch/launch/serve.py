"""Serving launcher: batched prefill + greedy decode against the KV cache
(the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--tune`` takes the
plan from the ``serve`` search space for one H100 (``tuned_serve_plan``),
as the reference does for its devices, and prints the plan's predicted
serve memory beside its lowered report at the decode shape, and raises
unless they agree bitwise, as the reference asserts; the tuned plan's
attention reads ``naive``, and the
launcher runs it with the flash-attention kernel, the attention the cost
model prices (ROADMAP.md §C).

``--continuous`` serves one request per prompt row through the
continuous-batching engine (``serving/``: ``--slots`` decode slots over a
paged KV cache of ``--page-size`` rows a page; under ``--tune`` the tuner
sweeps ``page_grid=(0, --page-size)`` and the engine takes the plan's
page size when it has one).  The output budgets alternate between full
and half, so requests retire and others are admitted mid-run.  The
launcher raises unless every request's tokens equal the batch-1 static
decode at the engine's ``max_len`` and the engine's cache bytes equal
``concrete_paged_cache_bytes`` bitwise (docs/port.md says why batch 1).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.models.common import resolve_device


def generate(model, params, prompts: torch.Tensor, gen: int, plan,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy decode ``gen`` tokens for a batch of fixed-length prompts
    (B, plen) -> (B, gen) int32.  ``max_len`` pins the cache horizon
    (default: plen + gen)."""
    from repro_torch.models.zoo import pad_caches, quantize_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    resolve_device(model.device)
    b, plen = prompts.shape
    if max_len is None:
        max_len = plen + gen
    if plen + gen > max_len:
        raise ValueError(f"prompt {plen} + gen {gen} exceeds max_len "
                         f"{max_len}")
    prefill = make_prefill_step(model, plan, return_cache=True)
    serve = make_serve_step(model, plan, batch=b, max_len=max_len)
    with torch.inference_mode():
        logits, caches = prefill.fn(params, {"tokens": prompts})
        if plan.kv_cache_dtype == "int8":
            # prefill emits bf16 caches; decode reads the int8 layout
            caches = quantize_caches(caches)
        caches = pad_caches(caches, max_len - plen)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(gen - 1):
            logits, caches = serve.fn(params, tok, caches)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)


def tuned_serve_plan(cfg, *, batch: int, max_len: int, page_grid=None):
    """Run the ``serve`` search space for one H100 and return (plan,
    report); ``page_grid`` is the page sizes it sweeps (0: contiguous)."""
    from repro_torch.core.tuner import MistTuner, TuneSpec
    spec = TuneSpec(arch=cfg, seq_len=max_len, global_batch=batch,
                    n_devices=1, space="serve", page_grid=page_grid)
    report = MistTuner(spec).tune()
    if report.plan is None:
        raise SystemExit("serve tuner: no feasible plan "
                         f"(swept {report.n_swept} candidates)")
    return report.plan, report


def run_continuous(model, params, prompts: torch.Tensor, gens, plan, *,
                   slots: int, page_size: int, max_len: int):
    """Serve one request per prompt row (per-request output budgets
    ``gens``) through the continuous-batching engine; returns
    ({rid: tokens}, engine)."""
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, params, plan, slots=slots,
                                   max_len=max_len, page_size=page_size)
    for i in range(prompts.shape[0]):
        eng.submit({"tokens": prompts[i:i + 1]}, gens[i], rid=i)
    return eng.run(), eng


def serve_memory(cfg, shape, plan) -> Tuple[float, float]:
    """The serve plan's predicted memory (``estimate_serve_plan``) and its
    lowered report at ``shape`` (decode), on the port's H100: two
    evaluations of one layout derivation, so they must agree bitwise."""
    from repro_torch.core.costmodel import estimate_serve_plan
    from repro_torch.lowering import lower_plan, plan_mesh
    rep = lower_plan(cfg, shape, plan, plan_mesh(plan)).memory_report()
    return estimate_serve_plan(cfg, shape, plan)["mem_decode"], rep.peak_bytes


def serve_memory_line(predicted: float, lowered: float) -> str:
    return (f"# serve memory: predicted {predicted / 2**30:.2f} GiB "
            f"lowered {lowered / 2**30:.2f} GiB "
            f"(bitwise={predicted == lowered})")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tune", action="store_true",
                    help="pick the plan via the 'serve' search space "
                         "(one H100) and print its predicted vs lowered "
                         "memory")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(paged KV cache) instead of one static batch")
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots for --continuous")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV page rows for --continuous (must divide "
                         "prompt-len + gen); --tune sweeps {0, this}")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    max_len = args.prompt_len + args.gen
    if args.continuous and max_len % args.page_size:
        raise SystemExit(f"--page-size {args.page_size} must divide "
                         f"prompt-len + gen = {max_len}")

    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.models.zoo import build_model

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    if args.tune:
        from repro_torch.configs.base import ShapeConfig
        plan, report = tuned_serve_plan(
            cfg, batch=args.batch, max_len=max_len,
            page_grid=(0, args.page_size) if args.continuous else None)
        st = plan.stages[0]
        print(f"# tuned serve plan: dp={st.dp} tp={st.tp} zero={st.zero} "
              f"kv={plan.kv_cache_dtype} page_size={plan.page_size} "
              f"(objective {report.objective:.4f}s, "
              f"{report.throughput_tokens:.1f} tok/s predicted)")
        print(plan.to_json())
        predicted, lowered = serve_memory(
            cfg, ShapeConfig("cli", max_len, args.batch, "decode"), plan)
        print(serve_memory_line(predicted, lowered))
        if predicted != lowered:
            raise RuntimeError(
                f"predicted serve memory {predicted} != lowered {lowered}: "
                "the tuner's memory model and the lowering disagree")
        print(f"# the tuned plan reads attn_impl {plan.attn_impl!r}; the "
              "cost model prices flash attention, so serving runs the "
              "flash-attention kernel")
        plan = plan.replace(attn_impl="pallas", use_pallas=True)
    else:
        plan = single_stage_plan(cfg.num_layers, dp=1, tp=1, micro_batch=1,
                                 grad_accum=1, zero=0, ckpt_layers=0)
    params, _ = model.init(torch.Generator(device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device).manual_seed(1),
                            device=device, dtype=torch.int32)
    if args.continuous:
        return _serve_continuous(args, cfg, model, params, prompts, plan,
                                 max_len)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.gen, plan)
    first = toks[0, :8].tolist()  # syncs the device
    dt = time.perf_counter() - t0
    total = args.batch * args.gen
    print(f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s) "
          f"on {device}; first row: {first}")
    return 0


def _serve_continuous(args, cfg, model, params, prompts, plan,
                      max_len: int) -> int:
    """``--continuous``: the engine, then its two checks (module
    docstring)."""
    import numpy as np
    from repro_torch.lowering.cache_layout import concrete_paged_cache_bytes
    # full / half output budgets, alternating: retirement and re-admission
    # really happen
    gens = [args.gen if i % 2 == 0 else max(1, args.gen // 2)
            for i in range(args.batch)]
    ps = plan.page_size or args.page_size
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    res, eng = run_continuous(model, params, prompts, gens, plan,
                              slots=args.slots, page_size=ps,
                              max_len=max_len)
    dt = time.perf_counter() - t0
    # the comparator: each request alone, the batch-1 static decode
    ref = [generate(model, params, prompts[i:i + 1], g, plan,
                    max_len=max_len)[0].cpu().numpy()
           for i, g in enumerate(gens)]
    same = all(np.array_equal(res[i], ref[i]) for i in range(len(gens)))
    print(f"# continuous tokens == batch-1 static decode at max_len "
          f"{max_len}: {same}")
    want = int(concrete_paged_cache_bytes(
        cfg, args.slots, max_len, ps, plan.kv_cache_dtype, dp_size=1,
        tp_size=1))
    got = eng.memory_bytes()
    print(f"# paged cache bytes: engine {got} derived layout {want} "
          f"(bitwise={got == want})")
    if not same:
        bad = [i for i in range(len(gens)) if not np.array_equal(res[i],
                                                                 ref[i])]
        raise RuntimeError(f"continuous tokens diverged from the static "
                           f"decode for requests {bad}")
    if got != want:
        raise RuntimeError(f"engine cache bytes {got} != derived {want}")
    total = sum(gens)
    print(f"continuous: {total} tokens / {args.batch} requests in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, {eng.steps_run} decode "
          f"steps, {args.slots} slots, page_size {ps}) on {model.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
