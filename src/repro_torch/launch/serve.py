"""Serving launcher: batched prefill + greedy decode against the KV cache
(the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \
        --smoke --tune --nproc 4 [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen2-72b --tune

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--tune`` takes the
plan from the ``serve`` search space for the world's devices
(``tuned_serve_plan``), as the reference does for its devices, and prints
the plan's predicted serve memory beside its lowered report at the decode
shape, at the plan's (dp, tp), and raises unless they agree bitwise, as
the reference asserts; the tuned plan's attention reads ``naive``, and the
launcher runs it with the flash-attention kernel, the attention the cost
model prices (ROADMAP.md §C).  Without ``--tune`` the plan is the
reference's baseline: dp over every rank, tp 1.

Multi-device plans run one process per device, as ``launch/train.py``
does: ``--nproc N`` spawns N ranks, or ``torchrun`` starts them (NCCL on
cards, gloo with ``--device cpu``).  Each rank draws its part of the
params (``training.step.init_rank_params``), prefills and decodes its
rows and heads (``generate(mesh=)``), and rank 0 prints the tokens
gathered over the data ranks.  The world size must equal the plan's
dp · tp (``lowering.check_serve_plan``).

``--continuous`` serves one request per prompt row through the
continuous-batching engine (``serving/``: ``--slots`` decode slots over a
paged KV cache of ``--page-size`` rows a page; under ``--tune`` the tuner
sweeps ``page_grid=(0, --page-size)`` and the engine takes the plan's
page size when it has one).  The output budgets alternate between full
and half, so requests retire and others are admitted mid-run.  The
launcher raises unless every request's tokens equal the batch-1 static
decode at the engine's ``max_len`` and the engine's cache bytes equal
``concrete_paged_cache_bytes`` at (dp = 1, tp) bitwise (docs/port.md says
why batch 1).  On several ranks the engine runs at dp = 1 only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device


def generate(model, params, prompts: torch.Tensor, gen: int, plan,
             max_len: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Greedy decode ``gen`` tokens for a batch of fixed-length prompts
    (B, plen) -> (B, gen) int32.  ``max_len`` pins the cache horizon
    (default: plen + gen).  ``mesh``: this rank of the plan's ``(data,
    model)`` mesh, ``params`` its part (``init_rank_params``); every rank
    passes the whole batch, decodes its rows and returns every row,
    gathered over the data ranks."""
    from repro_torch.models.zoo import pad_caches, quantize_caches
    from repro_torch.training.step import make_prefill_step, make_serve_step

    resolve_device(model.device)
    b, plen = prompts.shape
    if max_len is None:
        max_len = plen + gen
    if plen + gen > max_len:
        raise ValueError(f"prompt {plen} + gen {gen} exceeds max_len "
                         f"{max_len}")
    prefill = make_prefill_step(model, plan, return_cache=True, mesh=mesh,
                                batch=b)
    serve = make_serve_step(model, plan, batch=b, max_len=max_len,
                            mesh=mesh)
    with torch.inference_mode():
        logits, caches = prefill.fn(params, {"tokens": prompts})
        if plan.kv_cache_dtype == "int8":
            # prefill emits bf16 caches; decode reads the int8 layout
            caches = quantize_caches(caches)
        caches = serve.place(pad_caches(caches, max_len - plen))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(gen - 1):
            logits, caches = serve.fn(params, tok, caches)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
        return serve.gather_rows(torch.cat(out, dim=1))


def tuned_serve_plan(cfg, *, batch: int, max_len: int, n_devices: int = 1,
                     page_grid=None):
    """Run the ``serve`` search space for ``n_devices`` H100s and return
    (plan, report); ``page_grid`` is the page sizes it sweeps (0:
    contiguous)."""
    from repro_torch.core.tuner import MistTuner, TuneSpec
    spec = TuneSpec(arch=cfg, seq_len=max_len, global_batch=batch,
                    n_devices=n_devices, space="serve", page_grid=page_grid)
    report = MistTuner(spec).tune()
    if report.plan is None:
        raise SystemExit("serve tuner: no feasible plan "
                         f"(swept {report.n_swept} candidates)")
    return report.plan, report


def run_continuous(model, params, prompts: torch.Tensor, gens, plan, *,
                   slots: int, page_size: int, max_len: int, mesh=None):
    """Serve one request per prompt row (per-request output budgets
    ``gens``) through the continuous-batching engine; returns
    ({rid: tokens}, engine)."""
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, params, plan, slots=slots,
                                   max_len=max_len, page_size=page_size,
                                   mesh=mesh)
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
                         "(for the world's H100s) and print its predicted "
                         "vs lowered memory")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(paged KV cache) instead of one static batch")
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots for --continuous")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV page rows for --continuous (must divide "
                         "prompt-len + gen); --tune sweeps {0, this}")
    ap.add_argument("--nproc", type=int, default=None,
                    help="spawn this many ranks, one per device, and serve "
                         "the plan over them")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    max_len = args.prompt_len + args.gen
    if args.continuous and max_len % args.page_size:
        raise SystemExit(f"--page-size {args.page_size} must divide "
                         f"prompt-len + gen = {max_len}")
    device = resolve_device(args.device)
    if args.nproc is not None:
        from repro_torch.launch.train import spawn
        if device.type == "cuda" and args.nproc > torch.cuda.device_count():
            print(f"error: --nproc {args.nproc} needs {args.nproc} cards; "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        rest = list(argv if argv is not None else sys.argv[1:])
        k = next(i for i, a in enumerate(rest) if a.startswith("--nproc"))
        return spawn(args.nproc,
                     rest[:k] + rest[k + (1 if "=" in rest[k] else 2):],
                     entry=main)
    distributed = dist.is_initialized() or "WORLD_SIZE" in os.environ
    owned = distributed and not dist.is_initialized()
    try:
        return _run(args, device, max_len, distributed)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device: torch.device, max_len: int, distributed: bool
         ) -> int:
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.models.zoo import build_model

    rank, world, mesh = 0, 1, None
    if distributed:
        from repro_torch.launch.mesh import init_distributed
        rank, world, device = init_distributed(device)

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    if args.tune:
        plan, report = tuned_serve_plan(
            cfg, batch=args.batch, max_len=max_len, n_devices=world,
            page_grid=(0, args.page_size) if args.continuous else None)
        st = plan.stages[0]
        say(f"# tuned serve plan: dp={st.dp} tp={st.tp} zero={st.zero} "
            f"kv={plan.kv_cache_dtype} page_size={plan.page_size} "
            f"(objective {report.objective:.4f}s, "
            f"{report.throughput_tokens:.1f} tok/s predicted)")
        say(plan.to_json())
        predicted, lowered = serve_memory(
            cfg, ShapeConfig("cli", max_len, args.batch, "decode"), plan)
        say(serve_memory_line(predicted, lowered))
        if predicted != lowered:
            raise RuntimeError(
                f"predicted serve memory {predicted} != lowered {lowered}: "
                "the tuner's memory model and the lowering disagree")
        say(f"# the tuned plan reads attn_impl {plan.attn_impl!r}; the "
            "cost model prices flash attention, so serving runs the "
            "flash-attention kernel")
        plan = plan.replace(attn_impl="pallas", use_pallas=True)
    else:
        plan = single_stage_plan(cfg.num_layers, dp=world, tp=1,
                                 micro_batch=1, grad_accum=1, zero=0,
                                 ckpt_layers=0)
    gen = torch.Generator(device).manual_seed(0)
    if distributed:
        from repro_torch.launch.mesh import make_plan_mesh
        from repro_torch.lowering import check_serve_plan
        from repro_torch.training.step import init_rank_params
        check_serve_plan(plan, world)
        st = plan.stages[0]
        mesh = make_plan_mesh(st.dp, st.tp, device)
        params, _ = init_rank_params(model, plan, mesh, gen)
    else:
        params, _ = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device).manual_seed(1),
                            device=device, dtype=torch.int32)
    where = f"{device}" + (f", {world} ranks" if distributed else "")
    if args.continuous:
        return _serve_continuous(args, cfg, model, params, prompts, plan,
                                 max_len, mesh, say, where)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, args.gen, plan, mesh=mesh)
    first = toks[0, :8].tolist()  # syncs the device
    dt = time.perf_counter() - t0
    total = args.batch * args.gen
    say(f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s) "
        f"on {where}; first row: {first}")
    if mesh is not None:
        say("# tokens gathered from the ranks: " + json.dumps(toks.tolist()))
    return 0


def _serve_continuous(args, cfg, model, params, prompts, plan,
                      max_len: int, mesh, say, where: str) -> int:
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
                              max_len=max_len, mesh=mesh)
    dt = time.perf_counter() - t0
    # the comparator: each request alone, the batch-1 static decode
    ref = [generate(model, params, prompts[i:i + 1], g, plan,
                    max_len=max_len, mesh=mesh)[0].cpu().numpy()
           for i, g in enumerate(gens)]
    same = all(np.array_equal(res[i], ref[i]) for i in range(len(gens)))
    say(f"# continuous tokens == batch-1 static decode at max_len "
        f"{max_len}: {same}")
    want = int(concrete_paged_cache_bytes(
        cfg, args.slots, max_len, ps, plan.kv_cache_dtype, dp_size=1,
        tp_size=plan.stages[0].tp))
    got = eng.memory_bytes()
    say(f"# paged cache bytes: engine {got} derived layout {want} "
        f"(bitwise={got == want})")
    if not same:
        bad = [i for i in range(len(gens)) if not np.array_equal(res[i],
                                                                 ref[i])]
        raise RuntimeError(f"continuous tokens diverged from the static "
                           f"decode for requests {bad}")
    if got != want:
        raise RuntimeError(f"engine cache bytes {got} != derived {want}")
    total = sum(gens)
    say(f"continuous: {total} tokens / {args.batch} requests in "
        f"{dt:.2f}s ({total / dt:.1f} tok/s, {eng.steps_run} decode "
        f"steps, {args.slots} slots, page_size {ps}) on {where}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
