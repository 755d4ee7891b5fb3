"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --smoke --steps 2 [--plan-json P] [--seq S] [--global-batch B] \
        [--layers L] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --tune --devices 16 [--space mist] [--memo-dir D] --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --calibrate [--smoke | --layers L --seq S] [--steps N] \
        [--calibration-out PATH|auto] [--device cpu]

Runs ``build_model`` -> ``init_train_state`` -> ``make_train_step`` and
takes ``--steps`` steps over ``SyntheticLM`` batches, on ``cuda`` unless
``--device cpu`` is given.  ``--smoke`` trains the reduced config (seq 128,
global batch 8, as the reference's smoke run); ``--layers`` cuts the depth
of the config (a full-width config whose optimizer state does not fit one
card).  With no ``--plan-json`` the plan is the reference's smoke plan:
remat on half the layers and ``grad_accum`` 2 at dp = tp = 1, with the
port's flash-attention kernel.

``--tune`` runs the port's Mist tuner for ``--devices`` H100s (the
``repro_torch.core.hardware.H100`` spec) on the config, cut by
``--layers`` if given, at ``--seq`` and ``--global-batch``, prints the plan
JSON and the predicted step time, and returns, as the reference does; with
``--smoke`` it then trains the reduced config's own smoke plan, as the
reference does.  After ``--tune`` and with ``--plan-json`` it prints the
plan's predicted against its lowered per-device memory
(``memory_consistency``; for ``--space serve`` the serve report, which
must agree bitwise).

``--calibrate`` measures the calibration cells (``calibration/measure.py``)
on the device, fits a ``CalibrationProfile`` and prints the
uncalibrated-vs-fitted error table: the reduced config at seq 128 with
``--smoke``, as the reference does, else the config cut by ``--layers``
at ``--seq``.  ``--calibration-out`` writes the profile (``auto``: the
platform's default path).  It exits 0 iff every cell ran and the
fitted error is no worse than the uncalibrated one; a failed cell (an
OOM, a kernel build or launch error) fails the run and writes no
profile.  ``TrainLoop`` with its checkpoints waits: the
loop here is a plain step loop, and it prints each step's time.
"""
from __future__ import annotations

import argparse
import pathlib
import time
from typing import Optional, Sequence

import torch

from repro_torch.models.common import resolve_device


def memory_line(cfg, shape, plan, serve: bool = False) -> str:
    """The tuner -> runtime consistency line: what the cost model predicts
    per device against what the lowered plan holds, on the port's H100.
    Serving plans are priced by the serve cost model and must agree
    bitwise at the decode shape."""
    if serve:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.serve import serve_memory, serve_memory_line
        return serve_memory_line(*serve_memory(cfg, ShapeConfig(
            shape.name, shape.seq_len, shape.global_batch, "decode"), plan))
    from repro_torch.lowering import memory_consistency
    mc = memory_consistency(cfg, shape, plan)
    return (f"# memory: predicted {mc['predicted_bytes'] / 2**30:.2f} GiB "
            f"lowered {mc['lowered_bytes'] / 2**30:.2f} GiB "
            f"(rel err {mc['rel_error']:.3f}, "
            f"within_tol={mc['within_tol']})")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 4096; 128 with --smoke)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="sequences per step (default 8)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--plan-json", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--devices", type=int, default=1,
                    help="with --tune: the H100s to tune for")
    ap.add_argument("--space", default="mist",
                    help="with --tune: the search space")
    ap.add_argument("--tune", action="store_true",
                    help="run the Mist tuner and print the plan")
    ap.add_argument("--memo-dir", default=None,
                    help="persistent tuning memo store "
                         "(core/memo_store.py): warm queries answer in "
                         "milliseconds")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure this arch's calibration cells on the "
                         "device and fit a CalibrationProfile (the reduced "
                         "config at seq 128 with --smoke)")
    ap.add_argument("--calibration-out", default=None, metavar="PATH|auto",
                    help="with --calibrate: write the fitted profile (auto "
                         "= the platform's default path)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.plan import Plan, single_stage_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.step import init_train_state, make_train_step

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    gbs = args.global_batch or 8
    if args.calibrate:
        from repro_torch.calibration.driver import (format_table,
                                                    run_calibration)
        report = run_calibration(
            archs=(args.arch,), steps=min(args.steps, 6),
            seq_len=128 if args.smoke else (args.seq or 4096),
            reduced=args.smoke, layers=args.layers, device=device,
            write_profile=args.calibration_out)
        print(format_table(report))
        if report.get("error"):
            return 1
        return 0 if (report["mean_err_fitted"]
                     <= report["mean_err_uncalibrated"] + 1e-12) else 1
    if args.tune and not args.plan_json:
        from repro_torch.core.tuner import tune
        tcfg = cfg if args.layers is None else \
            cfg.replace(num_layers=args.layers)
        shape = ShapeConfig("cli", args.seq or 4096, gbs, "train")
        rep = tune(tcfg, shape, args.devices, space=args.space,
                   memo_dir=args.memo_dir)
        if rep.plan is None:
            print("INFEASIBLE for this device count / batch")
            return 1
        print(f"# tuned in {rep.tune_seconds:.1f}s over {rep.n_points} "
              f"configs; predicted step {rep.objective:.3f}s "
              f"({rep.throughput_samples:.2f} samples/s)"
              + (" [memo-store hit]" if rep.from_memo else ""))
        print(rep.plan.to_json())
        print(memory_line(tcfg, shape, rep.plan,
                          serve=args.space == "serve"))
        if not args.smoke:
            return 0
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    seq = args.seq or (128 if args.smoke else 4096)
    model = build_model(cfg, device)
    if args.plan_json:
        plan = Plan.from_json(pathlib.Path(args.plan_json).read_text())
        print(memory_line(cfg, ShapeConfig("cli", seq, gbs, "train"), plan))
    else:
        plan = single_stage_plan(cfg.num_layers, dp=1, tp=1,
                                 micro_batch=gbs // 2 or 1, grad_accum=2,
                                 zero=1, ckpt_layers=cfg.num_layers // 2,
                                 attn_impl="pallas", use_pallas=True)
    step = make_train_step(model, plan)
    state = init_train_state(model, plan,
                             torch.Generator(device).manual_seed(0))
    data = SyntheticLM(BatchSpec(global_batch=gbs, seq_len=seq,
                                 vocab_size=cfg.vocab_size))
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t1 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
        state, metrics = step.fn(state, batch)
        losses.append(float(metrics["loss"]))  # syncs the device
        step_ms.append((time.perf_counter() - t1) * 1e3)
    dt = time.perf_counter() - t0
    n = len(losses)
    if n:
        print("# step ms: " + " ".join(f"{x:.1f}" for x in step_ms))
    print(f"trained {n} steps in {dt:.1f}s ({dt / max(1, n):.2f}s/step) on "
          f"{device}; loss {losses[0]:.3f} -> {losses[-1]:.3f}"
          if n else f"trained 0 steps on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
