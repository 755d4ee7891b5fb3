"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --smoke --steps 2 [--plan-json P] [--seq S] [--global-batch B] \
        [--layers L] [--ckpt-dir D] [--ckpt-every N] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --tune --devices 16 [--space mist] [--memo-dir D] --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --calibrate [--smoke | --layers L --seq S] [--steps N] \
        [--calibration-out PATH|auto] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --nproc N (--plan-json P | --tune --devices N) [...] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \
        --arch granite-3-8b (--plan-json P | --tune --devices N) [...]

Runs ``build_model`` -> ``init_train_state`` -> ``make_train_step`` and
takes ``--steps`` steps over ``SyntheticLM`` batches, on ``cuda`` unless
``--device cpu`` is given.  Dense decoders train on any plan; the hybrid
(``--arch zamba2-2.7b``) on any single-stage plan, on one device or over
dp · tp ranks (a ``--plan-json`` plan: the tuner's ``arch_stats`` cannot
price zamba2 yet; a hybrid plan of S > 1 raises, as the reference has no
hybrid pipeline).  ``--smoke`` trains the reduced
config (seq 128, global batch 8, as the reference's smoke run);
``--layers`` cuts the depth of the config (a full-width config whose
optimizer state does not fit one card).  With no ``--plan-json`` the plan is the reference's smoke plan:
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
at ``--seq``.  ``--fit-kernels`` also anchors the kernel roofline's
scales on the kernel bench (``kernels/autotune.calibrate``, the Hopper
kernels on the card).  ``--calibration-out`` writes the profile (``auto``:
the platform's default path).  It exits 0 iff every cell ran and the
fitted error is no worse than the uncalibrated one; a failed cell (an
OOM, a kernel build or launch error) fails the run and writes no
profile.

Training runs through ``training.loop.TrainLoop``, as the reference's
launcher does: a checkpoint every ``--ckpt-every`` steps into
``--ckpt-dir`` (the port's own default, ``$TMPDIR/repro_torch_ckpt``,
never the reference's), written in the background by rank 0, restarts
from the latest checkpoint on a failed step, a rollback to the host
snapshot on a non-finite loss, and straggler counting.  It prints each
step's time, the losses in full, the kernels' launch counts, the rollback
snapshot's time and bytes with the loop's restarts, rollbacks and
straggler events, and, on a card, the allocator's peak beside the plan's
predicted bytes per device (``--save-params`` writes the losses and the
final params, whole, to an ``.npz``).

Multi-device plans (dp · tp > 1, or S > 1 pipeline stages) run one
process per device: ``--nproc N`` spawns N ranks, or ``torchrun`` starts
them; either way each rank joins the process group from ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` (``launch/mesh.py``: NCCL on cards, gloo
with ``--device cpu``), and a process that has already joined one keeps
it.  Each rank builds its part of the state (``init_sharded_state``: on a
pipeline stage, its own layers) and takes its rows of the same global
batch; a pipelined plan runs ``parallel/pipeline.py``'s 1F1B step.  Rank 0
prints; on a pipeline, the first rank of each stage prints its stage's
step times, launch counts and peak memory, tagged ``(stage s)``.  The
world size must equal the plan's S · dp · tp, every stage with the same
(dp, tp) (``check_train_plan``).  ``--tune`` then tunes on rank 0, which
sends the plan, whatever its S, to every rank, and trains it with the
flash-attention kernel the cost model priced in place of the ``naive``
attention tuned plans name (ROADMAP.md, section C), on every stage.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

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


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _rank_main(rank: int, nproc: int, port: int, argv: Sequence[str],
               entry=None):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nproc),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    # the ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // nproc))
    rc = (entry or main)(argv)
    if rc:
        raise SystemExit(rc)


def spawn(nproc: int, argv: Sequence[str], entry=None) -> int:
    """Run ``main(argv)`` on ``nproc`` spawned ranks of one host (``entry``:
    another launcher's ``main``, e.g. ``launch.serve.main``)."""
    from torch.multiprocessing.spawn import (ProcessException,
                                            start_processes)
    try:
        start_processes(_rank_main,
                        args=(nproc, _free_port(), list(argv), entry),
                        nprocs=nproc, start_method="spawn")
    except ProcessException as e:
        print(f"error: rank {e.error_index} failed: {e}", file=sys.stderr)
        return 1
    return 0


def _launch_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS
    return {"flash_attention_fwd": FA.LAUNCHES,
            "flash_attention_bwd": FA.BWD_LAUNCHES,
            "rmsnorm": RN.LAUNCHES, "rmsnorm_bwd": RN.BWD_LAUNCHES,
            "ssd_scan": SS.LAUNCHES, "ssd_scan_bwd": SS.BWD_LAUNCHES}


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
    ap.add_argument("--fit-kernels", action="store_true",
                    help="with --calibrate: also anchor the kernel "
                         "roofline's scales on the kernel bench "
                         "(kernels/autotune.py)")
    ap.add_argument("--calibration-out", default=None, metavar="PATH|auto",
                    help="with --calibrate: write the fitted profile (auto "
                         "= the platform's default path)")
    ap.add_argument("--nproc", type=int, default=None,
                    help="spawn this many ranks, one per device, and train "
                         "the plan over them")
    ap.add_argument("--save-params", default=None, metavar="PATH",
                    help="write the losses and the final params, whole, to "
                         "this .npz (rank 0)")
    ap.add_argument("--ckpt-dir", default=str(pathlib.Path(
        tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--lr", type=float, default=None,
                    help="Adam's learning rate (default: AdamConfig's)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.nproc is not None:
        if device.type == "cuda" and args.nproc > torch.cuda.device_count():
            print(f"error: --nproc {args.nproc} needs {args.nproc} cards; "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        rest = list(argv if argv is not None else sys.argv[1:])
        k = next(i for i, a in enumerate(rest) if a.startswith("--nproc"))
        return spawn(args.nproc,
                     rest[:k] + rest[k + (1 if "=" in rest[k] else 2):])
    distributed = dist.is_initialized() or "WORLD_SIZE" in os.environ
    owned = distributed and not dist.is_initialized()
    try:
        return _run(args, device, distributed)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device: torch.device, distributed: bool) -> int:
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.plan import Plan, single_stage_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.training.checkpoint import StatePlacement
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.training.optimizer import AdamConfig
    from repro_torch.training.step import init_train_state, make_train_step

    rank, world = 0, 1
    if distributed:
        from repro_torch.launch.mesh import init_distributed
        rank, world, device = init_distributed(device)

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    cfg = get_arch(args.arch)
    gbs = args.global_batch or 8
    if args.calibrate:
        from repro_torch.calibration.driver import (format_table,
                                                    run_calibration)
        report = run_calibration(
            archs=(args.arch,), steps=min(args.steps, 6),
            seq_len=128 if args.smoke else (args.seq or 4096),
            reduced=args.smoke, layers=args.layers, device=device,
            fit_kernels=args.fit_kernels,
            write_profile=args.calibration_out)
        print(format_table(report))
        if report.get("error"):
            return 1
        return 0 if (report["mean_err_fitted"]
                     <= report["mean_err_uncalibrated"] + 1e-12) else 1
    plan = None
    if args.tune and not args.plan_json:
        from repro_torch.core.tuner import tune
        tcfg = cfg if args.layers is None else \
            cfg.replace(num_layers=args.layers)
        shape = ShapeConfig("cli", args.seq or 4096, gbs, "train")
        # rank 0 tunes and every rank trains the plan it found
        tuned = [None]
        if rank == 0:
            rep = tune(tcfg, shape, args.devices, space=args.space,
                       memo_dir=args.memo_dir)
            if rep.plan is None:
                say("INFEASIBLE for this device count / batch")
            else:
                say(f"# tuned in {rep.tune_seconds:.1f}s over "
                    f"{rep.n_points} configs; predicted step "
                    f"{rep.objective:.3f}s "
                    f"({rep.throughput_samples:.2f} samples/s)"
                    + (" [memo-store hit]" if rep.from_memo else ""))
                say(rep.plan.to_json())
                say(memory_line(tcfg, shape, rep.plan,
                                serve=args.space == "serve"))
                if tcfg.family == "hybrid":
                    say(f"# note: the tuner's arch_stats give {tcfg.name} no "
                        "layer parameters (the reference's prefixes miss its "
                        "stacks; ROADMAP.md, section C): its memory and time "
                        "terms, and so this plan, are not trusted")
                tuned = [rep.plan.to_json()]
        if distributed:
            dist.broadcast_object_list(tuned, src=0)
        if tuned[0] is None:
            return 1
        if distributed:
            # the attention the cost model priced (ROADMAP.md, section C)
            plan = Plan.from_json(tuned[0]).replace(attn_impl="pallas",
                                                    use_pallas=True)
        elif not args.smoke:
            return 0
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    seq = args.seq or (128 if args.smoke else 4096)
    shape = ShapeConfig("cli", seq, gbs, "train")
    model = build_model(cfg, device)
    if args.plan_json:
        plan = Plan.from_json(pathlib.Path(args.plan_json).read_text())
    elif plan is None:
        plan = single_stage_plan(cfg.num_layers, dp=1, tp=1,
                                 micro_batch=gbs // 2 or 1, grad_accum=2,
                                 zero=1, ckpt_layers=cfg.num_layers // 2,
                                 attn_impl="pallas", use_pallas=True)
    from repro_torch.lowering import check_train_plan
    try:
        check_train_plan(plan, world, cfg.num_layers)
    except ValueError as e:
        say(f"error: {e}")
        return 1
    if args.plan_json:
        say(memory_line(cfg, shape, plan))
    gen = torch.Generator(device).manual_seed(0)
    adam = AdamConfig() if args.lr is None else AdamConfig(lr=args.lr)
    mesh, S, stage = None, plan.num_stages, 0
    if distributed:
        from repro_torch.launch.mesh import make_plan_mesh, mesh_coords
        from repro_torch.training.step import init_sharded_state
        st = plan.stages[0]
        mesh = make_plan_mesh(st.dp, st.tp, device, S)
        if S > 1:
            from repro_torch.parallel.pipeline import \
                make_pipeline_train_step
            step = make_pipeline_train_step(model, plan, mesh, adam)
            c = mesh_coords(mesh)
            stage = c["stage"]
            if c["data"] == c["model"] == 0:
                def say(*a):    # this stage's lines
                    print(*a, flush=True)
        else:
            step = make_train_step(model, plan, adam, mesh=mesh)
        state = init_sharded_state(model, plan, mesh, gen)
    else:
        step = make_train_step(model, plan, adam)
        state = init_train_state(model, plan, gen)
    tag = f" (stage {stage})" if S > 1 else ""
    data = SyntheticLM(BatchSpec(global_batch=gbs, seq_len=seq,
                                 vocab_size=cfg.vocab_size))

    def batches(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch(i).items()}

    loop = TrainLoop(step.fn, state, batches, ckpt_dir=args.ckpt_dir,
                     cfg=LoopConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every),
                     place=StatePlacement(cfg, plan, mesh, device),
                     meta={"arch": cfg.name, "plan": plan.to_json()})
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    counts0 = _launch_counts()
    t0 = time.perf_counter()
    stats = loop.run()
    dt = time.perf_counter() - t0
    state, losses = loop.state, stats.losses
    n = len(losses)
    counts = {k: v - counts0[k] for k, v in _launch_counts().items()}
    where = f"{device}" + (f", rank {rank} of {world}" if distributed
                           else "")
    if n:
        say(f"# step ms{tag}: " + " ".join(f"{x * 1e3:.1f}"
                                           for x in stats.step_times))
        if rank == 0:
            print("# losses: " + " ".join(repr(x) for x in losses))
    say(f"# launches{tag}: {json.dumps(counts)}")
    snap = stats.snapshot_times
    say(f"# loop{tag}: rollback snapshot "
        + (f"{snap[0]:.3f} s, {stats.snapshot_bytes} B"
           if snap else "none")
        + f"; restarts={stats.restarts} rollbacks={stats.rollbacks} "
        f"straggler_events={stats.straggler_events}")
    if device.type == "cuda":
        from repro_torch.core.costmodel import estimate_plan
        est = estimate_plan(cfg, shape, plan)["mem_per_stage"][stage]
        say(f"# peak memory{tag}: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(device)} B ({where}); "
            f"predicted {est:.0f} B per device")
    if args.save_params:
        from repro_torch import bridge
        full = bridge.gather_train_state(state, cfg, plan, mesh) \
            if distributed else bridge.train_state_to_numpy(state)
        if rank == 0:
            np.savez(args.save_params, losses=np.asarray(losses),
                     **full["params"])
    if rank == 0:
        print(f"trained {n} steps in {dt:.1f}s ({dt / max(1, n):.2f}s/step) "
              f"on {where}; loss {losses[0]:.3f} -> {losses[-1]:.3f}"
              if n else f"trained 0 steps on {where}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
