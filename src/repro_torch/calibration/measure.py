"""Measurement half of the calibration loop (the port of
``repro/calibration/measure.py``).

Runs cells end to end through the port's execution path —
``lower_plan`` (the mesh check and the memory report) ->
``make_train_step`` / ``init_train_state`` -> eager steps on the device —
and records, per cell:

* the median step wall time of ``steps`` timed steps after ``warmup``
  discarded ones, with ``torch.cuda.synchronize()`` before each clock
  read on the card (the median resists host-side jitter);
* the modeled peak (``memory_report``), the allocator's peak
  (``torch.cuda.max_memory_allocated()`` after
  ``reset_peak_memory_stats()``, on the card only), and
  ``executable_bytes = None``: eager PyTorch has no compiled executable
  whose size could be read (the reference's own fallback).

The cells are the reference's plan variants: pure-DP ZeRO-0 (compute + one
grad all-reduce) and ZeRO-2 + full recompute, plus TP=2 where the device
count and heads allow.  Two differences: the cells run the
flash-attention kernel (``attn_impl="pallas"``), the attention the cost
model prices, where the reference's default is the naive S x S softmax;
and a cell records ``layers`` so ``config()`` rebuilds a depth-cut
config.  The port executes dp = tp = 1 only, so it measures the
one-device cells however many cards are visible.  Cells that fail to
lower or execute are returned as a skip list with reasons, never
silently dropped; an arch the port has no builders for lands there too,
under the label ``NOT_IN_ZOO``.
"""
from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_arch
from repro_torch.core.hardware import H100
from repro_torch.core.plan import Plan, single_stage_plan

GOLDEN_ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b")
DEFAULT_SEQ = 128
NOT_IN_ZOO = "all cells"      # skip-list label of an arch the port lacks


@dataclass
class MeasuredCell:
    """One executed cell: the plan that ran plus what the hardware said."""
    label: str
    arch: str                 # full arch name; config() re-derives the cut
    reduced: bool
    seq_len: int
    global_batch: int
    plan: Plan
    steps: int
    step_seconds: Tuple[float, ...]
    t_measured: float         # warmed median step seconds
    memory: Dict[str, Optional[float]] = field(default_factory=dict)
    layers: Optional[int] = None   # depth cut of the (reduced) config

    def config(self) -> ArchConfig:
        cfg = get_arch(self.arch)
        if self.reduced:
            cfg = cfg.reduced()
        if self.layers is not None:
            cfg = cfg.replace(num_layers=self.layers)
        return cfg

    def shape(self) -> ShapeConfig:
        return ShapeConfig(self.label, self.seq_len, self.global_batch,
                           "train")

    def to_doc(self) -> Dict:
        return {
            "label": self.label, "arch": self.arch, "reduced": self.reduced,
            "layers": self.layers,
            "seq_len": self.seq_len, "global_batch": self.global_batch,
            "plan": json.loads(self.plan.to_json()),
            "steps": self.steps, "step_seconds": list(self.step_seconds),
            "t_measured": self.t_measured, "memory": dict(self.memory),
        }


def _cell_plans(cfg: ArchConfig, n_dev: int) -> List[Tuple[str, Plan]]:
    """Plan variants for one arch on ``n_dev`` devices, each lighting up a
    different subset of time-tape items (flash attention, see the module
    docstring)."""
    L = cfg.num_layers
    G = 2
    kw = dict(attn_impl="pallas", use_pallas=True)
    out = [
        (f"dp{n_dev}_z0", single_stage_plan(
            L, dp=n_dev, tp=1, micro_batch=1, grad_accum=G,
            zero=0, ckpt_layers=0, **kw)),
        (f"dp{n_dev}_z2_ckpt", single_stage_plan(
            L, dp=n_dev, tp=1, micro_batch=1, grad_accum=G,
            zero=2, ckpt_layers=L, **kw)),
    ]
    if n_dev % 2 == 0 and n_dev >= 2 and cfg.num_heads % 2 == 0:
        out.append((f"dp{n_dev // 2}_tp2_z1", single_stage_plan(
            L, dp=n_dev // 2, tp=2, micro_batch=1, grad_accum=G,
            zero=1, ckpt_layers=L // 2, **kw)))
    return out


def measure_plan(cfg: ArchConfig, shape: ShapeConfig, plan: Plan, *,
                 steps: int = 4, warmup: int = 2, device=None
                 ) -> Tuple[float, Tuple[float, ...],
                            Dict[str, Optional[float]]]:
    """Execute one cell on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``) and return (median step seconds, the timed steps' seconds,
    memory stats).  Same execution path as ``launch/train.py``."""
    import torch

    from repro_torch.lowering import lower_plan, plan_mesh
    from repro_torch.models.common import resolve_device
    from repro_torch.models.zoo import build_model
    from repro_torch.training.data import BatchSpec, SyntheticLM
    from repro_torch.training.step import init_train_state, make_train_step

    device = resolve_device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    low = lower_plan(cfg, shape, plan, plan_mesh(plan))
    mem: Dict[str, Optional[float]] = {
        "modeled_peak_bytes": float(low.memory_report(hw=H100).peak_bytes),
        "executable_bytes": None}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device)
    step = make_train_step(model, plan)
    state = init_train_state(model, plan,
                             torch.Generator(device).manual_seed(0))
    data = SyntheticLM(BatchSpec(global_batch=shape.global_batch,
                                 seq_len=shape.seq_len,
                                 vocab_size=cfg.vocab_size))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}
    for _ in range(max(1, warmup)):
        state, _metrics = step.fn(state, batch)
    times: List[float] = []
    for _ in range(max(1, steps)):
        sync()
        t0 = time.perf_counter()
        state, _metrics = step.fn(state, batch)
        sync()
        times.append(time.perf_counter() - t0)
    mem["allocator_peak_bytes"] = (
        float(torch.cuda.max_memory_allocated(device)) if cuda else None)
    return sorted(times)[len(times) // 2], tuple(times), mem


def measure_cells(archs: Sequence[str] = GOLDEN_ARCHS, *,
                  steps: int = 4, warmup: int = 2,
                  seq_len: int = DEFAULT_SEQ, reduced: bool = True,
                  layers: Optional[int] = None, device=None
                  ) -> Tuple[List[MeasuredCell], List[Dict]]:
    """Measure every cell variant of every arch on ``device``: the
    reduced config (``reduced``) or the published one, cut to ``layers``
    if given, at ``seq_len``.

    The port executes dp = tp = 1 only, so the cells are those of one
    device (``dp1_z0``, ``dp1_z2_ckpt``) however many cards are visible.

    Returns ``(cells, skipped)`` — skipped entries carry the failure
    reason so callers can report them."""
    import torch

    from repro_torch.models.common import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    cells: List[MeasuredCell] = []
    skipped: List[Dict] = []
    for arch in archs:
        try:
            cfg = get_arch(arch)
        except KeyError as exc:
            skipped.append({"arch": arch, "label": NOT_IN_ZOO,
                            "error": f"not in the port's zoo: {exc}"})
            continue
        cfg_run = cfg.reduced() if reduced else cfg
        if layers is not None:
            cfg_run = cfg_run.replace(num_layers=layers)
        for label, plan in _cell_plans(cfg_run, 1):
            st0 = plan.stages[0]
            gbs = st0.dp * st0.micro_batch * plan.grad_accum
            shape = ShapeConfig(label, seq_len, gbs, "train")
            try:
                t_med, ts, mem = measure_plan(cfg_run, shape, plan,
                                              steps=steps, warmup=warmup,
                                              device=device)
            except Exception as exc:  # a failed cell is reported, not lost
                skipped.append({"arch": arch, "label": label,
                                "error": f"{type(exc).__name__}: {exc}"})
                continue
            finally:
                # the next cell's peak must be its own: free this cell's
                # model, state and step before it starts
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
            cells.append(MeasuredCell(
                label=f"{arch}/{label}", arch=arch, reduced=reduced,
                seq_len=seq_len, global_batch=gbs, plan=plan,
                steps=steps, step_seconds=ts, t_measured=t_med,
                memory=mem, layers=layers))
    return cells, skipped
