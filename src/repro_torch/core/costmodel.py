"""Symbolic cost model: runtime + peak memory of one pipeline stage as
symbolic expressions over the optimization variables (paper §5.2).

The model is built ONCE per (arch, seq_len, stage-role); evaluating a batch
of N candidate configurations is a vectorized numpy substitution into the
expression DAG (`core/symbolic.py`) followed by the batched interference
model (`core/interference.py`, paper Alg. 1) — this is what makes Mist's
brute-force intra-stage sweep cheap (paper reports >1e5x vs per-config
simulation; see benchmarks/tuning_time.py for ours).

Symbols (per stage i, paper Table 2):
    b, dp, tp          parallelism
    L                  layers in this stage
    G                  gradient accumulation steps
    ckpt               number of recomputed layers (0..L)
    z1, z2, z3         ZeRO level indicators (z1 >= z2 >= z3, 0/1 floats)
    wo, go, oo, ao     offload ratios [0,1]
    inflight           live microbatches at peak (1F1B: S - stage_idx)

Outputs (numpy arrays over the candidate batch):
    mem_fwd, mem_bwd   peak bytes per device during fwd / bwd
    t_stable           stable-microbatch wall time (Eq. 5)
    d_delta            first+last microbatch extra time (Eq. 6)
    t_step             full-step estimate for S=1: G*t + d + const
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import symbolic as S
from repro_torch.core.costmodel_params import (KERNEL_SYMBOLIC_OPS, KernelCoeffs,
                                         kernel_time_terms,
                                         kernel_vmem_terms, mxu_efficiency,
                                         ssd_dims)
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.interference import InterferenceModel, pred_intf
from repro_torch.core.plan import DEFAULT_KERNEL_CONFIG
from repro_torch.core.schedule import OVERLAP_SCHEDULE, Candidate, PhaseTraffic
from repro_torch.core.symbolic import (Expr, Sym, ceil_div, rint, smax, smin,
                                 where, wrap)
# the shared state-layout derivation (spec-exact shard counts + integer
# host splits); see repro_torch/lowering/state_layout.py
from repro_torch.lowering.state_layout import symbolic_state_terms


# ---------------------------------------------------------------------------
# Tunable constants (calibratable; literature-informed defaults)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostParams:
    # The reference's constants, unchanged: they were set for (and partly
    # calibrated on) a TPU.  A calibration profile fitted on the card
    # (repro_torch.calibration) layers its values over them; the golden
    # fixtures pin plans made with these.
    mxu_eff_peak: float = 0.75       # best-case MXU efficiency of big matmuls
    mxu_eff_floor: float = 0.08
    mxu_sat_tokens: float = 1024.0   # tokens/device at which eff saturates
    vpu_tax: float = 0.12            # non-matmul compute as a fraction of dot time
    ici_eff: float = 0.85            # achievable fraction of link bandwidth
    host_eff: float = 0.90           # achievable fraction of host DMA bw
    coll_latency_us: float = 12.0    # per-collective launch latency
    mem_headroom: float = 0.92       # usable fraction of HBM
    # XLA runtime + fragmentation.  The default was cross-checked against
    # real allocator stats (compiled-executable peak minus the modeled
    # terms) by ``tools/calibrate_reserved.py`` on a reduced golden cell;
    # re-run that tool on a real accelerator host to refit it there.
    # Predictor and memory_report both read THIS field, so the
    # predicted-vs-lowered cross-check is independent of its value.
    runtime_reserved: float = 0.75 * 2**30
    # serving (docs/serving.md): decode-step working-set envelope and the
    # decode roofline's MXU efficiency (GEMV-shaped matmuls run far below
    # the big-matmul peak)
    serve_decode_transient: float = 0.3 * 2**30
    decode_mxu_eff: float = 0.30
    # paged-KV serving (docs/continuous-batching.md): expected request
    # fill fraction of the decode horizon under a mixed-length trace
    # (drives the occupancy-aware page-size objective) and the strided
    # page-gather penalty in rows (smaller pages touch more, shorter,
    # HBM bursts)
    serve_page_fill: float = 0.5
    serve_page_stride_rows: float = 4.0
    # per-kernel roofline coefficients (the kernel-config plan dimension);
    # calibratable from kernels.autotune bench measurements
    kernels: KernelCoeffs = KernelCoeffs()


# ---------------------------------------------------------------------------
# Analytic per-arch constants (derived from param shapes — exact)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchStats:
    n_layer: float            # params per (stacked) backbone layer
    n_layer_active: float     # ... counting only routed-active experts (MoE)
    n_shared: float           # shared-block params (Zamba2) applied repeatedly
    shared_apps_per_layer: float  # shared-block applications per backbone layer
    n_embed: float            # embedding (+ head + final norm) params
    attn_layers_frac: float   # fraction of layers with full attention
    d_model: int
    d_ff: int
    num_heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    act_coef_full: float      # saved-act bytes per token per layer / d_model (no remat)
    act_coef_ckpt: float      # ... for a rematerialized layer (boundary only)
    flops_token_layer: float  # non-attention matmul flops per token per layer (fwd)
    attn_flops_coef: float    # attention score+pv flops per token per layer = c*s


def _sum_params(tree: Dict[str, Any]) -> float:
    return float(sum(math.prod(v.shape) for v in tree.values()))


def arch_stats(cfg: ArchConfig) -> ArchStats:
    from repro_torch.core.costmodel_params import meta_params

    params, _ = meta_params(cfg)
    layer_tot = 0.0
    shared_tot = 0.0
    embed_tot = 0.0
    for name, p in params.items():
        n = math.prod(p.shape)
        if name.startswith(("layers/", "backbone/", "encoder/", "decoder/")):
            layer_tot += n
        elif name.startswith(("shared/", "shared_attn/")):
            shared_tot += n
        else:
            embed_tot += n
    # stacked leading dims: L or (groups, per-group)
    L = cfg.num_layers
    n_layer = layer_tot / max(1, L)

    # MoE: active = layer minus inactive routed experts
    n_layer_active = n_layer
    if cfg.num_experts:
        per_expert = (3 if cfg.mlp_gated else 2) * cfg.d_model * cfg.moe_d_ff
        n_layer_active = n_layer - (cfg.num_experts
                                    - cfg.num_experts_per_tok) * per_expert

    shared_apps = (1.0 / cfg.shared_attn_every if cfg.shared_attn_every
                   else 0.0)
    if cfg.family == "hybrid":
        attn_frac = shared_apps
    elif cfg.family == "ssm":
        attn_frac = 0.0
    elif cfg.family == "audio":
        attn_frac = 1.0          # self+cross handled via flops coef below
    else:
        attn_frac = 1.0

    d, dff = cfg.d_model, (cfg.moe_d_ff if cfg.num_experts else cfg.d_ff)
    hd = cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    # --- saved activations per token per layer (bf16, units of d_model) ----
    # attention: norm-in(1) + q(H*hd/d) + k,v(2*KV*hd/d) + attn-out(H*hd/d)
    #            + norm-in(1) + gate/up(2*dff*topk_eff/d) + down-in(dff*topk/d)
    # flash/blocked attention saves only O(1) softmax stats (ignored).
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        topk = (cfg.num_experts_per_tok + cfg.num_shared_experts
                if cfg.num_experts else 1)
        mlp_units = (3 if cfg.mlp_gated else 2) * dff * topk / d
        attn_units = 2 + 2 * (H * hd) / d + 2 * (KV * hd) / d
        act_full = attn_units + 1 + mlp_units
    elif cfg.family == "hybrid":
        dinner = cfg.ssm_expand * d
        act_full = 2 + 2 * (2 * dinner + 2 * cfg.ssm_groups
                            * cfg.ssm_state) / d
        act_full += shared_apps * (4 + (3 * cfg.d_ff) / d)
    else:  # ssm / xlstm
        dinner = cfg.ssm_expand * d
        act_full = 2 + 2 * (2 * dinner) / d + (2 * cfg.ssm_groups
                                               * cfg.ssm_state) / d
    act_ckpt = 1.0  # layer boundary (residual stream) only

    # --- fwd matmul flops per token per layer (2*active params works) ------
    flops_tok = 2.0 * n_layer_active
    if cfg.family == "hybrid":
        flops_tok = 2.0 * (n_layer_active + shared_apps * shared_tot)

    # attention O(s) term per token per layer: QK^T + PV, causal halves it:
    # 2 matmuls * 2 flops * H * hd * (s/2) = 2*H*hd*s per token
    attn_coef = 2.0 * H * hd * attn_frac
    if cfg.family == "audio":
        # decoder self (causal) + cross-attn to encoder_seq + encoder self
        attn_coef = 2.0 * H * hd * 2.0

    return ArchStats(
        n_layer=n_layer, n_layer_active=n_layer_active, n_shared=shared_tot,
        shared_apps_per_layer=shared_apps, n_embed=embed_tot,
        attn_layers_frac=attn_frac, d_model=d, d_ff=dff, num_heads=H,
        kv_heads=KV, head_dim=hd, vocab=cfg.vocab_size,
        act_coef_full=act_full, act_coef_ckpt=act_ckpt,
        flops_token_layer=flops_tok, attn_flops_coef=attn_coef,
    )


# ---------------------------------------------------------------------------
# The stage cost model
# ---------------------------------------------------------------------------

SYMS = ("b", "dp", "tp", "L", "G", "ckpt", "z1", "z2", "z3",
        "wo", "go", "oo", "ao", "inflight",
        "qb", "kvb", "rnb", "sch")

BACKENDS = ("numpy", "torch", "auto")

# "auto" runs a tape on torch (on the model's device) from this many grid
# rows on, and on numpy below: the crossover of the two for the stage cost
# model's memory and time tapes of granite-3-8b, measured by chip_smoke.py's
# tune phase on one H100 80GB HBM3 (700 W): at 2^14 rows the card, copies
# in and out included, took 17.5 ms against numpy's 30.6 ms on its host,
# and at 2^12 rows 7.0 ms against 3.9 (PERF.md).  Instance attribute, so
# tests can lower it.
TORCH_AUTO_THRESHOLD = 1 << 14

# tape runs per backend in this process (chip_smoke.py reads the torch
# count to show that a torch-backend tune ran its tapes on the card)
TAPE_RUNS: Dict[str, int] = {"numpy": 0, "torch": 0}


class StageCostModel:
    """Symbolic runtime + memory for one pipeline stage of `cfg` at `seq`.

    ``backend`` selects how compiled tapes execute:

      * ``"numpy"`` (default) — the in-process numpy instruction loop with
        scratch-buffer reuse.
      * ``"torch"`` — ``Tape.lower_torch(device)``: one float64 torch op
        per instruction on ``device`` (``cuda`` unless the caller passes
        ``"cpu"``), bitwise identical to numpy.  Raises without a CUDA
        device when asked for ``cuda``, and for a tape with ops that are
        not correctly rounded in both (``pow``/``log2``; the stage tapes
        have none).
      * ``"auto"`` — like "torch", but stays on numpy below
        ``torch_auto_threshold`` grid rows.

    Downstream consumers (interference model, Pareto selection) always
    see numpy float64 arrays regardless of backend.
    """

    def __init__(self, cfg: ArchConfig, seq_len: int, *,
                 hw: HardwareSpec = H100, cp: CostParams = CostParams(),
                 has_embed: bool = True, has_head: bool = True,
                 interference: Optional[InterferenceModel] = None,
                 sequence_parallel: bool = True,
                 backend: str = "numpy", device: Optional[str] = None,
                 profile=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        # ``profile`` is a calibration.CalibrationProfile: fitted per-platform
        # constants layered over the caller's cp/interference (an explicit
        # ``interference=`` argument wins over the profile's).  The default
        # profile carries no overrides, so passing it changes nothing — the
        # frozen-default guarantee the golden fixtures rely on.
        if profile is not None:
            cp = profile.cost_params(cp)
            if interference is None:
                interference = profile.interference_model()
        self.device = None
        if backend != "numpy":
            from repro_torch.models.common import resolve_device
            self.device = resolve_device(device)   # raises with no card
        self.cfg, self.seq, self.hw, self.cp = cfg, seq_len, hw, cp
        self.has_embed, self.has_head = has_embed, has_head
        self.intf = interference or InterferenceModel()
        self.st = arch_stats(cfg)
        self.sp = sequence_parallel
        self.backend = backend
        self.torch_auto_threshold = TORCH_AUTO_THRESHOLD
        if profile is not None and profile.torch_auto_threshold is not None:
            self.torch_auto_threshold = int(profile.torch_auto_threshold)
        self.last_backend = "numpy"     # backend of the most recent tape run
        self._build()

    # -- expression construction ---------------------------------------------
    def _build(self):
        st, seq, hw, cp = self.st, self.seq, self.hw, self.cp
        b, dp, tp = Sym("b"), Sym("dp"), Sym("tp")
        L, G, ckpt = Sym("L"), Sym("G"), Sym("ckpt")
        z1, z2, z3 = Sym("z1"), Sym("z2"), Sym("z3")
        wo, go, oo, ao = Sym("wo"), Sym("go"), Sym("oo"), Sym("ao")
        inflight = Sym("inflight")

        # ---- parameter byte counts (per device) ----------------------------
        # Memory charges state SPEC-EXACTLY via the shared state-layout
        # module: per tensor group, the shard count its PartitionSpec
        # implies (indivisible dims replicate at full size) and the
        # runtime's integer WO/OO host splits on stacked entries only —
        # the same derivation LoweredPlan.memory_report() evaluates
        # concretely, so predicted and lowered bytes agree bitwise.
        lay = symbolic_state_terms(self.cfg, has_embed=self.has_embed,
                                   has_head=self.has_head)
        states = lay["weight"] + lay["grad"] + lay["master"] + lay["opt"]
        # The *time* terms below keep the idealized uniform division:
        # collective/DMA message sizes are bandwidth estimates calibrated
        # as a whole (CostParams), not bytes the runtime must hold.
        n_stage = st.n_layer * L + st.n_shared \
            + (st.n_embed if (self.has_embed or self.has_head) else 0.0)
        n_tp = n_stage / tp                      # TP shards ~everything
        g_bytes = 4.0 * n_tp / where(z2, dp, 1.0) * (1.0 - go)  # f32 accum

        # ---- activations ----------------------------------------------------
        sp_div = tp if self.sp else wrap(1.0)
        tok = b * seq
        act_full_l = 2.0 * st.act_coef_full * st.d_model * tok / sp_div
        act_ckpt_l = 2.0 * st.act_coef_ckpt * st.d_model * tok / sp_div
        ck = smin(ckpt, L)
        # AO offloads an INTEGER layer count, exactly the lowering's
        # ExecConfig.offload_layers = round(ao * ckpt_layers)
        off = rint(ao * ck)
        acts_mb = (ck - off) * act_ckpt_l + (L - ck) * act_full_l
        acts = acts_mb * inflight
        host_acts = off * act_ckpt_l * inflight

        # transient working set: one layer's full intermediates during
        # (re)compute + gathered zero-3 params for ~2 layers + attn scratch
        trans = 2.0 * act_full_l + z3 * 2.0 * (2.0 * st.n_layer / tp)
        trans = trans + 2.0 * act_ckpt_l * inflight  # bwd boundary grads
        logits = (2.0 * b * min(512, seq) * st.vocab * 4.0 / tp
                  if self.has_head else wrap(0.0))

        self.mem_fwd: Expr = states + acts + trans + logits + cp.runtime_reserved
        self.mem_bwd: Expr = states + acts + trans + logits \
            + act_full_l + cp.runtime_reserved  # recompute scratch in bwd
        # per-term peak-memory breakdown (bwd side == the peak, since bwd
        # only adds the recompute scratch): evaluated by estimate_plan /
        # memory_consistency so predicted-vs-lowered disagreement is
        # attributable to a term, not just a total
        self.mem_terms: Dict[str, Expr] = {
            "state": states, "act": acts,
            "transient": trans + act_full_l, "logits": wrap(logits),
            "host_state": lay["host"], "host_act": host_acts,
        }

        # ---- kernel working set (grid legality, not HBM peak) ---------------
        # The Hopper kernels' shared memory a block at the knobs' tiles
        # (``vmem_peak``, the reference's name) must fit a block's; the
        # budget is floored at the default config's own working set so the
        # default tiles are feasible by construction (they are today's
        # behaviour) and the mask can only prune configs strictly larger
        # than both the budget and the default.
        self.vmem_peak: Expr = self._kernel_vmem(
            Sym("qb"), Sym("kvb"), Sym("rnb"), Sym("sch"))
        vmem_default = self._kernel_vmem(
            *(float(v) for v in DEFAULT_KERNEL_CONFIG.astuple()),
            concrete=True)
        self.vmem_budget_bytes: float = max(float(hw.vmem_bytes),
                                            float(vmem_default))

        # ---- compute times (per microbatch, this stage) ---------------------
        flops_fwd = (st.flops_token_layer * L
                     + st.attn_flops_coef * seq * L) * tok / tp
        if self.has_embed or self.has_head:
            flops_fwd = flops_fwd + 2.0 * st.n_embed * tok / tp
        # MXU efficiency: saturating in per-device tokens — the shared
        # formula (costmodel_params.mxu_efficiency), also exposed concretely
        # via the public ``mxu_efficiency`` method so external consumers
        # (benchmarks/accuracy.py) cannot drift from the tape's arithmetic
        eff = mxu_efficiency(tok, eff_peak=cp.mxu_eff_peak,
                             eff_floor=cp.mxu_eff_floor,
                             sat_tokens=cp.mxu_sat_tokens)
        t_fwd = flops_fwd * (1.0 + cp.vpu_tax) / (hw.peak_flops_bf16 * eff)

        # ---- kernel-config roofline delta (tile/block knobs) ----------------
        # The kernel dimension is priced as a DELTA against the default
        # config: the same shared formula (costmodel_params.kernel_time_terms)
        # is built once over the knob symbols (qb/kvb/rnb/sch) and once over
        # the default constants.  At the default bindings both sides run the
        # identical op sequence on equal float64 values, so the delta is
        # exactly 0.0 and t_fwd (hence every phase sum, t_stable, d_delta,
        # and the golden objectives) is bitwise unchanged — the term only
        # moves candidates when the kernel dimension is actually swept.
        t_kernel_sym = self._kernel_time(
            b, tp, sp_div, Sym("qb"), Sym("kvb"), Sym("rnb"), Sym("sch"), L)
        t_kernel_def = self._kernel_time(
            b, tp, sp_div, *(wrap(float(v)) for v in
                             DEFAULT_KERNEL_CONFIG.astuple()), L)
        self.kernel_time_delta: Expr = t_kernel_sym - t_kernel_def
        # floor at a fraction of the base estimate: the delta is a roofline
        # *correction*, never allowed to swallow the base matmul time (a
        # mis-calibrated coefficient must not produce negative step times).
        # At the defaults delta == 0 and t_fwd > 0.1 * t_fwd, so the max
        # passes the base through bitwise and goldens are unaffected.
        t_fwd = smax(t_fwd + self.kernel_time_delta, 0.1 * t_fwd)
        t_bwd = 2.0 * t_fwd
        t_recompute = t_fwd * (ck / smax(L, 1.0))

        # dot-flops per pass (per microbatch, per device) — the quantities
        # the time items above price.  Exposed as their own exprs
        # (``evaluate_flops``) so consumers that need ground-truth flops
        # (benchmarks/accuracy.py) read the model's OWN counts instead of
        # inverting the time formula — inversion breaks once the kernel
        # roofline delta or the smax floor moves a time item, flops do not.
        self.flops_items: Dict[str, Expr] = {
            "fwd": wrap(flops_fwd), "bwd": wrap(2.0 * flops_fwd),
            "recompute": wrap(flops_fwd * (ck / smax(L, 1.0))),
        }

        # ---- collective times (per microbatch) ------------------------------
        ici_tp = ici_dp = hw.ici_bw_total * cp.ici_eff
        if hw.devices_per_host:
            # ranks lie stage-major, then d * tp + t inside a stage
            # (launch/mesh.py): a tp group spans hosts when tp exceeds a
            # host, a data group (and the ZeRO collectives over it) when
            # the stage's dp * tp does; their links then run at dci_bw.
            # Within a host the blend is exactly ici, bit for bit
            dci = hw.dci_bw * cp.ici_eff
            host = float(hw.devices_per_host)
            ici_tp = where(tp > host, dci, ici_tp)
            ici_dp = where(dp * tp > host, dci, ici_dp)
        lat = cp.coll_latency_us * 1e-6
        tp_on = (tp > 1)
        # TP: 2 AR (or AG+RS pair ~ same wire bytes) per layer fwd; 2 in bwd
        tp_wire_l = 2.0 * (2.0 * (tp - 1.0) / tp) * (2.0 * st.d_model * tok
                                                     / sp_div)
        attn_layers = st.attn_layers_frac
        t_tp_fwd = tp_on * (L * tp_wire_l / ici_tp + L * 2.0 * lat)
        t_tp_bwd = tp_on * (L * tp_wire_l / ici_tp + L * 2.0 * lat) \
            + tp_on * t_recompute * 0.0  # recompute TP comm folded below
        # recomputed layers redo their fwd TP collectives in bwd
        t_tp_bwd = t_tp_bwd + tp_on * (ck * tp_wire_l / ici_tp)

        dp_on = (dp > 1)
        w_msg = 2.0 * n_tp                      # bf16 params
        g_msg = 4.0 * n_tp                      # f32 grads
        # ZeRO-3: AG params each microbatch fwd + bwd
        t_z3_fwd = z3 * dp_on * ((dp - 1.0) / dp * w_msg / ici_dp
                                 + lat * 8.0)
        t_z3_bwd = t_z3_fwd
        # ZeRO-2: RS grads each microbatch (no persistent full-grad buffer)
        t_z2_rs = z2 * dp_on * ((dp - 1.0) / dp * g_msg / ici_dp + lat * 8.0)
        # ZeRO<=1: one grad AR at the last microbatch
        t_dp_sync = (1.0 - z2) * dp_on * (2.0 * (dp - 1.0) / dp * g_msg
                                          / ici_dp + lat * 8.0)
        # ZeRO>=1: updated-param AG once per step (first microbatch)
        t_z1_ag = z1 * dp_on * ((dp - 1.0) / dp * w_msg / ici_dp
                                + lat * 8.0)

        # ---- host-offload DMA times -----------------------------------------
        host = hw.host_bw * cp.host_eff
        opt_shard = 8.0 * n_tp / where(z1, dp, 1.0)
        mst_shard = 4.0 * n_tp / where(z1, dp, 1.0)
        grd_shard = 4.0 * n_tp / where(z2, dp, 1.0)
        t_opt_in = oo * opt_shard / host
        t_opt_out = t_opt_in
        t_mst_in = wo * mst_shard / host
        t_mst_out = t_mst_in
        t_go_out = go * grd_shard / host       # per microbatch
        t_go_in = t_go_out
        t_ao_out = off * act_ckpt_l / host      # per microbatch fwd
        t_ao_in = t_ao_out                      # bwd

        # ---- analytic HBM traffic per microbatch ---------------------------
        # weights re-read per pass (fwd, bwd, + recomputed fraction), saved
        # activations written+read, residual stream through every layer,
        # f32 grad-accum read+write; optimizer traffic amortized per step.
        w_local = 2.0 * n_tp
        act_rw = 2.0 * acts_mb + 2.0 * L * (2.0 * st.d_model * tok / sp_div)
        hbm_mb = (2.0 + ck / smax(L, 1.0)) * w_local + act_rw \
            + 2.0 * g_bytes / smax(1.0, 1.0) \
            + 2.0 * act_full_l * (1.0 + ck / smax(L, 1.0))
        hbm_step_const = 2.0 * (12.0 * n_tp / where(z1, dp, 1.0)) \
            + 2.0 * 2.0 * n_tp
        self.hbm_bytes_mb: Expr = hbm_mb
        self.hbm_bytes_step: Expr = Sym("G") * hbm_mb + hbm_step_const

        self.items: Dict[str, Expr] = {
            "fwd": t_fwd, "bwd": t_bwd, "recompute": t_recompute,
            "opt_step": 0.02 * t_fwd,  # per-layer decoupled optimizer math
            "tp_fwd": t_tp_fwd, "tp_bwd": t_tp_bwd,
            "zero3_allgather_fwd": t_z3_fwd, "zero3_allgather_bwd": t_z3_bwd,
            "zero2_reduce_scatter": t_z2_rs,
            "dp_grad_sync": t_dp_sync,
            "zero1_param_allgather": t_z1_ag,
            "act_offload_out": t_ao_out, "act_offload_in": t_ao_in,
            "grad_offload_out": t_go_out, "grad_offload_in": t_go_in,
            "opt_swap_in": t_opt_in, "opt_swap_out": t_opt_out,
            "master_swap_in": t_mst_in, "master_swap_out": t_mst_out,
        }
        # extra items referenced by phases but folded elsewhere
        self._first_extra = ("zero1_param_allgather",)

        # ---- compile everything into ONE expression tape --------------------
        # All outputs (per-item times, both memory peaks, and the per-phase
        # channel totals consumed by the interference model) evaluate in a
        # single topologically-sorted pass; hash-consing dedupes the shared
        # subexpressions across them.
        outputs: Dict[str, Expr] = dict(self.items)
        outputs["mem_fwd"] = self.mem_fwd
        outputs["mem_bwd"] = self.mem_bwd
        for p in OVERLAP_SCHEDULE:
            for chan, expr in zip(("C", "G2G", "D2H", "H2D"),
                                  self._phase_channel_exprs(p)):
                outputs[f"phase:{p.name}:{chan}"] = expr
        self.tape = S.compile_tape(outputs)
        # split tapes: memory feasibility is checked on the full candidate
        # grid, runtime only on the feasible survivors (tune_stage); the
        # kernel VMEM legality rides on the memory tape so one pass masks
        # both HBM and VMEM infeasibility
        self.tape_mem = S.compile_tape({"mem_fwd": self.mem_fwd,
                                        "mem_bwd": self.mem_bwd,
                                        "vmem_peak": self.vmem_peak})
        self.tape_time = S.compile_tape(
            {k: v for k, v in outputs.items()
             if k not in ("mem_fwd", "mem_bwd")})
        # reusable intermediate buffers for the hot tapes (sweep loops)
        self._scratch = {id(t): t.make_scratch()
                         for t in (self.tape, self.tape_mem, self.tape_time)}
        # G-independence is structural: the time tape never loads G or
        # inflight, the memory tape never loads G, so callers can cache
        # results under cheap structural keys that omit them (collapses
        # the tuner's G loop, ROADMAP item).  The loaded-sym sets are
        # recorded so evaluate_times can REFUSE a structural key if a
        # model change ever makes the time tape read inflight (the one
        # symbol the callers' keys don't determine) — the cache then
        # degrades to disabled instead of serving wrong results.
        self._time_syms = tuple(sorted({n for n, _ in
                                        self.tape_time.sym_loads}))
        self._mem_syms = tuple(sorted({n for n, _ in
                                       self.tape_mem.sym_loads}))
        self._tape_cache: Dict[Tuple, Dict[str, Any]] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    def _kernel_time(self, b, tp, sp_div, qb, kvb, rnb, sch, L) -> Expr:
        """Stage kernel time per microbatch for one (qb, kvb, rnb, sch)
        binding — the shared roofline formula gated to the ops this arch
        actually runs, times the stage's layer count."""
        st, hw, kc = self.st, self.hw, self.cp.kernels
        sd_h, sd_p, sd_n = ssd_dims(self.cfg)
        terms = kernel_time_terms(
            seq=self.seq, b=b, tp=tp, sp_div=sp_div, qb=qb, kvb=kvb,
            rnb=rnb, sch=sch, num_heads=st.num_heads, head_dim=st.head_dim,
            d_model=st.d_model, ssd_heads=sd_h, ssd_head_dim=sd_p,
            ssd_state=sd_n, hbm_bw=hw.hbm_bw,
            peak_flops=hw.peak_flops_bf16, kc=kc, ops=KERNEL_SYMBOLIC_OPS,
            tile_edge=float(hw.mxu_min_dim))
        per_layer = wrap(terms["rms"])
        if st.attn_layers_frac:
            per_layer = per_layer + st.attn_layers_frac * terms["attn"]
        if sd_h:
            per_layer = per_layer + terms["ssd"]
        return L * per_layer

    def _kernel_vmem(self, qb, kvb, rnb, sch, concrete: bool = False):
        """Worst-op shared memory a block; Expr over the knob symbols, or a
        float (``concrete=True``) for the default-config budget floor."""
        from repro_torch.core.costmodel_params import KERNEL_CONCRETE_OPS
        st = self.st
        sd_h, sd_p, sd_n = ssd_dims(self.cfg)
        ops = KERNEL_CONCRETE_OPS if concrete else KERNEL_SYMBOLIC_OPS
        vt = kernel_vmem_terms(qb=qb, kvb=kvb, rnb=rnb, sch=sch,
                               head_dim=st.head_dim, d_model=st.d_model,
                               ssd_head_dim=sd_p, ssd_state=sd_n, ops=ops)
        peak = vt["rms"] if concrete else wrap(vt["rms"])
        if st.attn_layers_frac:
            peak = ops.max(peak, vt["attn"])
        if sd_h:
            peak = ops.max(peak, vt["ssd"])
        return peak

    def _phase_channel_exprs(self, phase: PhaseTraffic
                             ) -> Tuple[Expr, Expr, Expr, Expr]:
        """Symbolic per-channel totals for one phase (same summation order
        as the legacy `phase_channels`, so results are bitwise identical)."""
        def tot(names) -> Expr:
            out: Expr = wrap(0.0)
            for n in names:
                out = out + self.items[n]
            return out
        g2g = list(phase.g2g)
        if phase.name == "first":
            g2g += list(self._first_extra)
        return (tot(phase.compute), tot(g2g), tot(phase.d2h),
                tot(phase.h2d))

    # -- evaluation -----------------------------------------------------------
    def _env(self, env: Dict[str, Any]) -> Dict[str, Any]:
        e = dict(env)
        zero = np.asarray(e.pop("zero"))
        e["z1"] = (zero >= 1).astype(np.float64)
        e["z2"] = (zero >= 2).astype(np.float64)
        e["z3"] = (zero >= 3).astype(np.float64)
        e.setdefault("inflight", 1.0)
        # kernel knobs default to the frozen config so pre-existing callers
        # that never sweep the kernel dimension keep working unchanged
        for k, v in zip(("qb", "kvb", "rnb", "sch"),
                        DEFAULT_KERNEL_CONFIG.astuple()):
            e.setdefault(k, float(v))
        for k in SYMS:
            if k not in e:
                raise KeyError(f"cost-model env missing {k!r}")
        e = {k: np.asarray(v, np.float64) for k, v in e.items()}
        return e

    def phase_channels(self, phase: PhaseTraffic, vals: Dict[str, np.ndarray]
                       ) -> Tuple[np.ndarray, ...]:
        def tot(names):
            out = 0.0
            for n in names:
                out = out + vals[n]
            return np.asarray(out, np.float64)
        g2g = list(phase.g2g)
        if phase.name == "first":
            g2g += list(self._first_extra)
        return (tot(phase.compute), tot(g2g), tot(phase.d2h), tot(phase.h2d))

    def _use_torch(self, e: Dict[str, Any]) -> bool:
        """Whether this tape run executes on the torch backend: always for
        "torch", from ``torch_auto_threshold`` grid rows on for "auto"."""
        if self.backend == "numpy":
            return False
        if self.backend == "torch":
            return True
        n = max((v.shape[0] for v in e.values() if v.ndim), default=0)
        return n >= self.torch_auto_threshold

    def _run_tape(self, tape, e: Dict[str, Any]) -> Dict[str, Any]:
        """One tape evaluation on the selected backend; numpy values out."""
        if self._use_torch(e):
            self.last_backend = "torch"
            TAPE_RUNS["torch"] += 1
            raw = tape.lower_torch(self.device)(e)
            return {k: v.cpu().numpy() for k, v in raw.items()}
        self.last_backend = "numpy"
        TAPE_RUNS["numpy"] += 1
        return tape.run(e, self._scratch[id(tape)])

    _TAPE_CACHE_MAX = 128

    def _cache_get(self, key):
        hit = self._tape_cache.get(key)
        if hit is not None:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        return hit

    def _cache_put(self, key, value):
        if len(self._tape_cache) >= self._TAPE_CACHE_MAX:
            self._tape_cache.pop(next(iter(self._tape_cache)))
        self._tape_cache[key] = value

    def evaluate(self, env: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """env binds each symbol to a scalar or a 1-D candidate array.

        Runs the compiled tape: one linear pass over the shared expression
        DAG producing every output, then the batched interference model on
        the precomputed phase-channel totals."""
        e = self._env(env)
        raw = self._run_tape(self.tape, e)
        vals = {k: np.asarray(raw[k], np.float64) for k in self.items}
        mem_fwd = np.asarray(raw["mem_fwd"], np.float64)
        mem_bwd = np.asarray(raw["mem_bwd"], np.float64)
        return self._finish(e, vals, mem_fwd, mem_bwd, self._phases(raw))

    def _phases(self, raw: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Interference prediction per phase on tape-produced channel
        totals, deduplicating identical channel rows first (the algorithm
        is per-row independent, so dedup is result-identical; e.g. the
        stable phase does not read the oo/wo knobs, collapsing the grid)."""
        phases = {}
        for p in OVERLAP_SCHEDULE:
            x = np.stack(np.broadcast_arrays(
                *(np.asarray(raw[f"phase:{p.name}:{c}"], np.float64)
                  for c in ("C", "G2G", "D2H", "H2D"))), -1)
            if x.ndim == 2 and x.shape[0] > 512:
                # group exactly-equal rows via a column lexsort (much
                # cheaper than np.unique's structured-dtype argsort)
                order = np.lexsort((x[:, 3], x[:, 2], x[:, 1], x[:, 0]))
                xs = x[order]
                starts = np.empty(xs.shape[0], bool)
                starts[0] = True
                np.any(xs[1:] != xs[:-1], axis=1, out=starts[1:])
                inv = np.empty(xs.shape[0], np.intp)
                inv[order] = np.cumsum(starts) - 1
                phases[p.name] = self.intf.predict_stacked(
                    xs[starts])[inv]
            else:
                phases[p.name] = self.intf.predict_stacked(x)
        return phases

    def evaluate_memory(self, env: Dict[str, Any],
                        cache_key: Optional[Tuple] = None
                        ) -> Dict[str, np.ndarray]:
        """Memory outputs only (the Eq. 4 feasibility inputs), via the
        dedicated memory tape — used to mask the grid before the more
        expensive runtime evaluation.

        ``cache_key`` enables the knob-tuple result cache under a
        caller-supplied structural key; the caller guarantees the key
        determines the env columns exactly (see tune_stage_multi_g).
        Cached results are shared objects — treat them as read-only."""
        e = self._env(env)
        key = None
        if cache_key is not None:
            key = ("memk",) + tuple(cache_key)
            hit = self._cache_get(key)
            if hit is not None:
                return hit
        raw = self._run_tape(self.tape_mem, e)
        mem_fwd = np.asarray(raw["mem_fwd"], np.float64)
        mem_bwd = np.asarray(raw["mem_bwd"], np.float64)
        out = {"mem_fwd": mem_fwd, "mem_bwd": mem_bwd,
               "mem_peak": np.maximum(mem_fwd, mem_bwd),
               "vmem_peak": np.asarray(raw["vmem_peak"], np.float64)}
        if key is not None:
            self._cache_put(key, out)
        return out

    def evaluate_memory_terms(self, env: Dict[str, Any]
                              ) -> Dict[str, np.ndarray]:
        """Per-term peak-memory breakdown (state / act / transient /
        logits, plus the host_state / host_act bytes the plan moves off
        device).  The four device terms + runtime_reserved sum to
        ``mem_bwd`` — the peak side, since bwd only adds scratch on top
        of fwd.  Diagnostics path (memory_consistency, estimate_plan):
        recursive evaluation with one shared memo, not the sweep tape."""
        e = self._env(env)
        memo: Dict[int, Any] = {}
        return {k: np.asarray(expr.evaluate(e, memo), np.float64)
                for k, expr in self.mem_terms.items()}

    def evaluate_flops(self, env: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Per-microbatch, per-device dot flops by pass (``fwd`` / ``bwd``
        / ``recompute``) — the model's own counts, kernel-config invariant.
        Diagnostics path (recursive evaluation with one shared memo), like
        ``evaluate_memory_terms``."""
        e = self._env(env)
        memo: Dict[int, Any] = {}
        return {k: np.asarray(expr.evaluate(e, memo), np.float64)
                for k, expr in self.flops_items.items()}

    def mxu_efficiency(self, tok) -> np.ndarray:
        """Concrete MXU efficiency at ``tok`` per-device tokens per
        microbatch — the SAME formula the time tape bakes in (shared via
        ``costmodel_params.mxu_efficiency``), for consumers that need to
        invert compute times back to flops or vice versa."""
        cp = self.cp
        return np.asarray(mxu_efficiency(
            np.asarray(tok, np.float64), eff_peak=cp.mxu_eff_peak,
            eff_floor=cp.mxu_eff_floor, sat_tokens=cp.mxu_sat_tokens))

    def evaluate_times(self, env: Dict[str, Any],
                       cache_key: Optional[Tuple] = None
                       ) -> Dict[str, np.ndarray]:
        """Runtime outputs only (per-item times, phase interference,
        t_stable/d_delta/t_step) via the time tape.

        ``cache_key`` enables the knob-tuple result cache under a
        caller-supplied structural key.  The time tape loads neither G
        nor inflight, so identical knob columns hit across the tuner's G
        loop and across same-role stage hypotheses that differ only in
        inflight depth; ``t_step`` (the only G-dependent output) is
        recomputed from the current env.  Callers' keys carry G but by
        design NOT inflight — if a model change ever makes the time tape
        read inflight, caching is refused here rather than serving
        results computed under a different inflight.  Cached results are
        shared objects — treat them as read-only."""
        e = self._env(env)
        key = None
        if cache_key is not None and "inflight" not in self._time_syms:
            key = ("timek",) + tuple(cache_key)
            hit = self._cache_get(key)
            if hit is not None:
                return dict(hit, t_step=e["G"] * hit["t_stable"]
                            + hit["d_delta"])
        raw = self._run_tape(self.tape_time, e)
        vals = {k: np.asarray(raw[k], np.float64) for k in self.items}
        phases = self._phases(raw)
        t_stable = phases["stable"]
        d_delta = np.maximum(phases["first"] - t_stable, 0.0) \
            + np.maximum(phases["last"] - t_stable, 0.0)
        out = {"t_stable": t_stable, "d_delta": d_delta,
               "t_first": phases["first"], "t_last": phases["last"],
               "items": vals}
        if key is not None:
            self._cache_put(key, out)
        return dict(out, t_step=e["G"] * t_stable + d_delta)

    def evaluate_recursive(self, env: Dict[str, Any]
                           ) -> Dict[str, np.ndarray]:
        """Reference path: per-output recursive `Expr.evaluate` walks with a
        shared id-keyed memo, python-level channel summation, and the
        per-combination interference formulation.  Kept verbatim as the
        pre-compilation baseline for equivalence tests and the tuning-time
        benchmark; must produce bitwise-identical results to `evaluate`."""
        e = self._env(env)
        memo: Dict[int, Any] = {}
        vals = {k: np.asarray(expr.evaluate(e, memo), np.float64)
                for k, expr in self.items.items()}
        mem_fwd = np.asarray(self.mem_fwd.evaluate(e, memo), np.float64)
        mem_bwd = np.asarray(self.mem_bwd.evaluate(e, memo), np.float64)
        phases = {p.name: self.intf.predict_reference(
                      *self.phase_channels(p, vals))
                  for p in OVERLAP_SCHEDULE}
        return self._finish(e, vals, mem_fwd, mem_bwd, phases)

    def _finish(self, e, vals, mem_fwd, mem_bwd, phases
                ) -> Dict[str, np.ndarray]:
        t_stable = phases["stable"]
        d_delta = np.maximum(phases["first"] - t_stable, 0.0) \
            + np.maximum(phases["last"] - t_stable, 0.0)
        G = e["G"]
        t_step = G * t_stable + d_delta
        return {
            "mem_fwd": mem_fwd, "mem_bwd": mem_bwd,
            "mem_peak": np.maximum(mem_fwd, mem_bwd),
            "t_stable": t_stable, "d_delta": d_delta, "t_step": t_step,
            "t_first": phases["first"], "t_last": phases["last"],
            "items": vals,
        }

    # -- convenience: evaluate a list of Candidates ---------------------------
    def env_from_candidates(self, cands: Sequence[Candidate], *, layers: int,
                            grad_accum: int, inflight: float = 1.0
                            ) -> Dict[str, np.ndarray]:
        def arr(f):
            return np.asarray([f(c) for c in cands], np.float64)
        return {
            "b": arr(lambda c: c.b), "dp": arr(lambda c: c.dp),
            "tp": arr(lambda c: c.tp), "zero": arr(lambda c: c.zero),
            "ckpt": arr(lambda c: min(c.ckpt, layers)),
            "wo": arr(lambda c: c.wo), "go": arr(lambda c: c.go),
            "oo": arr(lambda c: c.oo), "ao": arr(lambda c: c.ao),
            "qb": arr(lambda c: c.qb), "kvb": arr(lambda c: c.kvb),
            "rnb": arr(lambda c: c.rnb), "sch": arr(lambda c: c.sch),
            "L": float(layers), "G": float(grad_accum),
            "inflight": float(inflight),
        }

    def memory_budget(self) -> float:
        return self.hw.hbm_bytes * self.cp.mem_headroom


# ---------------------------------------------------------------------------
# Whole-plan estimate (S = 1 fast path; pipeline handled by inter_stage)
# ---------------------------------------------------------------------------


def estimate_plan(cfg: ArchConfig, shape: ShapeConfig, plan, *,
                  hw: HardwareSpec = H100, cp: CostParams = CostParams(),
                  interference: Optional[InterferenceModel] = None,
                  profile=None) -> Dict[str, float]:
    """Step-time / memory estimate of a concrete Plan (any S) using the same
    stage model + paper Eq. 1 for the pipeline objective.  ``profile`` layers
    fitted calibration constants over ``cp``/``interference`` (see
    ``StageCostModel``)."""
    n_st = len(plan.stages)
    ts, ds, mems, terms = [], [], [], []
    for i, stg in enumerate(plan.stages):
        scm = StageCostModel(cfg, shape.seq_len, hw=hw, cp=cp,
                             has_embed=(i == 0), has_head=(i == n_st - 1),
                             interference=interference, profile=profile,
                             sequence_parallel=plan.sequence_parallel)
        kc = plan.kernel
        cand = Candidate(b=stg.micro_batch, dp=stg.dp, tp=stg.tp,
                         zero=stg.zero, ckpt=min(stg.ckpt_layers, stg.layers),
                         wo=stg.wo, go=stg.go, oo=stg.oo, ao=stg.ao,
                         qb=kc.attn_q_block, kvb=kc.attn_kv_block,
                         rnb=kc.rmsnorm_block, sch=kc.ssd_chunk)
        env = scm.env_from_candidates([cand], layers=stg.layers,
                                      grad_accum=plan.grad_accum,
                                      inflight=max(1, n_st - i))
        r = scm.evaluate(env)
        ts.append(float(r["t_stable"][0]))
        ds.append(float(r["d_delta"][0]))
        mems.append(float(r["mem_peak"][0]))
        terms.append({k: float(np.asarray(v).flat[0]) for k, v in
                      scm.evaluate_memory_terms(env).items()})
    G = plan.grad_accum
    # paper Eq. 1
    t_step = (G - 1) * max(ts) + sum(ts) + max(
        d - sum(ts[:i]) for i, d in enumerate(ds))
    tokens = shape.global_batch * shape.seq_len
    return {
        "t_step": t_step, "throughput_tokens": tokens / t_step,
        "throughput_samples": shape.global_batch / t_step,
        "mem_peak_max": max(mems), "mem_per_stage": mems,
        "mem_terms_per_stage": terms,
        "t_stable_per_stage": ts, "d_delta_per_stage": ds,
        "fits": max(mems) <= hw.hbm_bytes * cp.mem_headroom,
    }


# ---------------------------------------------------------------------------
# Serving cost model (docs/serving.md)
# ---------------------------------------------------------------------------


class ServeCostModel:
    """Symbolic memory + latency of a single-stage SERVING deployment.

    Symbols (per candidate): ``dp``, ``tp``, ``z1``/``z2``/``z3`` (ZeRO
    indicators — only z3 matters for inference weights, the others are
    bound for the shared state-layout expression), and ``kv8`` (0/1:
    int8 KV cache).  The workload (batch, max context) is fixed per
    model instance, mirroring ``StageCostModel``'s (arch, seq) binding.

    Memory terms are the SHARED derivations — ``state_layout`` weights +
    ``cache_layout`` caches — evaluated over Exprs, so the predicted
    serve memory is bitwise-equal to ``LoweredPlan.memory_report()`` on
    matched plan/mesh pairs in the reference (the two-evaluation
    contract of the state layout, extended to serve shapes; the port's
    lowering report waits for ROADMAP.md's lowering item).  Time terms are the
    ``serve_time_terms`` roofline: decode is HBM-bound (weights + KV
    prefix per token), prefill is compute-bound.
    """

    SYMS = ("dp", "tp", "z1", "z2", "z3", "kv8")

    def __init__(self, cfg: ArchConfig, *, batch: int, max_len: int,
                 page_size: int = 0, hw: HardwareSpec = H100,
                 cp: CostParams = CostParams()):
        from repro_torch.core.costmodel_params import (param_count,
                                                 serve_time_terms)
        from repro_torch.lowering.cache_layout import (prefill_transient_bytes,
                                                 serve_device_bytes,
                                                 symbolic_cache_bytes,
                                                 symbolic_paged_cache_bytes)
        from repro_torch.lowering.state_layout import SYMBOLIC_OPS
        self.cfg, self.hw, self.cp = cfg, hw, cp
        self.batch, self.max_len = int(batch), int(max_len)
        self.page_size = int(page_size)
        st = arch_stats(cfg)
        self.st = st
        dp, tp, kv8 = Sym("dp"), Sym("tp"), Sym("kv8")

        # weights: the shared state layout (z1/z2/z3, wo, oo, L are bound
        # in the env — serve stages carry no optimizer state or offload,
        # so wo = oo = 0 and L = num_layers)
        weight = symbolic_state_terms(cfg, has_embed=True,
                                      has_head=True)["weight"]
        # caches: the shared cache layout (page pools when page_size > 0),
        # one derivation per dtype, blended by the exact-0/1 kv8 indicator.
        # page_size == 0 builds exactly the contiguous exprs, so existing
        # serve plans and golden fixtures are untouched.
        if self.page_size:
            c16 = symbolic_paged_cache_bytes(cfg, self.batch, self.max_len,
                                             self.page_size, "bf16")
            c8 = symbolic_paged_cache_bytes(cfg, self.batch, self.max_len,
                                            self.page_size, "int8")
        else:
            c16 = symbolic_cache_bytes(cfg, self.batch, self.max_len, "bf16")
            c8 = symbolic_cache_bytes(cfg, self.batch, self.max_len, "int8")
        cache = where(kv8, c8, c16)
        mem_decode = serve_device_bytes(
            weight=weight, cache=cache,
            transient=cp.serve_decode_transient,
            reserved=cp.runtime_reserved)
        mem_prefill = serve_device_bytes(
            weight=weight, cache=0.0,
            transient=prefill_transient_bytes(
                st.act_coef_full, float(st.d_model), float(self.batch),
                float(self.max_len), dp, tp),
            reserved=cp.runtime_reserved)
        # occupancy-aware decode stream (docs/continuous-batching.md):
        # with paging only LIVE pages stream per step — the expected fill
        # fraction rounded up to page granularity (internal fragmentation)
        # — but each page is a separate, shorter HBM burst (strided-read
        # penalty).  Memory exprs stay the exact pool bytes; only the
        # t_decode stream is scaled, by a concrete python float.
        if self.page_size:
            ps = float(self.page_size)
            live_frac = (math.ceil(cp.serve_page_fill * self.max_len / ps)
                         * ps / float(self.max_len))
            stream_cache = cache * (
                live_frac * (1.0 + cp.serve_page_stride_rows / ps))
        else:
            stream_cache = cache
        times = serve_time_terms(
            batch=float(self.batch), seq_len=float(self.max_len),
            dp=dp, tp=tp, z3=Sym("z3"),
            n_active=float(param_count(cfg, active_only=True)),
            n_layers=cfg.num_layers, d_model=st.d_model,
            attn_flops_coef=st.attn_flops_coef, cache_bytes=stream_cache,
            hbm_bw=hw.hbm_bw, peak_flops=hw.peak_flops_bf16,
            ici_bw=hw.ici_bw_total * cp.ici_eff,
            mxu_eff_peak=cp.mxu_eff_peak, mxu_eff_floor=cp.mxu_eff_floor,
            mxu_sat_tokens=cp.mxu_sat_tokens,
            decode_mxu_eff=cp.decode_mxu_eff,
            coll_latency_us=cp.coll_latency_us, ops=SYMBOLIC_OPS)
        self.exprs = {"mem_decode": wrap(mem_decode),
                      "mem_prefill": wrap(mem_prefill),
                      "t_decode": wrap(times["t_decode"]),
                      "t_prefill": wrap(times["t_prefill"])}
        self.tape = S.compile_tape(self.exprs)

    def memory_budget(self) -> float:
        return self.hw.hbm_bytes * self.cp.mem_headroom

    def _env(self, env: Dict[str, Any]) -> Dict[str, Any]:
        full = {"wo": 0.0, "oo": 0.0, "L": float(self.cfg.num_layers)}
        full.update(env)
        return {k: np.asarray(v, np.float64) for k, v in full.items()}

    def evaluate(self, env: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Vectorized tape run over candidate arrays (``dp``/``tp``/
        ``z1``/``z2``/``z3``/``kv8``)."""
        return self.tape.run(self._env(env))

    def evaluate_one(self, *, dp: int, tp: int, zero: int = 0,
                     kv_cache_dtype: str = "bf16") -> Dict[str, float]:
        env = {"dp": float(dp), "tp": float(tp),
               "z1": 1.0 if zero >= 1 else 0.0,
               "z2": 1.0 if zero >= 2 else 0.0,
               "z3": 1.0 if zero >= 3 else 0.0,
               "kv8": 1.0 if kv_cache_dtype == "int8" else 0.0}
        return {k: float(v) for k, v in self.evaluate(env).items()}


def estimate_serve_plan(cfg: ArchConfig, shape: ShapeConfig, plan, *,
                        hw: HardwareSpec = H100,
                        cp: CostParams = CostParams()) -> Dict[str, float]:
    """Serve-side twin of ``estimate_plan``: predicted per-device memory
    (decode and prefill kinds) and roofline latencies for one concrete
    single-stage plan.  ``mem_decode``/``mem_prefill`` are bitwise-equal
    to ``memory_report().peak_bytes`` of the matching lowering."""
    if len(plan.stages) != 1:
        raise ValueError("serving plans are single-stage (S=1); got "
                         f"{len(plan.stages)} stages")
    st0 = plan.stages[0]
    scm = ServeCostModel(cfg, batch=shape.global_batch,
                         max_len=shape.seq_len,
                         page_size=getattr(plan, "page_size", 0),
                         hw=hw, cp=cp)
    r = scm.evaluate_one(dp=st0.dp, tp=st0.tp, zero=st0.zero,
                         kv_cache_dtype=plan.kv_cache_dtype)
    r["fits"] = max(r["mem_decode"], r["mem_prefill"]) \
        <= scm.memory_budget()
    return r
