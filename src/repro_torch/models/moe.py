"""Mixture-of-Experts block (the port of ``repro/models/moe.py``): top-k
routing with per-expert capacity, the experts as batched products, shared
experts gated by a sigmoid (Qwen2-MoE style), and the Switch-style
load-balancing aux loss.

The function is the reference's; the form is PyTorch's.  The reference
dispatches and combines through one-hot ``(G, Tg, E, C)`` einsums because
scatter forms lower badly under XLA's SPMD partitioner.  Here each kept
(token, choice) is copied by index into its slot of an ``(E, G·C, D)``
buffer, the experts run as ``bmm``, and each kept choice's output is read
back by the same index and added, weighted by its gate.  The one-hot
dispatch tensor has exactly one 1 per kept choice (at its expert and
slot) and the combine tensor holds its gate there, so both forms add the
same products; empty slots hold zero rows in both, which the experts map
to zero.

Routing matches the reference token for token: the router's logits in f32
(the reference's ``preferred_element_type``), softmax, top-k, the gates
normalised by ``max(sum, 1e-9)``, a choice's slot the exclusive count of
earlier choices of its expert in token-major ``(token, choice)`` order,
kept where the slot is below the capacity, the combine weights cast to
the compute dtype, and the aux loss over the top-1 choices only.

Under a multi-device plan (``ExecConfig.par``) every tp rank computes the
routing of all of its micro-batch's tokens (under sequence parallelism,
of the gathered sequence) and runs only its experts: E / tp of them where
tp divides E (expert parallelism; the router's columns split with them),
else every expert on its part of ``moe_d_ff``.  The partial outputs are
summed over tp.  Each routing quantity gets its gradient once: the router
reads the block input outside the tp region, the dispatch inside it (its
backward sums the ranks' input gradients), and the gates enter the
combine through copy-to-tp (their gradient summed over tp before it
meets the aux loss's, which every rank holds whole).  Over data ranks the
aux's top-1 counts are summed; where a group spans several data ranks,
each rank's slots are offset by the counts of the ranks before it in the
group (its rows follow theirs: ``training.step.data_micros``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ExecConfig, Params, ScopedBuilder
from repro_torch.models.layers import _GatedDown


def init_moe(b: ScopedBuilder, cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    b.add("router", (d, e), ("embed", "expert"), scale=1.0 / math.sqrt(d))
    b.add("wg", (e, d, f), ("expert", "embed", "mlp"))
    b.add("wu", (e, d, f), ("expert", "embed", "mlp"))
    b.add("wd", (e, f, d), ("expert", "mlp", "embed"))
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        b.add("shared_wg", (d, fs), ("embed", "mlp"))
        b.add("shared_wu", (d, fs), ("embed", "mlp"))
        b.add("shared_wd", (fs, d), ("mlp", "embed"))
        b.add("shared_gate", (d, 1), ("embed", None),
              scale=1.0 / math.sqrt(d))


def _capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.num_experts_per_tok
                      * cfg.capacity_factor / cfg.num_experts))
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4


@dataclass
class Routing:
    """One micro-batch's routing over this rank's G groups of t tokens
    (t = Tg, or this rank's part of one group): the f32 gates (normalised,
    differentiable), the top-k experts ``idx``, each choice's slot ``pos``
    in its expert and ``keep`` (``pos < cap``), all ``(G, t, k)``; the
    capacity and the aux loss."""
    gates: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # a compare, so that nothing waits for the device (F.one_hot reads the
    # classes' range back to the host)
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _groups(t: int, ec: ExecConfig) -> Tuple[int, int, int]:
    """(G, Tg, span): this data rank's t tokens as G groups of the
    reference's ``Tg = min(moe_group_size, global tokens)``; ``span`` > 1
    when one group spans that many data ranks (G is then 1 and this rank
    holds t of its Tg tokens)."""
    dp = 1 if ec.par is None else ec.par.dp
    tg = min(ec.moe_group_size, t * dp)
    assert (t * dp) % tg == 0, f"tokens {t * dp} not divisible by group {tg}"
    if tg <= t:
        if t % tg:
            raise NotImplementedError(
                f"{t} tokens a data rank in groups of {tg}: a group would "
                "straddle two ranks unevenly (ROADMAP.md, queue A)")
        return t // tg, tg, 1
    if tg % t:
        raise NotImplementedError(
            f"a group of {tg} tokens over data ranks of {t}: not a whole "
            "number of ranks (ROADMAP.md, queue A)")
    return 1, tg, tg // t


def route(logits: torch.Tensor, cfg: ArchConfig, ec: ExecConfig
          ) -> Routing:
    """The routing of the f32 router logits ``(B, S, E)`` of this rank's
    micro-batch, as the reference routes (module docstring)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    par = ec.par
    t = logits.shape[0] * logits.shape[1]
    g, tg, span = _groups(t, ec)
    tl = t // g
    probs = torch.softmax(logits.reshape(g, tl, e), -1)      # (G,t,E) f32
    gates, idx = torch.topk(probs, k, dim=-1)                # (G,t,k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # Switch-style load-balancing aux loss: the top-1 density over every
    # group of the micro-batch (summed over data ranks), the mean
    # probability over this rank's tokens (its mean over dp is the whole
    # micro-batch's)
    top1 = _one_hot(idx[..., 0], e, torch.float32).sum((0, 1))
    if par is not None and par.dp > 1:
        dist.all_reduce(top1, group=par.dp_group)
        t *= par.dp
    aux = e * torch.sum(top1 / t * probs.mean((0, 1)))

    cap = _capacity(tg, cfg)
    # each (token, choice)'s slot in its expert: the exclusive count of the
    # group's earlier choices of that expert, token-major
    oh = _one_hot(idx.reshape(g, tl * k), e, torch.int32)    # (G,t·k,E)
    before = torch.cumsum(oh, 1, dtype=torch.int32) - oh
    pos = before.gather(-1, idx.reshape(g, tl * k, 1)).reshape(g, tl, k)
    if span > 1:
        # this rank's rows follow those of the ranks before it in the group
        counts = oh.sum((0, 1), dtype=torch.int32)
        every = counts.new_empty(par.dp * e)
        dist.all_gather_into_tensor(every, counts, group=par.dp_group)
        first = par.dp_rank // span * span
        offset = every.view(par.dp, e)[first:par.dp_rank].sum(
            0, dtype=torch.int32)
        pos = pos + offset[idx]
    return Routing(gates, idx, pos, pos < cap, cap, aux)


def _logits(p: Params, x: torch.Tensor, cfg: ArchConfig, ec: ExecConfig
            ) -> torch.Tensor:
    """The router's f32 logits ``(B, S, E)`` of the whole sequence.  On a
    tp rank: the router's columns gathered where expert parallelism splits
    them; under sequence parallelism the logits of this rank's rows,
    gathered along the sequence.  Both gathers sum nothing in the backward
    (every rank routes identically), except the columns' under sequence
    parallelism, whose gradient is each rank's sum over its rows."""
    par, w = ec.par, p["router"]
    if par is None:
        return x.float() @ w.float()
    if w.shape[1] != cfg.num_experts:
        w = par.gather_dim(w, 1) if par.sp else par.gather_replicated(w, 1)
    logits = x.float() @ w.float()
    return par.gather_replicated(logits, 1) if par.sp else logits


def moe(p: Params, x: torch.Tensor, cfg: ArchConfig, ec: ExecConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss f32 scalar).  Under sequence
    parallelism S is this rank's part of the sequence, in and out."""
    par = ec.par
    bsz, _, d = x.shape
    k = cfg.num_experts_per_tok
    logits = _logits(p, x, cfg, ec)
    seq = logits.shape[1]
    t = bsz * seq
    r = route(logits, cfg, ec)
    g = r.idx.shape[0]

    # this rank's experts: all of them, or E / tp of them under expert
    # parallelism (the mlp fallback runs every expert on its columns)
    e_loc = p["wg"].shape[0]
    lo = 0 if e_loc == cfg.num_experts else par.tp_rank * e_loc
    mine = r.keep & (r.idx >= lo) & (r.idx < lo + e_loc)
    group = torch.arange(g, device=x.device).view(g, 1, 1)
    slots = e_loc * g * r.cap
    # slot ``slots`` takes every choice that is dropped or not this rank's
    slot = torch.where(mine, ((r.idx - lo) * g + group) * r.cap + r.pos,
                       slots).reshape(-1)                    # (t·k,)
    xin = x if par is None else par.tp_in(x)
    xk = xin.reshape(t, 1, d).expand(t, k, d).reshape(t * k, d)
    buf = xin.new_zeros(slots + 1, d).index_copy(0, slot, xk)
    buf = buf[:slots].view(e_loc, g * r.cap, d)
    hg, hu = torch.bmm(buf, p["wg"]), torch.bmm(buf, p["wu"])
    yb = _GatedDown.apply(hg, hu, p["wd"], cfg.act)          # (E,G·C,D)
    yb = torch.cat([yb.reshape(slots, d), yb.new_zeros(1, d)])
    gates = r.gates if par is None else par.copy_to_tp(r.gates)
    comb = (gates * mine).to(yb.dtype).reshape(t, 1, k)
    y = torch.bmm(comb, yb.index_select(0, slot).view(t, k, d))
    y = y.view(bsz, seq, d)
    out = y if par is None else par.tp_out(y)

    if cfg.num_shared_experts:
        ws = (p["shared_wg"], p["shared_wu"])
        a, u = (x @ ws[0], x @ ws[1]) if par is None else par.column(x, *ws)
        sh = _GatedDown.apply(a, u, p["shared_wd"], cfg.act)
        if par is not None:
            sh = par.tp_out(sh)
        sgate = torch.sigmoid(x @ p["shared_gate"])
        out = out + sh * sgate.to(sh.dtype)
    return out, r.aux.float()
