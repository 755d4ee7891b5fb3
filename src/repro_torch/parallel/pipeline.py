"""Pipeline-parallel training (the port of ``repro/parallel/pipeline.py``).

The reference runs the S stages as one SPMD program, a ``shard_map`` over a
``stage`` mesh axis whose GPipe fill and drain autodiff realises.  The port
goes back to what that docstring says it replaces: one program per rank,
with point-to-point sends between the stages.

A plan of S stages runs on S · dp · tp ranks, laid out stage-major
(``launch/mesh.py``): every stage has the same (dp, tp), and the rank at
(s, d, t) hands its activations to the rank at (s + 1, d, t) and their
gradients back.  Inside a stage, DP, TP with or without SP and ZeRO 0-3
are the single-stage step's (``training/step.py``): the same spec tables
(of this stage), collectives, ``GradSink`` and ``adam_update``.  Unlike
the reference's executor, each stage runs its own plan entry: its layers,
ZeRO, CKPT_i, AO_i, WO_i and OO_i (``LoweredPlan.stages[i]``).

Each rank runs a 1F1B schedule over the G micro-batches: ``min(S - s - 1,
G)`` warm-up forwards, then one forward and one backward in turn, then
the drain, so stage s holds at most ``S - s`` micro-batches' activations,
the ``inflight`` the memory report charges.  The hand-off of a tick -- an
activation (micro-batch, sequence, d) in the compute dtype, or its
gradient; under sequence parallelism this tp rank's part of the sequence
-- goes in one ``batch_isend_irecv`` that pairs its sends with its
receives.  The first stage embeds, the last takes the final norm and the
loss; the loss (the mean over the G micro-batches and the data ranks) is
summed over the stages, so every rank reports it.  The embedding, head and
final norm live on the first and the last stage, and their gradients are
summed over those two (the reference's ``psum`` over ``stage``); the
gradient norm of the clip adds over the stages, each param once.  Dense
and MoE decoders: an MoE stage adds ``AUX_COEF · aux / num_layers`` of its
own layers to what its backward starts from, so that gradient stays on
the stage, and the loss every rank reports sums the stages' aux terms
with the last stage's loss (the reference's ``psum`` of ``aux_sum``).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.plan import Plan
from repro_torch.launch.mesh import end_stages_group, stage_peers
from repro_torch.lowering import check_train_plan
from repro_torch.lowering.state_layout import param_class
from repro_torch.models import decoder as DEC
from repro_torch.models.common import ExecConfig, in_use
from repro_torch.models.zoo import Model
from repro_torch.parallel.compression import fake_compress
from repro_torch.training import optimizer as OPT
from repro_torch.training.step import (data_micros, rank_plan, rank_sink,
                                       reduce_sums)


@dataclass
class PipelineStep:
    fn: Callable
    exec_cfg: ExecConfig        # this rank's stage's
    stage: int


def _tick(sends: List[Tuple[torch.Tensor, int]],
          recvs: List[Tuple[torch.Tensor, int]]) -> None:
    """One tick's sends and receives, paired in one batch."""
    ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends] + \
        [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def make_pipeline_train_step(model: Model, plan: Plan, mesh,
                             adam: OPT.AdamConfig = OPT.AdamConfig(),
                             kernel_impl: str = "kernel") -> PipelineStep:
    """``fn(state, batch)`` -> ``(state, {"loss", "grad_norm", "step"})`` on
    this rank of the plan's live ``(stage, data, model)`` mesh, its state
    from ``training.step.init_sharded_state`` and the batch the global
    batch (B, S), as ``make_train_step`` takes them."""
    cfg = model.cfg
    S, G = plan.num_stages, plan.grad_accum
    if S < 2:
        raise ValueError("a single-stage plan trains through "
                         "training.step.make_train_step(mesh=)")
    check_train_plan(plan, mesh.size(), cfg.num_layers)
    rp = rank_plan(model, plan, mesh)
    s, par, low = rp.stage, rp.par, rp.low
    ls = low.stages[s]
    scfg = low.stage_cfg(s)
    ec = ls.exec_cfg.replace(kernel_impl=kernel_impl, par=par)
    prev, nxt = stage_peers(mesh)
    stage_group = mesh.get_group("stage")
    ends = end_stages_group(mesh)
    metas, axes = low.stage_params(s)
    kind = {n: param_class(n, axes[n]) for n in metas}
    # what the first and the last stage both hold: the embedding, the head
    # and the final norm
    shared = sorted(n for n, k in kind.items() if k == "embed")
    sharding = OPT.StateSharding(
        rp.pspecs, rp.gspecs, rp.ospecs, par, stage_group=stage_group,
        across_stages=[n for n, k in kind.items() if k == "stacked"],
        counted_elsewhere=shared if s == S - 1 else ())
    dp = par.dp
    # the first send or receive between two ranks sets up their link; no
    # rank may meet it before every rank has joined the world's group
    dist.barrier()

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params = state["params"]
        micros = data_micros(batch, G, par)
        sink = rank_sink(params, rp.pspecs, rp.gspecs, par)
        dtype = next(iter(params.values())).dtype
        run_ec = ec.replace(compute_dtype=dtype, sink=sink)
        mb, seq = micros[0]["tokens"].shape
        act = (mb, seq // par.tp if par.sp else seq, cfg.d_model)
        dev = sink.anchor.device

        def buf():
            return torch.zeros(act, dtype=dtype, device=dev)

        losses, auxes = [], []

        def forward(i, x):
            micro = micros[i]
            if s == 0:
                x = DEC.embed_tokens(
                    in_use({"embed/w": params["embed/w"]}, run_ec),
                    micro["tokens"], cfg, run_ec)
            else:
                x.requires_grad_(True)
            h, aux = DEC.run_layers(params, x, scfg, run_ec,
                                    final=s == S - 1)
            aux = DEC.AUX_COEF * aux / cfg.num_layers
            if torch.is_tensor(aux):
                auxes.append(aux.detach())
            if s == S - 1:
                h = DEC.head_loss(params, h, micro, cfg, run_ec)
                losses.append(h.detach())
            return x, h, aux

        def backward(x, out, aux, dy):
            if dy is None:          # the last stage: its loss and its aux
                (out + aux).backward()
            elif torch.is_tensor(aux):  # an MoE stage's own aux term
                torch.autograd.backward([out, aux], [dy, torch.ones_like(aux)])
            else:
                out.backward(dy)
            return None if s == 0 else x.grad

        def send_recv(send_next=None, send_prev=None, recv_prev=False,
                      recv_next=False):
            sends, recvs = [], []
            if send_next is not None:
                sends.append((send_next.detach().contiguous(), nxt))
            if send_prev is not None:
                sends.append((send_prev.contiguous(), prev))
            got_prev = buf() if recv_prev else None
            got_next = buf() if recv_next else None
            if got_prev is not None:
                recvs.append((got_prev, prev))
            if got_next is not None:
                recvs.append((got_next, nxt))
            _tick(sends, recvs)
            return got_prev, got_next

        first, last = s == 0, s == S - 1
        warm = min(S - s - 1, G)
        held = collections.deque()      # (input, output) per micro-batch
        for i in range(warm):
            x = None if first else send_recv(recv_prev=True)[0]
            x, out, aux = forward(i, x)
            send_recv(send_next=out)
            held.append((x, out, aux))
        x = None
        if G > warm and not first:
            x = send_recv(recv_prev=True)[0]
        for j in range(G - warm):
            x, out, aux = forward(warm + j, x)
            held.append((x, out, aux))
            # the output on to the next stage, and the gradient of the
            # oldest held micro-batch's output back from it
            dy = None if last else \
                send_recv(send_next=out, recv_next=True)[1]
            del x, out, aux
            dx = backward(*held.popleft(), dy)
            more = j < G - warm - 1
            x = send_recv(send_prev=dx, recv_prev=more and not first)[0]
            del dx
        for _ in range(warm):
            dy = send_recv(recv_next=True)[1]
            dx = backward(*held.popleft(), dy)
            send_recv(send_prev=dx)
            del dx

        reduce_sums(rp, sink.sums)
        if ends is not None:
            for n in shared:
                dist.all_reduce(sink.sums[n], group=ends)
        grads = {n: acc.div_(G * dp) for n, acc in sink.sums.items()}
        del sink
        if plan.grad_compression:
            grads = fake_compress(grads, sharding.global_amax)
        state, om = OPT.adam_update(state, grads, adam, sharding)
        # the last stage's loss plus every stage's aux term, averaged over
        # the micro-batches and the data ranks
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        if last:
            loss = torch.stack(losses).mean()
        if auxes:
            loss = loss + torch.stack(auxes).mean()
        dist.all_reduce(loss, group=par.dp_group)
        loss = loss / dp
        dist.all_reduce(loss, group=stage_group)
        metrics = {"loss": loss, **om, "step": state["step"]}
        return state, metrics

    return PipelineStep(fn=train_step, exec_cfg=ec, stage=s)

