"""Step builders (the port of ``repro/training/step.py``).

``make_train_step`` realizes a single-stage, one-device plan: CKPT/AO remat
segmentation (``segmented_layer_scan``), WO/OO host offload of the
optimizer state, optional int8 gradient compression and gradient
accumulation over G micro-batches.  ``make_prefill_step`` /
``make_serve_step`` bind the plan's serve ``ExecConfig``.  All are closures:
PyTorch runs eagerly, so there is no ``jit`` and no buffer donation; the
train step updates its state in place, and decode writes its cache in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.plan import Plan
from repro_torch.lowering import serve_exec_cfg, train_exec_cfg
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import Model
from repro_torch.parallel.compression import fake_compress
from repro_torch.training import optimizer as OPT


@dataclass
class TrainStep:
    fn: Callable
    exec_cfg: ExecConfig


def make_train_step(model: Model, plan: Plan,
                    adam: OPT.AdamConfig = OPT.AdamConfig(),
                    kernel_impl: str = "kernel") -> TrainStep:
    """``fn(state, batch)`` -> ``(state, {"loss", "grad_norm", "step"})``.

    The batch (B, S) splits into G = ``plan.grad_accum`` contiguous
    micro-batches; each micro-batch's gradients (in the params' dtype) add
    into f32 sums, divided by G at the end, and the loss is the mean of the
    micro-batch losses.  Then ``fake_compress`` if the plan asks for it, and
    ``adam_update`` on the state, in place.  ``kernel_impl="plain"`` is the
    test hook of ``ExecConfig.kernel_impl``.  Activations take the params'
    dtype (bf16, as the reference trains; f32 params compute in f32)."""
    ec = train_exec_cfg(plan).replace(kernel_impl=kernel_impl)
    G = plan.grad_accum

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        names = list(state["params"])
        leaves = [state["params"][n].detach().requires_grad_(True)
                  for n in names]
        params = dict(zip(names, leaves))
        run_ec = ec.replace(compute_dtype=params["embed/w"].dtype)
        b = batch["tokens"].shape[0]
        if b % G:
            raise ValueError(f"batch {b} does not split into {G} "
                             "micro-batches")
        mb = b // G
        sums, losses = None, []
        for i in range(G):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = model.loss_fn(params, micro, run_ec)
            grads = torch.autograd.grad(loss, leaves)
            if sums is None:
                sums = [g.float() for g in grads]
            else:
                for acc, g in zip(sums, grads):
                    acc.add_(g)
            losses.append(loss.detach())
            del grads, loss
        grads = {n: acc.div_(G) for n, acc in zip(names, sums)}
        del sums, params, leaves
        if plan.grad_compression:
            grads = fake_compress(grads)
        state, om = OPT.adam_update(state, grads, adam)
        metrics = {"loss": torch.stack(losses).mean(), **om,
                   "step": state["step"]}
        return state, metrics

    return TrainStep(fn=train_step, exec_cfg=ec)


def init_train_state(model: Model, plan: Plan, generator: torch.Generator
                     ) -> Dict[str, Any]:
    """A fresh train state on the model's device (the counterpart of the
    reference's ``init_sharded_state``): params from ``generator``, f32
    master/mu/nu split to host by the stage's WO/OO."""
    params, axes = model.init(generator)
    return OPT.init_state(params, axes, plan.stages[0])


@dataclass
class ServeStep:
    fn: Callable
    exec_cfg: ExecConfig


def make_prefill_step(model: Model, plan: Plan, return_cache: bool = False,
                      kernel_impl: str = "kernel") -> ServeStep:
    """``fn(params, batch)`` -> last-position logits (+ stacked caches).
    ``kernel_impl="plain"`` is the test hook of ``ExecConfig.kernel_impl``."""
    ec = serve_exec_cfg(plan).replace(kernel_impl=kernel_impl)

    @torch.inference_mode()
    def prefill(params, batch):
        return model.prefill_fn(params, batch, ec, return_cache)

    return ServeStep(fn=prefill, exec_cfg=ec)


def make_serve_step(model: Model, plan: Plan, batch: int = 1,
                    max_len: int = 1, kernel_impl: str = "kernel"
                    ) -> ServeStep:
    """``fn(params, tokens, caches)`` -> (logits, caches): one-token decode
    against caches of length ``max_len`` (written in place)."""
    if plan.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"kv_cache_dtype {plan.kv_cache_dtype!r}: "
                                  "the int8 KV cache is not ported yet")
    ec = serve_exec_cfg(plan).replace(cache_update="dus",
                                      kernel_impl=kernel_impl)

    @torch.inference_mode()
    def serve(params, tokens, caches):
        # the attention cache: the dense layout's own, or the hybrid's
        k = caches["attn"]["k"] if "attn" in caches else caches["k"]
        if k.shape[1] != batch or k.shape[2] != max_len:
            raise ValueError(f"caches {tuple(k.shape)} for batch {batch}, "
                             f"max_len {max_len}")
        return model.decode_fn(params, tokens, caches, ec)

    return ServeStep(fn=serve, exec_cfg=ec)
