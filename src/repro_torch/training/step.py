"""Step builders (the port of ``repro/training/step.py``): serve steps only.

``make_prefill_step`` / ``make_serve_step`` are closures that bind the
plan's serve ``ExecConfig``; PyTorch runs eagerly, so there is no ``jit``
and no buffer donation (decode writes its cache in place instead).  The
train step waits for the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.plan import Plan
from repro_torch.lowering import serve_exec_cfg
from repro_torch.models.common import ExecConfig
from repro_torch.models.zoo import Model


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
