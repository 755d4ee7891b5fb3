"""Model registry (the port of ``repro/models/zoo.py``): the uniform
init / prefill / decode / caches interface, dense decoders only for now."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union

import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import decoder as DEC
from repro_torch.models.common import ExecConfig, Params, resolve_device


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        """(params, axes) with the reference's names, shapes and scales;
        values drawn from ``generator`` (on the model's device)."""
        return DEC.init_lm(self.cfg, generator, dtype, self.device)

    def prefill_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                   ec: ExecConfig, return_cache: bool = False):
        return DEC.lm_prefill(params, batch, self.cfg, ec, return_cache)

    def decode_fn(self, params: Params, tokens: torch.Tensor, caches: Dict,
                  ec: ExecConfig):
        return DEC.lm_decode(params, tokens, caches, self.cfg, ec)

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return DEC.init_lm_caches(self.cfg, batch, max_len, dtype,
                                  self.device)


def build_model(arch: Union[str, ArchConfig],
                device: Union[str, torch.device, None] = None) -> Model:
    """The model for ``arch`` on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``; raises without a CUDA device)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    dev = resolve_device(device)
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            "serves dense decoders (ROADMAP.md, queue A: MoE and remaining "
            "families)")
    return Model(cfg=cfg, device=dev)


def pad_caches(caches: Dict, extra: int) -> Dict:
    """Extend the stacked k/v caches ``(L, B, S, KV, hd)`` by ``extra`` zero
    slots along S (prefill fills the prompt length; decode appends)."""
    out = dict(caches)
    for key in ("k", "v"):
        x = caches[key]
        pad = torch.zeros(x.shape[:2] + (extra,) + x.shape[3:],
                          dtype=x.dtype, device=x.device)
        out[key] = torch.cat([x, pad], dim=2)
    return out
