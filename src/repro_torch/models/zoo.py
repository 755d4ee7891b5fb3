"""Model registry (the port of ``repro/models/zoo.py``): the uniform
init / loss / prefill / decode / caches interface over the ported families
-- dense and MoE decoders and the Zamba2 hybrid, each served and trained on
one device or on a rank of a multi-device plan (pipelined plans, S > 1,
train dense and MoE decoders only, as in the reference; the hybrid serves
on one device only, ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import decoder as DEC
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models.common import ExecConfig, Params, resolve_device

# family -> (init, loss, prefill, decode, init_caches), one signature each
_DECODER = (DEC.init_lm, DEC.lm_loss, DEC.lm_prefill, DEC.lm_decode,
            DEC.init_lm_caches)
_FAMILIES = {
    "dense": _DECODER,
    "moe": _DECODER,
    "hybrid": (HY.init_hybrid, HY.hybrid_loss, HY.hybrid_prefill,
               HY.hybrid_decode, HY.init_hybrid_caches),
}


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    def init(self, generator: torch.Generator, dtype=torch.bfloat16,
             shard=None, layers=None, keep=None):
        """(params, axes) with the reference's names, shapes and scales;
        values drawn from ``generator`` (on the model's device).
        ``shard``: keep one rank's part of each param; ``layers``, ``keep``:
        a pipeline stage's layers and params (``ParamBuilder``), dense
        decoders only (the hybrid raises: it has no pipeline)."""
        return _FAMILIES[self.cfg.family][0](self.cfg, generator, dtype,
                                             self.device, shard, layers, keep)

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                ec: ExecConfig) -> torch.Tensor:
        """The training loss (a scalar tensor) of ``batch`` ``{"tokens",
        "labels"[, "loss_mask"]}``, on one device or, with ``ec.par``, on
        one rank of a single-stage multi-device plan."""
        return _FAMILIES[self.cfg.family][1](params, batch, self.cfg, ec)

    def prefill_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                   ec: ExecConfig, return_cache: bool = False):
        return _FAMILIES[self.cfg.family][2](params, batch, self.cfg, ec,
                                             return_cache)

    def decode_fn(self, params: Params, tokens: torch.Tensor, caches: Dict,
                  ec: ExecConfig):
        return _FAMILIES[self.cfg.family][3](params, tokens, caches,
                                             self.cfg, ec)

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    shard=None):
        """The zeroed decode caches for ``batch`` rows of ``max_len``
        positions.  ``shard(path, shape)``: a rank's shape of the leaf at
        ``path`` (``training.step.ServeRank.local_shape``); every leaf is
        then allocated at that shape, and no rank ever holds the whole
        cache."""
        init = _FAMILIES[self.cfg.family][4]
        if shard is None:
            return init(self.cfg, batch, max_len, dtype, self.device)
        meta = init(self.cfg, batch, max_len, dtype, "meta")

        def alloc(tree, path):
            return {k: alloc(v, path + (k,)) if isinstance(v, dict)
                    else torch.zeros(shard(path + (k,), tuple(v.shape)),
                                     dtype=v.dtype, device=self.device)
                    for k, v in tree.items()}

        return alloc(meta, ())


def build_model(arch: Union[str, ArchConfig],
                device: Union[str, torch.device, None] = None) -> Model:
    """The model for ``arch`` on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``; raises without a CUDA device).  ``"meta"`` gives a
    model for shape probes: its ``init(None)`` and ``init_caches`` allocate
    nothing."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    dev = resolve_device(device, allow_meta=True)
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            "runs dense and MoE decoders and the Zamba2 hybrid (ROADMAP.md, "
            "queue A: remaining families)")
    return Model(cfg=cfg, device=dev)


def pad_caches(caches: Dict, extra: int) -> Dict:
    """Extend the attention caches by ``extra`` zero slots along S (prefill
    fills the prompt length; decode appends).  Shape-agnostic: a rank's
    caches (its rows and kv heads) pad the same way, before
    ``ServeStep.place`` cuts a split sequence.  Walks the cache tree --
    dense ``{k, v, pos}`` or the hybrid's ``{"attn": {k, v, pos}, "mamba":
    {conv, ssm}}``, with ``k_scale``/``v_scale`` beside int8 k/v -- and
    pads leaves by name, as the reference does: k/v ``(lead, B, S, KV,
    hd)`` along S, the third dim from the end, the scales ``(lead, B, S,
    KV)`` along S, the second from the end; every other leaf passes
    through."""
    out = {}
    for key, x in caches.items():
        if isinstance(x, dict):
            out[key] = pad_caches(x, extra)
        elif key in ("k", "v") and x.dim() >= 3:
            out[key] = F.pad(x, (0, 0, 0, 0, 0, extra))
        elif key in ("k_scale", "v_scale") and x.dim() >= 2:
            out[key] = F.pad(x, (0, 0, 0, extra))
        else:
            out[key] = x
    return out


def quantize_caches(caches: Dict) -> Dict:
    """A bf16 prefill cache tree in the int8 layout decode reads under
    ``kv_cache_dtype="int8"``: every self-attention ``{k, v, pos}`` dict
    gets int8 k/v and their f32 scales (``layers.quantize_kv``, per token
    and head, so a rank's part quantizes as its part of the whole);
    everything else -- SSM state, conv windows, ``pos`` -- passes
    through."""
    if "k" in caches and "v" in caches and "pos" in caches:
        (kq, ks), (vq, vs) = L.quantize_kv(caches["k"]), \
            L.quantize_kv(caches["v"])
        return dict(caches, k=kq, v=vq, k_scale=ks, v_scale=vs)
    return {key: quantize_caches(x) if isinstance(x, dict) else x
            for key, x in caches.items()}
