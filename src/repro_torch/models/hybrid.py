"""Zamba2-style hybrid: Mamba2 backbone in groups, with one *shared*
attention+MLP block applied at the start of every group, fed by a
per-group projection of concat(hidden, original embedding) (the port of
``repro/models/hybrid.py``).  [arXiv:2411.15242]

Training and the cache-less prefill (``run_hybrid_layers``,
``hybrid_loss``) run the groups through ``segmented_layer_scan``, each
group the shared block and then its Mamba layers, with the plan's CKPT and
AO counted in groups as the reference counts them: ``ceil(min(ckpt, L) /
per)`` groups rematerialize, ``ceil(min(offload, L) / per)`` of them also
offload their inputs.  A train step's ``GradSink`` takes each use of a
param inside the group body: the group's in-proj ``(g,)``, each Mamba
layer's slices ``(g, l)``, and the shared block once per group, whose
gradients add into one f32 sum.  The serving paths with caches loop over
views of the ``(groups, per)`` stacked Mamba params.

Training under a single-stage multi-device plan (``ExecConfig.par``) runs
on this rank's shards, cut as the reference's spec tables cut them: the
shared block's attention and MLP are tensor-parallel as a dense layer's,
each Mamba mixer runs its H / tp heads (``ssm.mamba2_mixer``), the
embedding and the head are vocab-parallel, and under sequence parallelism
the residual stream, ``x0``, every norm and the group's in-proj hold this
rank's part of the sequence (the reference's ``shard_act(h, ("dp", "sp",
None))``).  There is no hybrid pipeline (S > 1), as the reference has
none (its ``PIPELINE_FAMILIES``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.common import (Axes, ExecConfig, ParamBuilder, Params,
                                       StackedBuilder, in_use, layer,
                                       segmented_layer_scan, subtree,
                                       unbind_layers)
from repro_torch.models.decoder import (_fresh_attn_cache, _logits,
                                        embed_tokens, final_norm, head_loss)


def group_shape(cfg: ArchConfig) -> Tuple[int, int]:
    per = cfg.shared_attn_every
    assert cfg.num_layers % per == 0, (cfg.num_layers, per)
    return cfg.num_layers // per, per


def init_hybrid(cfg: ArchConfig, generator: Optional[torch.Generator],
                dtype=torch.bfloat16, device="cpu", shard=None, layers=None,
                keep=None) -> Tuple[Params, Axes]:
    """``shard``: keep one rank's part of each param (``ParamBuilder``);
    ``layers`` / ``keep`` (a pipeline stage's part) raise: the hybrid has
    no pipeline."""
    if (layers, keep) != (None, None):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid has no pipeline stages (the reference's "
            "PIPELINE_FAMILIES, src/repro/parallel/pipeline.py:42)")
    pb = ParamBuilder(generator, dtype, device, shard)
    d = cfg.d_model
    ng, per = group_shape(cfg)
    pb.add("embed/w", (cfg.vocab_size, d), ("vocab", "embed"), scale=0.02)
    # per-group input projection for the shared block: concat(h, x0) -> d
    gb = StackedBuilder(pb, "groups", ng)
    gb.add("in_proj", (2 * d, d), ("embed", None), scale=1.0 / math.sqrt(2 * d))
    # shared attention + MLP block (one set of weights, applied ng times)
    sb = pb.scope("shared")
    L.init_norm(sb.scope("ln1"), cfg)
    L.init_attention(sb.scope("attn"), cfg)
    L.init_norm(sb.scope("ln2"), cfg)
    L.init_mlp(sb.scope("mlp"), cfg)
    # mamba backbone, stacked (groups, per-group)
    mb = StackedBuilder(pb, "mamba", (ng, per))
    L.init_norm(mb.scope("ln"), cfg)
    SSM.init_mamba2(mb.scope("mixer"), cfg)
    L.init_norm(pb.scope("final_norm"), cfg)
    pb.add("lm_head/w", (d, cfg.vocab_size), ("embed", "vocab"),
           scale=1.0 / math.sqrt(d))
    return pb.params, pb.axes


def _shared_block(shared: Params, gin: torch.Tensor, h: torch.Tensor,
                  x0: torch.Tensor, cfg: ArchConfig, ec: ExecConfig,
                  cache: Optional[Dict] = None, return_cache: bool = False):
    """Apply the shared attention block; gin is this group's in-proj.  A
    fresh cache (``return_cache`` without ``cache``) keeps the k/v that
    attention computed."""
    z = torch.cat([h, x0], dim=-1) @ gin
    zn = L.norm(subtree(shared, "ln1"), z, cfg, ec)
    fresh = return_cache and cache is None
    a, new_cache = L.attention(subtree(shared, "attn"), zn, cfg, ec,
                               cache=cache, return_kv=fresh)
    if fresh:
        new_cache = _fresh_attn_cache(new_cache, zn.shape[1])
    z = z + a
    zn = L.norm(subtree(shared, "ln2"), z, cfg, ec)
    z = z + L.mlp(subtree(shared, "mlp"), zn, cfg, ec.par)
    return h + z, new_cache


def _mamba_layer(lp: Params, h: torch.Tensor, cfg: ArchConfig,
                 ec: ExecConfig, cache=None, return_state=False):
    hn = L.norm(subtree(lp, "ln"), h, cfg, ec)
    m, nc = SSM.mamba2_mixer(subtree(lp, "mixer"), hn, cfg, ec, cache=cache,
                             return_state=return_state)
    return h + m, nc


def _forward(params: Params, x: torch.Tensor, cfg: ArchConfig,
             ec: ExecConfig):
    """The prefill that fills the caches: every group (shared block, then
    its Mamba layers), then the final norm.  Returns (h, caches)."""
    ng, per = group_shape(cfg)
    shared = subtree(params, "shared")
    mamba = subtree(params, "mamba")
    gin = params["groups/in_proj"]
    h, attn_c, mamba_c = x, [], []
    for gi in range(ng):
        h, ac = _shared_block(shared, gin[gi], h, x, cfg, ec,
                              return_cache=True)
        attn_c.append(ac)
        group = layer(mamba, gi)
        for li in range(per):
            h, mc = _mamba_layer(layer(group, li), h, cfg, ec,
                                 return_state=True)
            mamba_c.append(mc)
    h = L.norm(subtree(params, "final_norm"), h, cfg, ec)
    caches = {
        "attn": {key: torch.stack([c[key] for c in attn_c])
                 for key in ("k", "v", "pos")},
        "mamba": {key: torch.stack([c[key] for c in mamba_c])
                  .unflatten(0, (ng, per)) for key in ("conv", "ssm")},
    }
    return h, caches


def _groups(params: Params, ng: int, per: int, ec: ExecConfig
            ) -> List[Params]:
    """Each group's stacked params as the layer loop takes them: its
    in-proj and its ``(per, ...)`` Mamba stack (``mamba/...``).  Views when
    a sink takes them (inside the group body); unbound once per loss when
    the params are the caller's autograd leaves (``unbind_layers``)."""
    mamba = subtree(params, "mamba")
    gin = params["groups/in_proj"]
    if ec.sink is None:
        ins, stacks = gin.unbind(0), unbind_layers(mamba, ng)
    else:
        ins, stacks = [gin[g] for g in range(ng)], \
            [layer(mamba, g) for g in range(ng)]
    return [{"in_proj": ins[g], **{f"mamba/{k}": v
                                   for k, v in stacks[g].items()}}
            for g in range(ng)]


def run_hybrid_layers(params: Params, x: torch.Tensor, cfg: ArchConfig,
                      ec: ExecConfig) -> torch.Tensor:
    """Train/prefill forward over all groups (remat- and offload-segmented
    at group level), then the final norm."""
    ng, per = group_shape(cfg)
    shared = subtree(params, "shared")
    x0 = x
    # remat segmentation quantized to groups: ckpt_layers -> groups
    ec_g = ec.replace(
        ckpt_layers=-(-min(ec.ckpt_layers, cfg.num_layers) // per),
        offload_layers=-(-min(ec.offload_layers, cfg.num_layers) // per))

    def group_body(carry, gp):
        h, gi = carry
        gin = in_use({"groups/in_proj": gp["in_proj"]}, ec, layer=gi)
        h, _ = _shared_block(in_use(shared, ec, "shared/"),
                             gin["groups/in_proj"], h, x0, cfg, ec)
        stack = {k[len("mamba/"):]: v for k, v in gp.items()
                 if k.startswith("mamba/")}
        lps = unbind_layers(stack, per) if ec.sink is None else \
            [layer(stack, li) for li in range(per)]
        for li, lp in enumerate(lps):
            h, _ = _mamba_layer(in_use(lp, ec, "mamba/", (gi, li)), h, cfg,
                                ec)
        return h, gi + 1

    h, _ = segmented_layer_scan(group_body, (x, 0),
                                _groups(params, ng, per, ec), ng, ec_g)
    return final_norm(params, h, cfg, ec)


def hybrid_loss(params: Params, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig, ec: ExecConfig) -> torch.Tensor:
    """Mean next-token loss of a batch ``{"tokens", "labels"[,
    "loss_mask"]}`` (B, S): ``chunked_xent`` through the untied
    ``lm_head/w`` (``decoder.head_loss``, which also takes a data rank's
    ``loss_denom``)."""
    x = embed_tokens(in_use({"embed/w": params["embed/w"]}, ec),
                     batch["tokens"], cfg, ec)
    h = run_hybrid_layers(params, x, cfg, ec)
    return head_loss(params, h, batch, cfg, ec)


def hybrid_prefill(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ArchConfig, ec: ExecConfig,
                   return_cache: bool = False):
    """Forward over the prompt; returns last-position logits (+ the caches
    ``{"attn": {"k", "v": (G, B, S, KV, hd), "pos": (G,)}, "mamba":
    {"conv": (G, per, B, K-1, convdim), "ssm": (G, per, B, H, P, N) f32}}``)."""
    x = embed_tokens(params, batch["tokens"], cfg, ec)
    if not return_cache:
        h = run_hybrid_layers(params, x, cfg, ec)
        return _logits(params, h[:, -1:], cfg)
    h, caches = _forward(params, x, cfg, ec)
    return _logits(params, h[:, -1:], cfg), caches


def hybrid_decode(params: Params, tokens: torch.Tensor, caches: Dict,
                  cfg: ArchConfig, ec: ExecConfig):
    """One decode step: tokens (B,1) + caches -> (logits, caches).

    ``pos`` is ``(G,)``, or ``(G, B)`` with a position per request (the
    paged engine); int8 attention caches carry ``k_scale``/``v_scale``.
    Every buffer of ``caches`` is written IN PLACE (the attention k/v row at
    ``pos``, each layer's conv window and SSM state); the returned caches
    hold the same buffers and ``pos + 1``."""
    ng, per = group_shape(cfg)
    x = embed_tokens(params, tokens, cfg, ec)
    shared = subtree(params, "shared")
    mamba = subtree(params, "mamba")
    gin = params["groups/in_proj"]
    ac, mc = caches["attn"], caches["mamba"]
    h = x
    for gi in range(ng):
        gc = {key: buf[gi] for key, buf in ac.items()}
        h, _ = _shared_block(shared, gin[gi], h, x, cfg, ec, cache=gc)
        group = layer(mamba, gi)
        for li in range(per):
            lc = {"conv": mc["conv"][gi, li], "ssm": mc["ssm"][gi, li]}
            h, nc = _mamba_layer(layer(group, li), h, cfg, ec, cache=lc)
            lc["conv"].copy_(nc["conv"])
            lc["ssm"].copy_(nc["ssm"])
    h = L.norm(subtree(params, "final_norm"), h, cfg, ec)
    new_caches = {"attn": dict(ac, pos=ac["pos"] + 1), "mamba": mc}
    return _logits(params, h, cfg), new_caches


def init_hybrid_caches(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cpu") -> Dict:
    ng, per = group_shape(cfg)
    attn_c = L.init_self_kv_cache(cfg, batch, max_len, dtype, device)
    # an int8 KV cache quantizes the attention k/v only: the conv window
    # holds activations in the compute dtype (docs/port.md)
    mamba_c = SSM.init_mamba2_cache(
        cfg, batch, torch.bfloat16 if dtype == torch.int8 else dtype, device)
    # real stacked buffers, not broadcast views: decode writes them in place
    return {
        "attn": {k: v.unsqueeze(0).repeat((ng,) + (1,) * v.dim())
                 for k, v in attn_c.items()},
        "mamba": {k: v[None, None].repeat((ng, per) + (1,) * v.dim())
                  for k, v in mamba_c.items()},
    }
