"""Stacked decoder LM, dense and MoE GQA blocks (the port of
``repro/models/decoder.py``).

Init / loss / prefill / decode over flat-dict params with stacked-``L``
tensors.  ``run_layers`` (training and the cache-less prefill) runs the
layers through ``segmented_layer_scan`` (over views of each layer taken
by the train step's sink, or over the unbound stack); the serving paths
loop over views of layer ``i``.  An MoE block (``models/moe.py``) takes
the MLP's place and returns its aux loss, which ``run_layers`` sums over
the layers.  Mamba2 and mLSTM blocks wait for their slices.

Training under a multi-device plan (``ExecConfig.par``, see
``models/common.py``) runs on this rank's shards: attention and the MLP
are tensor-parallel (``models/layers.py``); under sequence parallelism the
residual stream, the norms and the embedding's output hold this rank's
part of the sequence (the reference's ``shard_act(h, ("dp", "sp",
None))``); the embedding and the loss are vocab-parallel when
``embed/w``'s vocab dim is split over ``model``.  A train step's
``ExecConfig.sink`` takes every use of a param into the graph
(``common.GradSink``): each layer's slices inside the layer body (under
ZeRO 3 that gathers them there, so a remat'd layer gathers them again in
the backward), the final norm, and the embedding once for its lookup and
once more, tied, for the head, so the two uses' gradients add into f32
apart.

The loss comes in the pieces a pipeline stage runs
(``parallel/pipeline.py``): ``embed_tokens`` on the first stage,
``run_layers`` over a stage's own layers on each (``final=False``), and
``final_norm`` with ``head_loss`` on the last; ``lm_loss`` runs them all.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.common import (Axes, ExecConfig, ParamBuilder, Params,
                                       StackedBuilder, all_gather_dim, in_use,
                                       layer, segmented_layer_scan,
                                       softmax_xent, subtree, unbind_layers)

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------


def block_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        raise NotImplementedError("Mamba2 / mLSTM blocks are not ported yet "
                                  "(ROADMAP.md, queue A: remaining families)")
    return "attn"  # dense / moe


def init_block(b: StackedBuilder, cfg: ArchConfig):
    block_kind(cfg)
    L.init_norm(b.scope("ln1"), cfg)
    L.init_attention(b.scope("attn"), cfg)
    L.init_norm(b.scope("ln2"), cfg)
    if cfg.is_moe:
        MOE.init_moe(b.scope("moe"), cfg)
    else:
        L.init_mlp(b.scope("mlp"), cfg)


def apply_block(p: Params, h: torch.Tensor, cfg: ArchConfig, ec: ExecConfig,
                cache: Optional[Dict] = None, mask_kind: str = "causal",
                return_cache: bool = False
                ) -> Tuple[torch.Tensor, float, Optional[Dict]]:
    """One attention block, dense or MoE.  Returns (h, aux_loss,
    new_cache); the aux loss of a dense block is 0.  Prefill and decode
    run the same block: a decode step routes its B tokens as one group."""
    block_kind(cfg)
    hn = L.norm(subtree(p, "ln1"), h, cfg, ec)
    fresh = return_cache and cache is None
    a, new_cache = L.attention(subtree(p, "attn"), hn, cfg, ec, cache=cache,
                               mask_kind=mask_kind, return_kv=fresh)
    if fresh:
        new_cache = _fresh_attn_cache(new_cache, hn.shape[1])
    h = h + a
    hn = L.norm(subtree(p, "ln2"), h, cfg, ec)
    if cfg.is_moe:
        m, aux = MOE.moe(subtree(p, "moe"), hn, cfg, ec)
        return h + m, aux, new_cache
    h = h + L.mlp(subtree(p, "mlp"), hn, cfg, ec.par)
    return h, 0.0, new_cache


def _fresh_attn_cache(kv: Dict, s: int) -> Dict:
    """A populated KV cache from a prefill pass (for the serving handoff).
    The reference recomputes the rotated k and v from the block input; the
    port keeps the ones attention just computed, which are the same
    values."""
    k = kv["k"]
    return {"k": k, "v": kv["v"],
            "pos": torch.tensor(s, dtype=torch.int32, device=k.device)}


# ---------------------------------------------------------------------------
# LM assembly
# ---------------------------------------------------------------------------


def init_lm(cfg: ArchConfig, generator: Optional[torch.Generator],
            dtype=torch.bfloat16, device="cpu", shard=None, layers=None,
            keep=None) -> Tuple[Params, Axes]:
    pb = ParamBuilder(generator, dtype, device, shard, layers, keep)
    pb.add("embed/w", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
           scale=0.02)
    init_block(StackedBuilder(pb, "layers", cfg.num_layers), cfg)
    L.init_norm(pb.scope("final_norm"), cfg)
    if not cfg.tie_embeddings:
        pb.add("lm_head/w", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
               scale=1.0 / math.sqrt(cfg.d_model))
    return pb.params, pb.axes


class _Lookup(torch.autograd.Function):
    """``w[tokens]`` whose gradient sums the rows of repeated tokens in f32
    in a fixed order (``embedding_dense_backward``) and rounds once to w's
    dtype.  Indexing's own gradient (an accumulating ``index_put_``) adds
    in an order that changes from run to run on the CPU, so two runs of
    one step would differ."""
    @staticmethod
    def forward(ctx, w, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = w.shape[0]
        return w[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        gw = torch.ops.aten.embedding_dense_backward(
            g.float(), tokens, ctx.rows, -1, False)
        return gw.to(g.dtype), None


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                 ec: ExecConfig) -> torch.Tensor:
    """The embedding lookup.  Under ``ec.par``: with the vocab split over
    ``model``, a masked lookup of this rank's rows whose partial results
    are summed over tp (reduce-scattered along the sequence under sequence
    parallelism); with the vocab replicated, the lookup of this rank's
    part of the sequence under sequence parallelism, else of all of it."""
    w, par = params["embed/w"], ec.par
    if par is None:
        return _Lookup.apply(w, tokens).to(ec.compute_dtype)
    if w.shape[0] == cfg.vocab_size:
        if par.sp:
            tokens = par.seq_part(tokens)
        return _Lookup.apply(w, tokens).to(ec.compute_dtype)
    ids = tokens - par.tp_rank * w.shape[0]
    mine = (ids >= 0) & (ids < w.shape[0])
    x = _Lookup.apply(w, ids.clamp(0, w.shape[0] - 1)) * mine[..., None]
    x = x.to(ec.compute_dtype)
    return par.tp_out(x) if par.sp else par.reduce_from_tp(x)


def unembed_matrix(params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed/w"].T
    return params["lm_head/w"]


def _logits(params: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # the product is rounded to h's dtype before widening, as in the reference
    return (h @ unembed_matrix(params, cfg)).float()


def serve_logits(params: Params, h: torch.Tensor, cfg: ArchConfig,
                 ec: ExecConfig) -> torch.Tensor:
    """The serving head's f32 logits of the final-normed ``h`` (only the
    rows the caller reads).  On a rank (``ec.par``) the head is taken
    through ``in_use`` (gathered under ZeRO 3), and where its vocab is
    split over ``model`` the ranks' columns are all-gathered, so that every
    tp rank holds the whole vocabulary and takes the same argmax."""
    if ec.par is None:
        return _logits(params, h, cfg)
    head = "embed/w" if cfg.tie_embeddings else "lm_head/w"
    w = unembed_matrix(in_use({head: params[head]}, ec), cfg)
    logits = (h @ w).float()
    if w.shape[1] != cfg.vocab_size:
        logits = all_gather_dim(logits, -1, ec.par.tp_group)
    return logits


def final_norm(params: Params, h: torch.Tensor, cfg: ArchConfig,
               ec: ExecConfig) -> torch.Tensor:
    return L.norm(in_use(subtree(params, "final_norm"), ec, "final_norm/"),
                  h, cfg, ec)


def run_layers(params: Params, x: torch.Tensor, cfg: ArchConfig,
               ec: ExecConfig, final: bool = True
               ) -> Tuple[torch.Tensor, float]:
    """The ``cfg.num_layers`` stacked layers of ``params`` (through
    ``segmented_layer_scan``, so the exec config's remat and offload
    segments apply), then the final norm unless ``final`` is False (a
    pipeline stage before the last).  Returns (h, aux_loss)."""
    stacked = subtree(params, "layers")
    if ec.sink is None:
        layers = unbind_layers(stacked, cfg.num_layers)
    else:       # views: the sink takes each layer's slices
        layers = [layer(stacked, i) for i in range(cfg.num_layers)]

    def body(carry, lp):
        h, aux, i = carry
        lp = in_use(lp, ec, "layers/", i)
        h, a, _ = apply_block(lp, h, cfg, ec)
        return h, aux + a, i + 1

    h, aux, _ = segmented_layer_scan(body, (x, 0.0, 0), layers,
                                     cfg.num_layers, ec)
    if final:
        h = final_norm(params, h, cfg, ec)
    return h, aux


def _chunk_nll(hh, w_out, ll, mm):
    logits = (hh @ w_out).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ll[..., None])[..., 0]
    nll = (lse - gold) * mm
    return nll.sum(), mm.sum()


def _chunk_nll_vocab_parallel(hh, w_out, ll, mm, par):
    """``_chunk_nll`` with this rank's columns of the vocab: the max and
    the sum of exponentials summed over tp, the gold logit from the rank
    that holds it."""
    logits = (hh @ w_out).float()
    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=par.tp_group)
    se = par.reduce_from_tp(torch.exp(logits - m[..., None]).sum(-1))
    ids = ll - par.tp_rank * w_out.shape[1]
    mine = (ids >= 0) & (ids < w_out.shape[1])
    gold = torch.gather(logits, -1, ids.clamp(0, w_out.shape[1] - 1)
                        [..., None])[..., 0]
    gold = par.reduce_from_tp(gold * mine)
    nll = (torch.log(se) + m - gold) * mm
    return nll.sum(), mm.sum()


def _parallel_xent(h, w_out, labels, mask, chunk, par, vocab_par,
                   denom=None):
    """``chunked_xent`` on one rank of a multi-device plan: vocab-parallel
    over the full sequence when ``w_out``'s vocab is split over ``model``,
    else the full head on this rank's part of the sequence (sequence
    parallelism, the mask split as the labels are), the sums then added
    over tp."""
    labels = labels.long()
    mask = mask.float() if mask is not None else \
        torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    if vocab_par:
        h = par.tp_in(h)
        fn = functools.partial(_chunk_nll_vocab_parallel, par=par)
    else:
        if par.sp:
            labels, mask = par.seq_part(labels), par.seq_part(mask)
        fn = _chunk_nll
    s = h.shape[1]
    c = min(chunk, s)
    if s % c:
        c = s
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        t, n = checkpoint(fn, h[:, sl], w_out, labels[:, sl], mask[:, sl],
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    if par.sp and not vocab_par:
        tot = par.reduce_from_tp(tot)
        dist.all_reduce(cnt, group=par.tp_group)
    return tot / (torch.clamp_min(cnt, 1.0) if denom is None else denom)


def chunked_xent(h: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, chunk: int = 512,
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy without materializing full (B, S, V) logits: a loop over
    sequence chunks, each checkpointed so that its logits are recomputed in
    the backward (the reference's ``jax.checkpoint`` scan body).  A sequence
    the chunk does not divide takes the full logits, as in the reference.
    ``denom``: what the masked sum is divided by in place of this batch's
    mask count (a data rank's part of a global mean)."""
    b_, s, _ = h.shape
    c = min(chunk, s)
    nc = s // c
    if nc * c != s:  # fall back for ragged smoke shapes
        return softmax_xent((h @ w_out).float(), labels, mask, denom)
    labels = labels.long()
    mask = mask.float() if mask is not None else \
        torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        t, n = checkpoint(_chunk_nll, h[:, sl], w_out, labels[:, sl],
                          mask[:, sl], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    return tot / (torch.clamp_min(cnt, 1.0) if denom is None else denom)


AUX_COEF = 0.01


def head_loss(params: Params, h: torch.Tensor,
              batch: Dict[str, torch.Tensor], cfg: ArchConfig,
              ec: ExecConfig) -> torch.Tensor:
    """The mean next-token loss of the final-normed hidden states ``h``
    against ``batch["labels"]`` (and ``"loss_mask"``, with
    ``"loss_denom"`` on a data rank: ``training.step.data_micros``):
    ``chunked_xent`` through the head, vocab- or sequence-parallel under
    ``ec.par``."""
    head = "embed/w" if cfg.tie_embeddings else "lm_head/w"
    w_out = unembed_matrix(in_use({head: params[head]}, ec), cfg)
    par = ec.par
    vocab_par = w_out.shape[1] != cfg.vocab_size
    mask, denom = batch.get("loss_mask"), batch.get("loss_denom")
    if par is None or not (vocab_par or par.sp):
        return chunked_xent(h, w_out, batch["labels"], mask, denom=denom)
    return _parallel_xent(h, w_out, batch["labels"], mask, 512, par,
                          vocab_par, denom)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ec: ExecConfig) -> torch.Tensor:
    """Mean next-token loss of a batch ``{"tokens", "labels"[,
    "loss_mask"]}`` (B, S), plus ``AUX_COEF`` times the mean aux loss (0 for
    dense blocks)."""
    x = embed_tokens(in_use({"embed/w": params["embed/w"]}, ec),
                     batch["tokens"], cfg, ec)
    h, aux = run_layers(params, x, cfg, ec)
    return head_loss(params, h, batch, cfg, ec) \
        + AUX_COEF * aux / cfg.num_layers


def lm_prefill(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, ec: ExecConfig, return_cache: bool = False):
    """Forward over the prompt; returns last-position logits (+ the stacked
    caches ``{"k", "v": (L, B, S, KV, hd), "pos": (L,) int32}``).  On a
    rank of a serving plan (``ec.par``): its rows, its heads and, in the
    caches, the kv heads its wk holds (``layers.attention``); the
    embedding vocab-parallel where its vocab is split, the logits whole
    (``serve_logits``), ZeRO-3 weights gathered a layer at a time
    (``ec.zero3``)."""
    x = embed_tokens(in_use({"embed/w": params["embed/w"]}, ec),
                     batch["tokens"], cfg, ec)
    if not return_cache:
        h, _ = run_layers(params, x, cfg, ec)
        return serve_logits(params, h[:, -1:], cfg, ec)
    stacked = subtree(params, "layers")
    h, caches = x, []
    for i in range(cfg.num_layers):
        h, _, nc = apply_block(in_use(layer(stacked, i), ec, "layers/", i),
                               h, cfg, ec, return_cache=True)
        caches.append(nc)
    h = final_norm(params, h, cfg, ec)
    stacked_caches = {key: torch.stack([c[key] for c in caches])
                      for key in ("k", "v", "pos")}
    return serve_logits(params, h[:, -1:], cfg, ec), stacked_caches


def lm_decode(params: Params, tokens: torch.Tensor, caches: Dict,
              cfg: ArchConfig, ec: ExecConfig):
    """One decode step: tokens (B,1) + stacked caches -> (logits, caches).

    ``pos`` is ``(L,)`` (lock-step decode) or ``(L, B)`` (a position per
    request: the paged engine); int8 caches carry ``k_scale``/``v_scale``.
    The k/v (and scale) buffers of ``caches`` are written IN PLACE (one row
    per layer at ``pos``); the returned caches hold the same buffers and
    ``pos + 1``."""
    x = embed_tokens(in_use({"embed/w": params["embed/w"]}, ec), tokens,
                     cfg, ec)
    stacked = subtree(params, "layers")
    h = x
    for i in range(cfg.num_layers):
        lc = {key: buf[i] for key, buf in caches.items()}
        h, _, _ = apply_block(in_use(layer(stacked, i), ec, "layers/", i),
                              h, cfg, ec, cache=lc)
    h = final_norm(params, h, cfg, ec)
    return serve_logits(params, h, cfg, ec), \
        dict(caches, pos=caches["pos"] + 1)


def init_lm_caches(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu") -> Dict:
    one = L.init_self_kv_cache(cfg, batch, max_len, dtype, device)
    # real (L, ...) buffers, not broadcast views: decode writes them in place
    return {k: v.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * v.dim())
            for k, v in one.items()}
