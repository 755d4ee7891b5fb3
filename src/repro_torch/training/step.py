"""Step builders (the port of ``repro/training/step.py``).

``make_train_step`` realizes a single-stage plan: CKPT/AO remat
segmentation (``segmented_layer_scan``), WO/OO host offload of the
optimizer state, optional int8 gradient compression and gradient
accumulation over G micro-batches; on one device, or with ``mesh`` on one
rank of the plan's ``(data, model)`` mesh (tensor parallelism with or
without sequence parallelism, data parallelism, ZeRO 0-3), where every
collective is written out and runs in the same order on every rank, at
world size 1 too.  Gradients accumulate through a ``GradSink``
(``models/common.py``): each use of a param adds its gradient in f32 into
the step's sums as the backward reaches it, and no param is an autograd
leaf.  ``init_sharded_state`` builds a rank's part of a fresh
state.  ``make_prefill_step`` / ``make_serve_step`` bind the plan's serve
``ExecConfig``; ``make_paged_serve_step`` is the decode step of the
continuous-batching engine (``serving/``) over page pools.  With ``mesh``
each runs one rank of a single-stage serving plan (``serve_rank``): its
rows of the batch where dp divides it, its heads and its part of the cache
as ``LoweredPlan.cache_specs`` places it, its params from
``init_rank_params`` (or ``bridge.shard_params``).  All are
closures: PyTorch runs eagerly, so there is no
``jit`` and no buffer donation; the train step updates its state in
place, and decode writes its cache in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.plan import Plan
from repro_torch.launch.mesh import mesh_coords
from repro_torch.lowering import (lower_plan, serve_exec_cfg, shard_tensor,
                                  train_exec_cfg)
from repro_torch.models.common import (ExecConfig, GradSink, KVSplit,
                                       Parallel, WeightGather, all_gather_dim)
from repro_torch.models.zoo import Model
from repro_torch.parallel.compression import fake_compress
from repro_torch.parallel.sharding import local_shape, mesh_shape
from repro_torch.serving.pages import tree_get, tree_paths
from repro_torch.training import optimizer as OPT


@dataclass
class TrainStep:
    fn: Callable
    exec_cfg: ExecConfig


def make_train_step(model: Model, plan: Plan,
                    adam: OPT.AdamConfig = OPT.AdamConfig(),
                    kernel_impl: str = "kernel", mesh=None) -> TrainStep:
    """``fn(state, batch)`` -> ``(state, {"loss", "grad_norm", "step"})``.

    The batch (B, S) splits into G = ``plan.grad_accum`` contiguous
    micro-batches; each micro-batch's gradients (in the params' dtype) add
    into f32 sums as its backward runs (``GradSink``), divided by G at the
    end, and the loss is the mean of the micro-batch losses.  Then
    ``fake_compress`` if the plan asks for it, and ``adam_update`` on the
    state, in place.  ``kernel_impl="plain"`` is the test hook of
    ``ExecConfig.kernel_impl``.  Activations take the params' dtype (bf16,
    as the reference trains; f32 params compute in f32).

    ``mesh``: the plan's live ``(data, model)`` DeviceMesh
    (``launch/mesh.py``); the state is then this rank's shards
    (``init_sharded_state``) and the batch the global batch, of which data
    rank r takes its rows of each micro-batch (``_sharded_train_step``)."""
    ec = train_exec_cfg(plan, 1 if mesh is None else mesh.size()
                        ).replace(kernel_impl=kernel_impl)
    if mesh is not None:
        return _sharded_train_step(model, plan, adam, ec, mesh)
    G = plan.grad_accum

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params = state["params"]
        b = batch["tokens"].shape[0]
        if b % G:
            raise ValueError(f"batch {b} does not split into {G} "
                             "micro-batches")
        mb = b // G
        sink = GradSink(grad_sums(params))
        losses = micro_steps(model, params, [
            {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(G)], ec, sink)
        grads = {n: acc.div_(G) for n, acc in sink.sums.items()}
        del sink
        if plan.grad_compression:
            grads = fake_compress(grads)
        state, om = OPT.adam_update(state, grads, adam)
        metrics = {"loss": torch.stack(losses).mean(), **om,
                   "step": state["step"]}
        return state, metrics

    return TrainStep(fn=train_step, exec_cfg=ec)


def grad_sums(params, shapes=None) -> Dict[str, torch.Tensor]:
    """The step's f32 gradient accumulators, zeros: of each param's shape,
    or of ``shapes[name]`` (a gradient shard finer than the param)."""
    shapes = shapes or {}
    return {n: torch.zeros(shapes.get(n, p.shape), dtype=torch.float32,
                           device=p.device) for n, p in params.items()}


def micro_steps(model: Model, params, micros, ec: ExecConfig,
                sink: GradSink):
    """Forward and backward of each micro-batch, its gradients into
    ``sink``; returns the micro-batch losses (detached)."""
    run_ec = ec.replace(compute_dtype=params["embed/w"].dtype, sink=sink)
    losses = []
    for micro in micros:
        loss = model.loss_fn(params, micro, run_ec)
        loss.backward()
        losses.append(loss.detach())
        del loss
    return losses


def init_train_state(model: Model, plan: Plan, generator: torch.Generator
                     ) -> Dict[str, Any]:
    """A fresh train state on the model's device (the counterpart of the
    reference's ``init_sharded_state``): params from ``generator``, f32
    master/mu/nu split to host by the stage's WO/OO."""
    params, axes = model.init(generator)
    return OPT.init_state(params, axes, plan.stages[0])


# -- multi-device -------------------------------------------------------------

# the params tensor parallelism splits on their heads, d_ff, d_inner or
# experts (column-parallel wq/bq/wg/wu, row-parallel wo/wd, the Mamba
# mixer's head-split params, the MoE's experts on E or on moe_d_ff and its
# shared expert): tp > 1 needs every one of them split
_TP_SPLIT = tuple(f"{blk}/{n}" for blk in ("layers", "shared") for n in (
    "attn/wq", "attn/bq", "attn/wo", "mlp/wg", "mlp/wu", "mlp/wd")) + tuple(
    f"mamba/mixer/{n}" for n in ("in_proj", "conv_w", "conv_b", "A_log", "D",
                                 "dt_bias", "norm_scale", "out_proj")) + \
    tuple(f"layers/moe/{n}" for n in ("wg", "wu", "wd", "shared_wg",
                                      "shared_wu", "shared_wd"))
# the reference pipelines these families only (PIPELINE_FAMILIES,
# src/repro/parallel/pipeline.py:42)
PIPELINE_FAMILIES = ("dense", "moe", "ssm")


def _lowered(model: Model, plan: Plan, mesh):
    if plan.num_stages > 1 and model.cfg.family not in PIPELINE_FAMILIES:
        raise NotImplementedError(
            f"{model.cfg.name}: a plan of {plan.num_stages} stages; the "
            f"{model.cfg.family} family has no pipeline, as in the "
            f"reference (PIPELINE_FAMILIES = {PIPELINE_FAMILIES}, "
            "src/repro/parallel/pipeline.py:42)")
    low = lower_plan(model.cfg, None, plan, mesh)
    return low, mesh_shape(mesh), mesh_coords(mesh)


@dataclass
class RankPlan:
    """One rank's part of a multi-device plan: the lowering, its stage
    (0 for a single-stage plan), its ``Parallel`` and its stage's spec
    tables."""
    low: Any
    stage: int
    par: Parallel
    pspecs: Dict[str, Any]
    gspecs: Dict[str, Any]
    ospecs: Dict[str, Any]

    @property
    def tp_partial(self):
        return _tp_partial(self.pspecs, self.par.sp, self.par.tp)


def rank_plan(model: Model, plan: Plan, mesh) -> RankPlan:
    """This rank's ``RankPlan`` on the live mesh; raises where tp does not
    split the products tensor parallelism splits."""
    low, sizes, coords = _lowered(model, plan, mesh)
    i = coords.get("stage", 0)
    pspecs = low.param_specs(i)
    par = Parallel(mesh.get_group("data"), mesh.get_group("model"),
                   sizes["data"], sizes["model"], coords["data"],
                   coords["model"], sp=low.shard_rules(i)["sp"] is not None)
    if par.tp > 1:
        whole = [n for n in _TP_SPLIT if n in pspecs
                 and "model" not in pspecs[n]]
        if whole:
            raise NotImplementedError(
                f"tp {par.tp} does not split {whole} (heads "
                f"{model.cfg.num_heads}, d_ff {model.cfg.d_ff}, experts "
                f"{model.cfg.num_experts} of {model.cfg.moe_d_ff}); "
                "ROADMAP.md, queue A: sharding on torch")
    return RankPlan(low, i, par, pspecs, low.grad_specs(i),
                    low.opt_specs(i))


def data_micros(batch, G: int, par: Parallel):
    """This data rank's rows of each of the G micro-batches of the global
    ``batch``.  With a ``loss_mask`` and dp > 1, each micro-batch also
    carries ``loss_denom``: max(its global mask count, 1) / dp, so that
    the data ranks' losses, averaged over dp, and their gradients, summed
    and divided by dp, are the global micro-batch's masked mean, as the
    reference takes it (every rank holds the whole batch, so the count
    needs no communication)."""
    b, dp = batch["tokens"].shape[0], par.dp
    if b % (G * dp):
        raise ValueError(f"batch {b} does not split into {G} "
                         f"micro-batches over {dp} data ranks")
    mbg = b // G
    lo = par.dp_rank * (mbg // dp)
    micros = [{k: v[i * mbg + lo:i * mbg + lo + mbg // dp]
               for k, v in batch.items()} for i in range(G)]
    if "loss_mask" in batch and dp > 1:
        for i, micro in enumerate(micros):
            count = batch["loss_mask"][i * mbg:(i + 1) * mbg].float().sum()
            micro["loss_denom"] = torch.clamp_min(count, 1.0) / dp
    return micros


def reduce_sums(rp: RankPlan, sums) -> None:
    """After the last micro-batch: the sums no grad spec splits over
    ``data`` all-reduced over it, then the ``tp_partial`` ones over
    ``model``."""
    partial = rp.tp_partial
    for n, acc in sums.items():
        if "data" not in rp.gspecs[n]:
            dist.all_reduce(acc, group=rp.par.dp_group)
        if n in partial:
            dist.all_reduce(acc, group=rp.par.tp_group)


def rank_sink(params, pspecs, gspecs, par: Parallel) -> GradSink:
    """A rank's ``GradSink``: accumulators of the grad specs' shards,
    gradients reduce-scattered over ``data`` where the grad spec splits a
    dim (ZeRO 2 and 3), weights gathered where the param spec does too
    (ZeRO 3)."""
    scatter = {n: gspecs[n].index("data") for n in params
               if "data" in gspecs[n]}
    gather = [n for n in scatter if "data" in pspecs[n]]
    shapes = {}
    for n, d in scatter.items():
        if n not in gather:
            shape = list(params[n].shape)
            shape[d] //= par.dp
            shapes[n] = shape
    return GradSink(grad_sums(params, shapes), scatter, gather, par.dp_group)


def _tp_partial(pspecs, sp: bool, tp: int):
    """Params replicated over ``model`` whose tp ranks each use them on
    part of the work, so their gradients are summed over tp: under
    sequence parallelism every one (the norms, the embedding, the MoE's
    router and shared gate see this rank's part of the sequence), and
    wk/wv with bk/bv when the kv heads do not split (each rank projects
    the kv heads its query heads read)."""
    if tp == 1:
        return set()
    kv = {f"{blk}/attn/{w}" for blk in ("layers", "shared")
          for w in ("wk", "wv", "bk", "bv")}
    return {n for n, sp_ in pspecs.items() if "model" not in sp_
            and (sp or n in kv)}


def _sharded_train_step(model, plan, adam, ec, mesh) -> TrainStep:
    """The train step of one rank (``make_train_step``'s ``mesh``).

    Gradients, by ZeRO level: at ZeRO 0/1 the f32 sums are all-reduced
    over ``data`` once after the last micro-batch; at ZeRO 2 and 3 each
    use's gradient is reduce-scattered into f32 accumulators split over
    ``data`` as the backward reaches it (the reference's
    ``with_sharding_constraint(acc, g_shardings)``; ``rank_sink``).
    Params split over neither keep all-reduced sums.  Then the sums of
    ``_tp_partial`` params are all-reduced over ``model``, and all are
    divided by G · dp (the mean over the global batch).  The loss is the
    micro-batches' mean, averaged over dp (under a loss mask each data
    rank's part of the global masked mean, ``data_micros``)."""
    rp = rank_plan(model, plan, mesh)
    par = rp.par
    ec = ec.replace(par=par)
    sharding = OPT.StateSharding(rp.pspecs, rp.gspecs, rp.ospecs, par)
    G, dp = plan.grad_accum, par.dp

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params = state["params"]
        micros = data_micros(batch, G, par)
        sink = rank_sink(params, rp.pspecs, rp.gspecs, par)
        losses = micro_steps(model, params, micros, ec, sink)
        reduce_sums(rp, sink.sums)
        grads = {n: acc.div_(G * dp) for n, acc in sink.sums.items()}
        del sink
        if plan.grad_compression:
            grads = fake_compress(grads, sharding.global_amax)
        state, om = OPT.adam_update(state, grads, adam, sharding)
        loss = torch.stack(losses).mean()
        dist.all_reduce(loss, group=par.dp_group)
        metrics = {"loss": loss / dp, **om, "step": state["step"]}
        return state, metrics

    return TrainStep(fn=train_step, exec_cfg=ec)


def init_sharded_state(model: Model, plan: Plan, mesh,
                       generator: torch.Generator) -> Dict[str, Any]:
    """This rank's part of a fresh train state (the reference's
    ``init_sharded_state``): every rank draws the same params from
    ``generator``, one stacked layer at a time, and keeps its part by the
    param specs; master/mu/nu by the opt specs, split to host by its
    stage's WO/OO.  On a pipeline stage, its part is its own layers and,
    on the first and the last stage, the embedding, head and final norm
    (``LoweredStage.holds``).  No rank holds more than one layer of a
    param whole."""
    low, sizes, coords = _lowered(model, plan, mesh)
    i = coords.get("stage", 0)
    ls = low.stages[i]
    pspecs, ospecs = low.param_specs(i), low.opt_specs(i)

    def shard(name, x, lead):
        return shard_tensor(x, pspecs[name][lead:], sizes, coords)

    if len(low.stages) == 1:
        params, axes = model.init(generator, shard=shard)
    else:
        from repro_torch.core.costmodel_params import meta_params
        _, full_axes = meta_params(model.cfg)
        params, axes = model.init(
            generator, shard=shard, layers=ls.layers,
            keep=lambda n: ls.holds(n, full_axes[n]))
    # where the opt specs split finer (ZeRO 1 and 2), this rank's data part
    finer = {n: tuple(o if p is None else None
                      for p, o in zip(pspecs[n], ospecs[n])) for n in params}
    opt_params = {n: shard_tensor(p, finer[n], sizes, coords)
                  for n, p in params.items()}
    return OPT.init_state(params, axes, ls.stage, opt_params)


def init_rank_params(model: Model, plan: Plan, mesh,
                     generator: torch.Generator, dtype=torch.bfloat16):
    """(params, axes) of this rank of a single-stage plan, for serving:
    every rank draws the whole model's params from ``generator``, one
    stacked layer at a time, and keeps its part by the param specs (tp,
    and data under ZeRO 3), so no rank ever holds the model whole."""
    low, sizes, coords = _lowered(model, plan, mesh)
    pspecs = low.param_specs(0)

    def shard(name, x, lead):
        return shard_tensor(x, pspecs[name][lead:], sizes, coords)

    return model.init(generator, dtype, shard=shard)


@dataclass
class ServeRank:
    """One rank of a single-stage serving plan at one cache shape ``(batch,
    max_len)`` (``serve_rank``): the lowering, the mesh's sizes and this
    rank's coordinates, the cache's spec tree and whole tree (on the meta
    device: its shapes), the
    serving ``ExecConfig`` (its ``Parallel``, cache-update mode, KV split
    and ZeRO-3 gathers), and whether dp splits the batch's rows (else
    every data rank decodes all of them)."""
    low: Any
    sizes: Dict[str, int]
    coords: Dict[str, int]
    specs: Dict[str, Any]
    meta: Dict[str, Any]
    ec: ExecConfig
    rows_split: bool

    def local_shape(self, path, shape) -> Tuple[int, ...]:
        """This rank's shape of the cache leaf at ``path``."""
        return local_shape(shape, tree_get(self.specs, path), self.sizes)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor of the global batch (dim 0)."""
        if not self.rows_split:
            return x
        n = x.shape[0] // self.sizes["data"]
        return x[self.coords["data"] * n:(self.coords["data"] + 1) * n]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' rows, in order, on every rank."""
        if not self.rows_split:
            return x
        return all_gather_dim(x.contiguous(), 0, self.ec.par.dp_group)

    def place(self, caches: Dict) -> Dict:
        """A cache tree of this rank (its rows and kv heads, the whole
        sequence, as prefill and ``pad_caches`` leave it) cut to what the
        specs give the rank: every dim a spec splits that the leaf still
        holds whole (the KV sequence where a group splits it)."""
        def cut(path, x):
            spec = tree_get(self.specs, path)
            whole = tree_get(self.meta, path).shape
            for d, e in enumerate(spec):
                if e is not None and x.shape[d] == whole[d]:
                    n = whole[d] // self.sizes[e]
                    x = x.narrow(d, self.coords[e] * n, n)
            return x.contiguous()

        def walk(tree, path):
            return {k: walk(v, path + (k,)) if isinstance(v, dict)
                    else cut(path + (k,), v) for k, v in tree.items()}

        return walk(caches, ())


def serve_rank(model: Model, plan: Plan, mesh, batch: int, max_len: int
               ) -> ServeRank:
    """This rank's ``ServeRank`` on the live mesh for caches of ``batch``
    rows and ``max_len`` positions.  The cache specs locate each leaf's
    batch dim by the layout's probe, not by value as the reference's do
    (``sharding.cache_specs``' ``batch_dims``): where the batch equals the
    layer count, the reference splits the stacked layer dim and every
    ``pos`` leaf; the rank splits the rows instead (the same bytes of k
    and v) and holds ``pos`` whole (docs/port.md).  Raises where the port
    cannot run the plan: the hybrid at dp · tp > 1, and tp that does not
    split the products tensor parallelism splits (``rank_plan``)."""
    from repro_torch.lowering.cache_layout import derive_cache_layout
    from repro_torch.models.zoo import build_model
    cfg = model.cfg
    rp = rank_plan(model, plan, mesh)
    low, par = rp.low, rp.par
    world = par.dp * par.tp
    if cfg.family == "hybrid" and world > 1:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid serves on one device; its multi-device "
            "serving (the Mamba2 mixer's conv window and gated norm split "
            "over tp) is not ported (ROADMAP.md, queue A: serving)")
    kv = plan.kv_cache_dtype
    cdt = torch.int8 if kv == "int8" else torch.bfloat16
    meta = build_model(cfg, "meta").init_caches(batch, max_len, cdt)
    layout = derive_cache_layout(cfg, batch, max_len, kv)
    paths = tree_paths(meta)        # in the layout's leaf order
    bdims = {path: leaf.pbdim
             for path, leaf in zip(paths, layout.leaves, strict=True)}
    specs, _ = low.cache_specs(meta, batch, batch_dims=bdims)
    sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    split = None
    for path, leaf in zip(paths, layout.leaves):
        spec = tree_get(specs, path)
        if leaf.key == "k" and spec[leaf.pbdim + 1] is not None:
            ax = spec[leaf.pbdim + 1]
            split = KVSplit(ax, mesh.get_group(ax), sizes[ax], coords[ax])
    # only a rank holding part of the positions needs the owner-only
    # write; where every rank holds them all, the plain slice write does
    # (the reference takes "onehot" wherever ``model`` names any dim of a
    # KV leaf, heads included, and leaves a split over data to GSPMD)
    mode = "onehot" if split is not None else "dus"
    rows_split = sizes["data"] > 1 and batch % sizes["data"] == 0
    # serving runs no sequence parallelism; where the rows are not split,
    # every data rank decodes all of them, as one data rank of one would
    spar = Parallel(par.dp_group, par.tp_group,
                    par.dp if rows_split else 1, par.tp,
                    par.dp_rank if rows_split else 0, par.tp_rank, sp=False)
    gather = {n: sp.index("data") for n, sp in rp.pspecs.items()
              if "data" in sp}
    ec = serve_exec_cfg(
        plan, world, par=spar, cache_update=mode, kv_split=split,
        zero3=WeightGather(gather, par.dp_group) if gather else None)

    return ServeRank(low, sizes, coords, specs, meta, ec, rows_split)


@dataclass
class ServeStep:
    """A serving step: ``fn``, its ``ExecConfig`` and, with a mesh, this
    rank's ``ServeRank`` (None on one device)."""
    fn: Callable
    exec_cfg: ExecConfig
    rank: Optional[ServeRank] = None

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rank is None else self.rank.gather_rows(x)

    def place(self, caches: Dict) -> Dict:
        return caches if self.rank is None else self.rank.place(caches)


def make_prefill_step(model: Model, plan: Plan, return_cache: bool = False,
                      kernel_impl: str = "kernel", mesh=None,
                      batch: Optional[int] = None) -> ServeStep:
    """``fn(params, batch)`` -> last-position logits (+ stacked caches).
    ``kernel_impl="plain"`` is the test hook of ``ExecConfig.kernel_impl``.
    ``mesh``: this rank of the plan's ``(data, model)`` mesh, for a global
    batch of ``batch`` rows: ``fn`` takes the global batch and returns
    the logits (whole vocabulary) and caches of this rank's rows, the
    caches holding its kv heads over the whole prompt (``ServeStep.place``
    cuts a split sequence after ``pad_caches``)."""
    if mesh is None:
        ec = serve_exec_cfg(plan).replace(kernel_impl=kernel_impl)
        sr = None
    else:
        if batch is None:
            raise ValueError("a prefill step on a mesh needs its batch size")
        sr = serve_rank(model, plan, mesh, batch, 1)
        ec = sr.ec.replace(kernel_impl=kernel_impl)

    @torch.inference_mode()
    def prefill(params, batch):
        if sr is not None:
            batch = {k: sr.rows(v) for k, v in batch.items()}
        return model.prefill_fn(params, batch, ec, return_cache)

    return ServeStep(fn=prefill, exec_cfg=ec, rank=sr)


def make_serve_step(model: Model, plan: Plan, batch: int = 1,
                    max_len: int = 1, kernel_impl: str = "kernel", mesh=None
                    ) -> ServeStep:
    """``fn(params, tokens, caches)`` -> (logits, caches): one-token decode
    against caches of length ``max_len`` (written in place), bf16 or, under
    ``plan.kv_cache_dtype="int8"``, int8 codes with their scales
    (``zoo.quantize_caches`` of the prefill's).  ``mesh``: this rank of the
    plan's mesh for a global batch of ``batch``; ``fn`` takes this rank's
    tokens (those of its prefill's rows) and caches (``ServeStep.place``)
    and returns its rows' logits, whole over the vocabulary."""
    if mesh is None:
        ec = serve_exec_cfg(plan).replace(cache_update="dus",
                                          kernel_impl=kernel_impl)
        sr, want = None, (batch, max_len)
    else:
        sr = serve_rank(model, plan, mesh, batch, max_len)
        ec = sr.ec.replace(kernel_impl=kernel_impl)
        path = ("attn", "k") if "attn" in sr.meta else ("k",)
        want = sr.local_shape(path, tree_get(sr.meta, path).shape)[1:3]

    @torch.inference_mode()
    def serve(params, tokens, caches):
        # the attention cache: the dense layout's own, or the hybrid's
        k = caches["attn"]["k"] if "attn" in caches else caches["k"]
        if tuple(k.shape[1:3]) != tuple(want):
            raise ValueError(f"caches {tuple(k.shape)} for batch {batch}, "
                             f"max_len {max_len}")
        return model.decode_fn(params, tokens, caches, ec)

    return ServeStep(fn=serve, exec_cfg=ec, rank=sr)


@dataclass
class PagedServeStep:
    """``fn(params, tokens, state, block_table)`` -> (logits, state), and
    its parts: ``gather(state, block_table)`` -> the dense cache tree,
    ``decode(params, tokens, dense)`` -> (logits, dense'), and
    ``scatter(state, dense', block_table, pos)`` -> state, where ``pos``
    is the ``(slots,)`` position vector the step read before decoding
    (``positions(state)``)."""
    fn: Callable
    exec_cfg: ExecConfig
    gather: Callable
    decode: Callable
    scatter: Callable
    positions: Callable
    rank: Optional[ServeRank] = None


def make_paged_serve_step(model: Model, plan: Plan, *, slots: int,
                          max_len: int, page_size: int, mesh=None
                          ) -> PagedServeStep:
    """One-token decode for the continuous-batching engine (the reference's
    ``make_paged_serve_step``): every paged leaf (``serving/pages.py``) is a
    pool ``(lead, slots·npp + 1, page_size, *tail)`` whose last page is the
    shared trash page, gathered through the ``(slots, npp)`` block table
    into the dense ``(lead, slots, max_len, *tail)`` view, decoded with the
    per-request positions, and the row each slot wrote scattered back.

    Token identity with the contiguous path holds by construction: the
    gathered rows below a slot's position are the pages the contiguous
    cache would hold, the rows at or past it are masked to the zeros a
    fresh cache holds (recycled pages and the trash page never leak), so
    the tree that enters ``decode_fn`` is bitwise the contiguous cache, and
    each decode row is computed apart from the others.  The decode writes
    its rows into the gathered view, never into a pool.  Inactive slots
    (pos 0, a block-table row all trash) write to the trash page.
    Non-paged leaves (the Mamba2 conv window and SSM state, ``pos``) pass
    through whole, the former written in place by the decode.

    ``mesh``: this rank of a plan at dp = 1 whose cache tp splits on the
    kv heads or not at all: every tp rank runs the same schedule and
    block table over pools of its kv heads.  dp > 1, or a layout that
    splits the KV sequence, raises: a page would hold positions of several
    ranks (ROADMAP.md, queue A: serving)."""
    from repro_torch.serving.pages import (classify_cache_tree, map_leaves,
                                           tree_get)
    if max_len % page_size:
        raise ValueError(f"page_size {page_size} must divide max_len "
                         f"{max_len}")
    npp = max_len // page_size
    sr = None
    if mesh is None:
        ec = serve_exec_cfg(plan)
    else:
        sr = serve_rank(model, plan, mesh, slots, max_len)
        if sr.ec.kv_split is not None:
            raise NotImplementedError(
                "the continuous-batching engine on a cache whose KV "
                f"sequence is split over {sr.ec.kv_split.axis!r}: a page "
                "would hold positions of several ranks (ROADMAP.md, queue "
                "A: serving)")
        if sr.sizes["data"] > 1:
            raise NotImplementedError(
                f"the continuous-batching engine at dp {sr.sizes['data']}: "
                "the port's engine serves at dp = 1 (one schedule for every "
                "rank; ROADMAP.md, queue A: serving)")
        ec = sr.ec
    specs = classify_cache_tree(model.cfg, slots, max_len,
                                plan.kv_cache_dtype)
    pos_spec = next(sp for sp in specs if sp.is_pos)

    def positions(state):
        # every pos leaf holds the one per-request vector (an engine
        # invariant): read it off the first
        return tree_get(state, pos_spec.path).reshape(-1, slots)[0]

    def _gather(pool, block_table, pos):
        lead, tail = pool.shape[0], pool.shape[3:]
        g = pool[:, block_table.long()].view((lead, slots, max_len) + tail)
        # rows at or past each request's position read as the zeros of a
        # fresh contiguous cache
        past = torch.arange(max_len, device=pool.device) >= pos[:, None]
        return g.masked_fill_(past.view((1, slots, max_len)
                                        + (1,) * len(tail)), 0)

    def _scatter(pool, dense, block_table, pos):
        # the decode wrote row pos[b] of slot b: copy it into its page
        # (inactive slots land on the trash page through their all-trash
        # block-table row; the clamps keep an overflowing row in range)
        lead, tail = pool.shape[0], pool.shape[3:]
        ar = torch.arange(slots, device=pool.device)
        row = pos.long().clamp(0, max_len - 1)
        page = torch.clamp_max(row // page_size, npp - 1)
        tgt = block_table[ar, page].long() * page_size + row % page_size
        flat = pool.view((lead, pool.shape[1] * page_size) + tail)
        flat[:, tgt] = dense[:, ar, row]
        return pool

    @torch.inference_mode()
    def gather(state, block_table):
        pos = positions(state)
        return map_leaves(state, specs, lambda sp, x: _gather(
            x, block_table, pos) if sp.paged else x)

    @torch.inference_mode()
    def decode(params, tokens, dense):
        return model.decode_fn(params, tokens, dense, ec)

    @torch.inference_mode()
    def scatter(state, dense, block_table, pos):
        return map_leaves(dense, specs, lambda sp, x: _scatter(
            tree_get(state, sp.path), x, block_table, pos)
            if sp.paged else x)

    def step(params, tokens, state, block_table):
        pos = positions(state)
        logits, dense = decode(params, tokens, gather(state, block_table))
        return logits, scatter(state, dense, block_table, pos)

    return PagedServeStep(fn=step, exec_cfg=ec, gather=gather, decode=decode,
                          scatter=scatter, positions=positions, rank=sr)

