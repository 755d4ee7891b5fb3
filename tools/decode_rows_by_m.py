#!/usr/bin/env python
"""Which op of one decode step computes a row differently at batch M than
at batch 1, on the same row's inputs.

The continuous-batching engine decodes ``slots`` rows a step; its
comparator, the static decode, decodes one.  Its tokens are the static
decode's only while every op computes a row alike whatever the batch.
This script builds the model at its published widths and depth (random
weights from seed 0), fills an ``M``-row contiguous cache with random
values, takes row ``--row`` of it as a one-row cache, runs one decode
step on each under ``TorchDispatchMode`` and compares, op by op in
program order, the row's output at M with the one-row run's, bitwise.
It prints each op whose row differs (the first is the cause; the rest
follow from it) and whether the logits' row is the same, then whether
the RMSNorm kernel, and the Mamba2 gated norm's torch algebra, compute
each row of an M-row call as that row alone.

    python3 tools/decode_rows_by_m.py --arch zamba2-2.7b [--slots 4]

Needs a CUDA card (``--device cpu`` runs the reduced config on the CPU's
plain versions).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402


class _Record(TorchDispatchMode):
    """Every aten op's name, input shapes and a copy of each output whose
    first dim is the batch ``rows`` (the others -- weights, a layer's slice
    of a stacked weight -- are not copied: they hold no row)."""

    def __init__(self, rows):
        super().__init__()
        self.rows, self.ops = rows, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((str(func),
                         [tuple(a.shape) for a in args
                          if isinstance(a, torch.Tensor)],
                         [o.clone() if isinstance(o, torch.Tensor)
                          and o.dim() and o.shape[0] == self.rows else None
                          for o in outs]))
        return out


def _differing_ops(rec_m, rec_1, slots, row, limit):
    """(op index, name, input shapes, max |diff|) of each op whose row
    differs; ops that allocate without writing (``empty*``) are skipped."""
    found = []
    for i, ((f, shapes, outs_m), (g, _, outs_1)) in enumerate(
            zip(rec_m.ops, rec_1.ops)):
        if f != g:
            raise RuntimeError(f"the two runs' ops diverge at {i}: {f}, {g}")
        if "empty" in f:
            continue
        for a, b in zip(outs_m, outs_1):
            if a is None or b is None or a.shape[1:] != b.shape[1:]:
                continue
            if not torch.equal(a[row], b[0]):
                found.append((i, f, shapes, float(
                    (a[row].double() - b[0].double()).abs().max())))
                break
        if len(found) >= limit:
            break
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--row", type=int, default=1)
    ap.add_argument("--max-len", type=int, default=1056)
    ap.add_argument("--pos", type=int, default=300)
    ap.add_argument("--limit", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_arch
    from repro_torch.core.plan import single_stage_plan
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.models import ssm as SSM
    from repro_torch.models.zoo import build_model
    from repro_torch.serving.pages import classify_cache_tree, tree_get
    from repro_torch.training.step import make_serve_step

    dev = args.device
    cfg = get_arch(args.arch)
    if dev == "cpu":
        cfg = cfg.reduced()
    model = build_model(cfg, dev)
    params, _ = model.init(torch.Generator(dev).manual_seed(0))
    plan = single_stage_plan(cfg.num_layers, dp=1, tp=1, micro_batch=1,
                             grad_accum=1, zero=0, ckpt_layers=0,
                             attn_impl="pallas", use_pallas=True)
    m, row, gen = args.slots, args.row, torch.Generator(dev).manual_seed(1)
    with torch.inference_mode():
        caches_m = model.init_caches(m, args.max_len)
        caches_1 = model.init_caches(1, args.max_len)
        for sp in classify_cache_tree(cfg, m, args.max_len):
            big, one = tree_get(caches_m, sp.path), tree_get(caches_1,
                                                              sp.path)
            if sp.is_pos:
                big.fill_(args.pos)
                one.fill_(args.pos)
                continue
            big.copy_(torch.randn(big.shape, generator=gen, device=dev) / 2)
            one.copy_(big.select(sp.bdim, row).unsqueeze(sp.bdim))
        tok_m = torch.randint(0, cfg.vocab_size, (m, 1), generator=gen,
                              device=dev, dtype=torch.int32)
        tok_1 = tok_m[row:row + 1].clone()
        rec_m, rec_1 = _Record(m), _Record(1)
        with rec_m:
            logits_m, _ = make_serve_step(model, plan, batch=m,
                                          max_len=args.max_len).fn(
                params, tok_m, caches_m)
        with rec_1:
            logits_1, _ = make_serve_step(model, plan, batch=1,
                                          max_len=args.max_len).fn(
                params, tok_1, caches_1)
        found = _differing_ops(rec_m, rec_1, m, row, args.limit)
        rms, gated = {}, {}
        for d in sorted({cfg.d_model, 2 * cfg.d_model}):
            x = torch.randn(m, 1, d, generator=gen, device=dev).bfloat16()
            z = torch.randn(m, 1, d, generator=gen, device=dev).bfloat16()
            sc = torch.randn(d, generator=gen, device=dev).bfloat16()
            y = RN.rmsnorm(x, sc)
            rms[d] = all(torch.equal(y[r], RN.rmsnorm(x[r:r + 1], sc)[0])
                         for r in range(m))
            # the Mamba2 gated norm's torch algebra, which the decode left
            # for the kernel
            y = SSM._gated_norm(x, z, sc)
            gated[d] = all(torch.equal(y[r], SSM._gated_norm(
                x[r:r + 1], z[r:r + 1], sc)[0]) for r in range(m))
    card = "cpu" if dev == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"decode_rows_by_m": {
        "arch": args.arch, "slots": m, "row": row, "card": card,
        "ops": len(rec_m.ops),
        "logits_row_bitwise": torch.equal(logits_m[row], logits_1[0]),
        "logits_row_max_diff": float((logits_m[row].double()
                                      - logits_1[0].double()).abs().max()),
        "differing_ops": [{"op": i, "name": f, "inputs": sh, "max_diff": e}
                          for i, f, sh, e in found],
        "rmsnorm_rows_bitwise": rms, "gated_norm_rows_bitwise": gated}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
