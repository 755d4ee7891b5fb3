"""The port's abstract lowering and memory report against the reference's,
on the CPU.

Everything here is bitwise: the lowering is host arithmetic over the
shared state and cache layouts, and the port copies the reference's
arithmetic in the same order.  For granite-3-8b and zamba2-2.7b at their
published widths:

- train plans at dp x tp of 1 x 1, 8 x 1 (the tp = 1 fold, also onto a
  4 x 2 mesh) and 4 x 2, ZeRO 0-3, non-zero WO/OO/AO, and two pipeline
  stages: ``memory_report().to_dict()`` and ``memory_consistency`` equal
  the reference's;
- serve plans at decode (contiguous and paged caches) and prefill: the
  report equals the reference's, and at decode ``estimate_serve_plan``
  equals the lowered peak;
- the mesh checks raise where the reference's raise; the execution guard
  still runs one stage at dp = tp = 1 only;
- ``train --tune`` (also with ``--space serve``) and ``serve --tune``
  print the memory lines with the reference's numbers.

The reference gets the port's H100 as one of its hardware specs.
"""
import dataclasses
import json

import pytest

from repro import compat
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_arch as jax_get_arch
from repro.core.costmodel import estimate_serve_plan as jax_estimate_serve
from repro.core.hardware import HardwareSpec as JHardwareSpec
from repro.core.plan import Plan as JPlan
from repro.lowering import MEMORY_REL_TOL as JAX_MEMORY_REL_TOL
from repro.lowering import cache_layout as JCL
from repro.lowering import lower_plan as jax_lower_plan
from repro.lowering import memory_consistency as jax_memory_consistency
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.core.costmodel import estimate_serve_plan
from repro_torch.core.hardware import H100
from repro_torch.core.plan import Plan, StageConfig, single_stage_plan
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.lowering import (MEMORY_REL_TOL, check_plan_mesh,
                                  check_serve_plan, check_train_plan,
                                  lower_plan, memory_consistency, plan_mesh,
                                  train_exec_cfg)
from repro_torch.parallel.sharding import abstract_mesh
from test_torch_tuner import ref_cache_layout

ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b", "zamba2-2.7b")
# the port's H100, as a reference spec, less the one field the reference
# lacks (devices_per_host: the plans held here fit one host, where it
# changes no price)
H100_AS_REF = JHardwareSpec(**{
    k: v for k, v in dataclasses.asdict(H100).items()
    if k != "devices_per_host"})
TRAIN = ("t", 4096, 32, "train")


def _stage(L, **kw):
    base = dict(layers=L, micro_batch=1, dp=1, tp=1, zero=1, ckpt_layers=0)
    base.update(kw)
    return StageConfig(**base)


def _train_plans(L):
    """(name, plan, mesh shape or None for the plan's own) per case."""
    half = L // 2
    return [
        ("1x1_z0", single_stage_plan(L, dp=1, tp=1, micro_batch=2,
                                     grad_accum=2, zero=0, ckpt_layers=0),
         None),
        ("8x1_fold_z1", single_stage_plan(L, dp=8, tp=1, micro_batch=1,
                                          grad_accum=4, zero=1,
                                          ckpt_layers=half), None),
        ("8x1_fold_on_4x2_z2", single_stage_plan(
            L, dp=8, tp=1, micro_batch=1, grad_accum=4, zero=2,
            ckpt_layers=L), (4, 2)),
        ("4x2_z3", single_stage_plan(L, dp=4, tp=2, micro_batch=2,
                                     grad_accum=2, zero=3, ckpt_layers=3),
         None),
        ("4x2_offload", single_stage_plan(
            L, dp=4, tp=2, micro_batch=1, grad_accum=4, zero=1,
            ckpt_layers=half, wo=0.25, oo=0.5, ao=0.5), None),
        ("1x1_offload_z2", single_stage_plan(
            L, dp=1, tp=1, micro_batch=1, grad_accum=8, zero=2,
            ckpt_layers=L, wo=0.5, oo=1.0, ao=1.0, go=0.0), None),
        ("S2_2x2", Plan(grad_accum=4, stages=(
            _stage(half, dp=2, tp=2, zero=1, ckpt_layers=half, ao=0.5),
            _stage(L - half, dp=2, tp=2, zero=1, ckpt_layers=2, oo=0.5))),
         None),
    ]


def _jax_mesh(plan, shape):
    st0 = plan.stages[0]
    if shape is not None:
        return compat.abstract_mesh(shape, ("data", "model"))
    if plan.num_stages > 1:
        return compat.abstract_mesh((plan.num_stages, st0.dp, st0.tp),
                                    ("stage", "data", "model"))
    return compat.abstract_mesh((st0.dp, st0.tp), ("data", "model"))


def _torch_mesh(plan, shape):
    if shape is not None:
        return abstract_mesh(shape, ("data", "model"))
    return plan_mesh(plan)


def test_memory_rel_tol_equals_the_reference():
    assert MEMORY_REL_TOL == JAX_MEMORY_REL_TOL


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_memory_report_matches_the_reference(arch, case):
    cfg = get_arch(arch)
    name, plan, mesh_shape = _train_plans(cfg.num_layers)[case]
    jplan = JPlan.from_json(plan.to_json())
    got = lower_plan(cfg, ShapeConfig(*TRAIN), plan,
                     _torch_mesh(plan, mesh_shape)).memory_report()
    want = jax_lower_plan(jax_get_arch(arch), JShapeConfig(*TRAIN), jplan,
                          _jax_mesh(jplan, mesh_shape)).memory_report(
                              hw=H100_AS_REF)
    assert got.to_dict() == want.to_dict(), name
    if mesh_shape is None:
        mc = memory_consistency(cfg, ShapeConfig(*TRAIN), plan)
        assert mc == jax_memory_consistency(
            jax_get_arch(arch), JShapeConfig(*TRAIN), jplan, hw=H100_AS_REF)
        assert mc["predicted_bytes"] == mc["lowered_bytes"]


_SERVE = [
    ("decode_1x1", dict(dp=1, tp=1), "decode", 0, "bf16"),
    ("decode_2x4", dict(dp=2, tp=4), "decode", 0, "bf16"),
    ("decode_paged_1x1", dict(dp=1, tp=1), "decode", 16, "bf16"),
    ("decode_paged_int8_2x2", dict(dp=2, tp=2), "decode", 64, "int8"),
    ("prefill_1x1", dict(dp=1, tp=1), "prefill", 0, "bf16"),
    ("prefill_4x2", dict(dp=4, tp=2), "prefill", 0, "bf16"),
]


@pytest.mark.parametrize("case", _SERVE, ids=[c[0] for c in _SERVE])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_memory_report_matches_the_reference(arch, case, monkeypatch):
    """Bitwise, with the reference's cache layout as the port derives it
    (under int8 the hybrid's conv window stays bf16:
    ``test_torch_tuner.ref_cache_layout``)."""
    _, par, kind, page, kv = case
    derive = JCL.derive_cache_layout
    monkeypatch.setattr(JCL, "derive_cache_layout",
                        lambda *a: ref_cache_layout(*a, derive=derive))
    cfg = get_arch(arch)
    plan = single_stage_plan(cfg.num_layers, micro_batch=1, grad_accum=1,
                             zero=0, ckpt_layers=0, page_size=page,
                             kv_cache_dtype=kv, **par)
    jplan = JPlan.from_json(plan.to_json())
    shape = ("s", 4096, 8, kind)
    got = lower_plan(cfg, ShapeConfig(*shape), plan,
                     plan_mesh(plan)).memory_report()
    want = jax_lower_plan(jax_get_arch(arch), JShapeConfig(*shape), jplan,
                          _jax_mesh(jplan, None)).memory_report(
                              hw=H100_AS_REF)
    assert got.to_dict() == want.to_dict()
    assert got.kind == kind
    if kind == "decode":
        est = estimate_serve_plan(cfg, ShapeConfig(*shape), plan)
        assert est["mem_decode"] == got.peak_bytes == jax_estimate_serve(
            jax_get_arch(arch), JShapeConfig(*shape), jplan,
            hw=H100_AS_REF)["mem_decode"]


def test_memory_report_needs_the_shape():
    plan = single_stage_plan(4, dp=1, tp=1, micro_batch=1, grad_accum=1)
    low = lower_plan(get_arch("granite-3-8b").reduced(), None, plan,
                     plan_mesh(plan))
    with pytest.raises(ValueError, match="shape"):
        low.memory_report()


def test_offload_moves_state_and_activations_to_the_host():
    cfg = get_arch("granite-3-8b")
    shape = ShapeConfig(*TRAIN)
    base = single_stage_plan(40, dp=1, tp=8, micro_batch=1, grad_accum=4,
                             zero=1, ckpt_layers=20)
    off = single_stage_plan(40, dp=1, tp=8, micro_batch=1, grad_accum=4,
                            zero=1, ckpt_layers=20, wo=0.5, oo=0.5, ao=1.0)
    r0 = lower_plan(cfg, shape, base, plan_mesh(base)).memory_report()
    r1 = lower_plan(cfg, shape, off, plan_mesh(off)).memory_report()
    s0, s1 = r0.stages[0], r1.stages[0]
    assert s0.host_state_bytes == 0 < s1.host_state_bytes
    assert s0.host_act_bytes == 0 < s1.host_act_bytes
    assert r1.peak_bytes < r0.peak_bytes
    low = lower_plan(cfg, shape, off, plan_mesh(off))
    assert low.state_layout_terms(0)["host"] == s1.host_state_bytes


@pytest.mark.parametrize("plan_kw,mesh,match", [
    (dict(dp=2, tp=4), ((2, 2), ("data", "model")), "plan/mesh mismatch"),
    (dict(dp=4, tp=2), ((2, 4), ("data", "model")), "plan/mesh mismatch"),
    (dict(dp=2, tp=2), ((2, 2, 2), ("stage", "data", "model")), "stage"),
])
def test_mesh_check_rejects_what_the_reference_rejects(plan_kw, mesh, match):
    plan = single_stage_plan(8, micro_batch=1, grad_accum=1, **plan_kw)
    with pytest.raises(ValueError, match=match):
        check_plan_mesh(plan, abstract_mesh(*mesh))
    with pytest.raises(ValueError, match=match):
        compat_plan = JPlan.from_json(plan.to_json())
        jax_lower_plan(jax_get_arch("granite-3-8b").reduced(), None,
                       compat_plan, compat.abstract_mesh(*mesh))


def test_pipeline_mesh_needs_a_stage_axis_of_its_size():
    plan = Plan(grad_accum=2, stages=(_stage(2, dp=2), _stage(2, dp=2)))
    for mesh in (abstract_mesh((2, 2), ("data", "model")),
                 abstract_mesh((4, 2, 1), ("stage", "data", "model"))):
        with pytest.raises(ValueError, match="stage"):
            check_plan_mesh(plan, mesh)
    low = lower_plan(get_arch("granite-3-8b").reduced(), None, plan,
                     plan_mesh(plan))
    assert [(s.has_embed, s.has_head, s.inflight) for s in low.stages] == \
        [(True, False, 2), (False, True, 1)]


def test_abstract_lowering_is_not_an_execution_guard():
    """Lowering reaches any mesh; training executes a plan on exactly
    S · dp · tp ranks (a pipelined one through parallel/pipeline.py),
    serving one stage on exactly dp · tp ranks."""
    plan = single_stage_plan(4, dp=4, tp=2, micro_batch=1, grad_accum=1)
    low = lower_plan(get_arch("granite-3-8b").reduced(), None, plan,
                     plan_mesh(plan))
    assert low.serve_exec_cfg.ckpt_layers == 0
    assert low.plan_exec_cfg.attn_impl == plan.attn_impl
    check_train_plan(plan, 8)
    for world in (1, 4):
        with pytest.raises(ValueError, match="world has"):
            check_train_plan(plan, world)
    check_serve_plan(plan, 8)
    with pytest.raises(ValueError, match="world has 1"):
        check_serve_plan(plan)
    piped = Plan(grad_accum=1, stages=(_stage(2), _stage(2)))
    check_train_plan(piped, 2)
    with pytest.raises(ValueError, match="S · dp · tp"):
        check_train_plan(piped, 1)
    with pytest.raises(ValueError, match="pipeline"):
        train_exec_cfg(piped, 2)


def _json_after(out: str) -> str:
    return out[out.index("{"):out.rindex("}") + 1]


def test_train_tune_prints_the_reference_memory_line(capsys):
    argv = ["--arch", "granite-3-8b", "--tune", "--layers", "8",
            "--global-batch", "2", "--devices", "1", "--device", "cpu"]
    assert train_launch.main(argv) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("# memory:")]
    jplan = JPlan.from_json(_json_after(out))
    mc = jax_memory_consistency(
        jax_get_arch("granite-3-8b").replace(num_layers=8),
        JShapeConfig("cli", 4096, 2, "train"), jplan, hw=H100_AS_REF)
    assert line == [
        f"# memory: predicted {mc['predicted_bytes'] / 2**30:.2f} GiB "
        f"lowered {mc['lowered_bytes'] / 2**30:.2f} GiB "
        f"(rel err {mc['rel_error']:.3f}, within_tol={mc['within_tol']})"]
    assert mc["rel_error"] == 0.0


def test_serve_tune_prints_a_bitwise_serve_memory_line(capsys):
    argv = ["--arch", "granite-3-8b", "--smoke", "--tune", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--device", "cpu"]
    assert serve_launch.main(argv) == 0
    out = capsys.readouterr().out
    plan = JPlan.from_json(_json_after(out))
    est = jax_estimate_serve(jax_get_arch("granite-3-8b").reduced(),
                             JShapeConfig("cli", 11, 2, "decode"), plan,
                             hw=H100_AS_REF)["mem_decode"]
    line = [ln for ln in out.splitlines() if ln.startswith("# serve memory")]
    assert line == [f"# serve memory: predicted {est / 2**30:.2f} GiB "
                    f"lowered {est / 2**30:.2f} GiB (bitwise=True)"]
    assert json.loads(_json_after(out))["stages"][0]["dp"] == 1


def test_serve_tune_refuses_a_memory_mismatch(monkeypatch, capsys):
    """As the reference's launcher asserts: a tuned serve plan whose
    predicted memory differs from its lowering is not served."""
    real = serve_launch.serve_memory
    monkeypatch.setattr(serve_launch, "serve_memory",
                        lambda *a: (real(*a)[0], real(*a)[1] + 1.0))
    argv = ["--arch", "granite-3-8b", "--smoke", "--tune", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="disagree"):
        serve_launch.main(argv)
    out = capsys.readouterr().out
    assert "(bitwise=False)" in out and "generated" not in out


def test_train_tune_serve_space_prints_the_serve_memory_line(capsys):
    argv = ["--arch", "granite-3-8b", "--tune", "--layers", "8",
            "--global-batch", "2", "--devices", "1", "--space", "serve",
            "--device", "cpu"]
    assert train_launch.main(argv) == 0
    out = capsys.readouterr().out
    jplan = JPlan.from_json(_json_after(out))
    est = jax_estimate_serve(
        jax_get_arch("granite-3-8b").replace(num_layers=8),
        JShapeConfig("cli", 4096, 2, "decode"), jplan,
        hw=H100_AS_REF)["mem_decode"]
    line = [ln for ln in out.splitlines() if ln.startswith("# serve memory")]
    assert line == [f"# serve memory: predicted {est / 2**30:.2f} GiB "
                    f"lowered {est / 2**30:.2f} GiB (bitwise=True)"]
