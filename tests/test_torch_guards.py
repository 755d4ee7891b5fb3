"""Guards around the PyTorch port: it imports nothing of JAX or of the
reference package, its entry points refuse to run on the CPU unless asked,
its kernel loader raises without a CUDA toolkit, and its build directory
is ignored by git."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.plan import single_stage_plan
from repro_torch.kernels import _build
from repro_torch.launch import serve, train
from repro_torch.lowering import check_serve_plan, check_train_plan
from repro_torch.models.zoo import Model, build_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _is_forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(m) for m in mods), \
            f"{path.name}:{node.lineno} imports {mods}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_model_needs_cuda_unless_asked_for_cpu(no_cuda):
    cfg = get_arch("granite-3-8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, "cuda")
    assert build_model(cfg, "cpu").device.type == "cpu"


def test_hybrid_build_model_and_main_need_cuda_unless_asked_for_cpu(
        no_cuda, capsys):
    cfg = get_arch("zamba2-2.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert build_model(cfg, "cpu").device.type == "cpu"
    argv = ["--arch", "zamba2-2.7b", "--smoke", "--batch", "1",
            "--prompt-len", "8", "--gen", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    assert "generated 2 tokens" in capsys.readouterr().out


def test_generate_needs_cuda_unless_the_model_is_on_the_cpu(no_cuda):
    cfg = get_arch("granite-3-8b").reduced()
    plan = single_stage_plan(cfg.num_layers, dp=1, tp=1, micro_batch=1,
                             grad_accum=1, zero=0, ckpt_layers=0)
    cpu = build_model(cfg, "cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    prompts = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(dataclasses.replace(cpu, device=torch.device("cuda")),
                       params, prompts, 2, plan)
    assert serve.generate(cpu, params, prompts, 2, plan).shape == (1, 2)


def test_main_needs_cuda_unless_asked_for_cpu(no_cuda, capsys):
    argv = ["--arch", "granite-3-8b", "--smoke", "--batch", "1",
            "--prompt-len", "4", "--gen", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    assert "generated 2 tokens" in capsys.readouterr().out


def test_train_main_needs_cuda_unless_asked_for_cpu(no_cuda, capsys):
    argv = ["--arch", "granite-3-8b", "--smoke", "--steps", "1",
            "--seq", "16", "--global-batch", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv)
    assert train.main(argv + ["--device", "cpu"]) == 0
    assert "trained 1 steps" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--continuous"])
def test_unported_serve_modes_exit(flag, capsys):
    """The serve mode that once exited as not ported now runs on the CPU:
    ``--continuous`` serves through the engine and prints its two checks,
    token identity with the static decode and the cache bytes bitwise."""
    assert serve.main(["--arch", "granite-3-8b", "--smoke", "--device",
                       "cpu", "--gen", "8", flag]) == 0
    out = capsys.readouterr().out
    assert "# continuous tokens == batch-1 static decode at max_len 40: " \
        "True" in out
    assert "(bitwise=True)" in out and "# paged cache bytes:" in out
    assert "decode steps, 2 slots, page_size 8" in out


def test_only_dense_single_device_plans(no_cuda):
    """Dense and MoE decoders build, other families and MLA refuse;
    training takes plans on exactly S · dp · tp ranks, serving
    single-stage plans on exactly dp · tp ranks; each refusal names
    ROADMAP.md."""
    cfg = get_arch("granite-3-8b").reduced()
    moe = build_model(get_arch("qwen2-moe-a2.7b").reduced(), "cpu")
    params, _ = moe.init(torch.Generator().manual_seed(0), torch.float32)
    assert "layers/moe/router" in params and "layers/attn/bq" in params
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg.replace(family="audio"), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg.replace(attention_type="mla"), "cpu").init(
            torch.Generator())
    for dp, tp in ((1, 1), (2, 1), (1, 2), (2, 4)):
        plan = single_stage_plan(4, dp=dp, tp=tp, micro_batch=1,
                                 grad_accum=1)
        check_train_plan(plan, dp * tp)
        with pytest.raises(ValueError, match="ROADMAP"):
            check_train_plan(plan, dp * tp + 1)
        check_serve_plan(plan, dp * tp)
        if (dp, tp) != (1, 1):
            with pytest.raises(ValueError, match="ROADMAP"):
                check_serve_plan(plan)      # on one device
        with pytest.raises(ValueError, match="ROADMAP"):
            check_serve_plan(plan, dp * tp + 1)
    check_serve_plan(single_stage_plan(4, dp=1, tp=1, micro_batch=1,
                                       grad_accum=1))
    two = single_stage_plan(4, dp=1, tp=1, micro_batch=1, grad_accum=1)
    two = two.replace(stages=two.stages * 2)
    check_train_plan(two, 2)        # a pipeline of two stages of 4 layers
    for check in (lambda p: check_train_plan(p, 1),
                  lambda p: check_train_plan(p, 2, num_layers=4),
                  check_serve_plan):
        with pytest.raises(ValueError, match="ROADMAP"):
            check(two)
    assert isinstance(build_model(cfg, "cpu"), Model)


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").rglob("*.so"))


def test_gitignore_lists_the_build_directory():
    lines = {ln.strip() for ln in (ROOT / ".gitignore").read_text()
             .splitlines()}
    assert _build.BUILD_ROOT.parent == ROOT / "build"
    assert {"build/", "/build/"} & lines
