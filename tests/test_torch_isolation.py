"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor any module of the reference package ``repro``."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"


def _port_modules() -> list:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        return ["repro_torch"] + [
            m.name for m in pkgutil.walk_packages([str(PACKAGE)],
                                                  prefix="repro_torch.")]
    finally:
        sys.path.remove(str(ROOT / "src"))


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert {"repro_torch.construction.batched", "repro_torch.engine.scanner",
            "repro_torch.kernels.ops", "repro_torch.interop",
            "repro_torch.construction.cache", "repro_torch.obs.tracing",
            "repro_torch.obs.aggregate", "repro_torch.speculative.executor",
            "repro_torch.scanservice.jobs",
            "repro_torch.scanservice.telemetry", "repro_torch.mesh",
            "repro_torch.core.sfa", "repro_torch.core.sfa_jax",
            "repro_torch.config", "repro_torch.sharding.rules",
            "repro_torch.serve.engine", "repro_torch.serve.steps",
            "repro_torch.launch.serve", "repro_torch.optim.api",
            "repro_torch.optim.schedule", "repro_torch.train.steps",
            "repro_torch.train.trainer", "repro_torch.checkpoint.manager",
            "repro_torch.data.pipeline", "repro_torch.data.protein",
            "repro_torch.launch.train"} <= set(mods)
    # the LM half: every model module and every architecture's config
    assert {f"repro_torch.models.{m}" for m in (
        "base", "layers", "attention", "moe", "ssm", "rglru", "transformer",
        "whisper", "model")} <= set(mods)
    assert {f"repro_torch.configs.{a}" for a in (
        "phi3_vision_4p2b", "mamba2_370m", "grok1_314b", "granite_moe_1b",
        "h2o_danube_1p8b", "qwen3_8b", "qwen1p5_0p5b", "yi_34b",
        "whisper_base", "recurrentgemma_9b", "paper_sfa")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr


def _imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_no_source_imports_jax_or_repro(where):
    files = (sorted(PACKAGE.rglob("*.py")) if where == "package"
             else [ROOT / "chip_smoke.py"])
    assert files
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f
        assert "from repro." not in text and "import repro\n" not in text, f
