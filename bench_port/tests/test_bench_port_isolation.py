"""The benchmark imports neither JAX nor the JAX package ``repro``, and its
reference imports nothing of the program. Module names are compared by
their whole top-level name (the part before the first dot): ``repro_torch``
begins with ``repro`` and is the program, not the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imported_top_names(f) & JAX_NAMES
        assert not bad, f"{f.relative_to(BENCH)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert {f.name for f in files} >= {"scan.py", "sfa.py", "prosite.py"}
    for f in files:
        names = imported_top_names(f)
        assert "repro_torch" not in names, f.name
        src = f.read_text()
        assert "bench_port.harness" not in src, f.name


def test_the_harness_loads_no_jax_module_when_imported():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import bench_port.run, bench_port.control, "
            "bench_port.harness.port as p, bench_port.drivers.scan, "
            "bench_port.drivers.compile; p.program(); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH.parent), str(BENCH.parent / "src"), JAX_NAMES))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names():
    sys.path.insert(0, str(BENCH.parent))
    from bench_port import run

    names = ["repro_torch", "repro_torch.obs", "reprox", "jaxtyping",
             "numpy", "jaxlib.xla", "repro.core", "flax"]
    assert run.forbidden_modules(names) == ["flax", "jaxlib.xla",
                                            "repro.core"]
