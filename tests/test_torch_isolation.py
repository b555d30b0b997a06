"""The port imports no JAX: every vqcpcb_tpu_torch module, and chip_smoke.py,
stay free of jax, flax and the JAX package. Checked in a fresh interpreter,
because this test process already imports jax (tests/conftest.py)."""
import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "vqcpcb_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_modules_import_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "vqcpcb_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert len(modules) > 20


def test_port_sources_and_chip_smoke_import_no_jax():
    files = [REPO / "chip_smoke.py", *(REPO / "vqcpcb_tpu_torch").rglob("*.py")]
    for path in files:
        roots = set(_imported_roots(ast.parse(path.read_text())))
        assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))
