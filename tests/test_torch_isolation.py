"""The port imports no JAX: every vqcpcb_tpu_torch module, chip_smoke.py
and torch_mesh_harness.py stay free of jax, flax and the JAX package.
Checked in a fresh interpreter, because this test process already imports
jax (tests/conftest.py). And the
port imports nothing but the stdlib, itself, torch, numpy, scipy and
einops, the packages of the machine with the card: no click, orbax,
matplotlib or music21."""
import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "vqcpcb_tpu")
ALLOWED = frozenset(sys.stdlib_module_names) | {
    "vqcpcb_tpu_torch", "torch", "numpy", "scipy", "einops",
    "chip_smoke",             # the port's own smoke script, in the checkout
    "torch_mesh_harness"}     # its and the tests' mesh harness, held below too


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


def _port_files():
    return [REPO / "chip_smoke.py", REPO / "torch_mesh_harness.py",
            *(REPO / "vqcpcb_tpu_torch").rglob("*.py")]


def test_port_sources_and_chip_smoke_import_no_jax():
    for path in _port_files():
        roots = set(_imported_roots(ast.parse(path.read_text())))
        assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_port_sources_and_chip_smoke_import_only_allowed_roots():
    """Every import, at module level or inside a function, has an allowed
    root; so the CLIs cannot come to need a package the card's machine
    lacks."""
    for path in _port_files():
        roots = set(_imported_roots(ast.parse(path.read_text())))
        assert roots <= ALLOWED, (path, sorted(roots - ALLOWED))
    for bad in ("click", "orbax", "matplotlib", "music21", "jax",
                "vqcpcb_tpu", "optax"):
        assert bad not in ALLOWED
