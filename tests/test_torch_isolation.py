"""The port imports no JAX: every vqcpcb_tpu_torch module, chip_smoke.py
and torch_mesh_harness.py stay free of jax, flax and the JAX package.
Checked in a fresh interpreter, because this test process already imports
jax (tests/conftest.py). And the
port imports nothing but the stdlib, itself, torch, numpy, scipy and
einops, the packages of the machine with the card: no click, orbax,
matplotlib, seaborn or music21, with two exceptions: the 'bach' dataset's
Music21BachCorpus (vqcpcb_tpu_torch/data/corpora.py) imports music21 lazily,
inside its own methods, as the JAX package's adapter does; and the two plots
of vqcpcb_tpu_torch/training/analysis.py (plot_attention,
scatterplot_clusters_3d) import matplotlib and seaborn inside themselves,
as the JAX package's do. So the CLIs cannot come to need a package the
card's machine lacks for any dataset but 'bach', which without music21
raises an ImportError naming it, as in JAX; a plot without its package
raises one naming it, and the encoder CLI's scatter says it was skipped."""
import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "vqcpcb_tpu")
ALLOWED = frozenset(sys.stdlib_module_names) | {
    "vqcpcb_tpu_torch", "torch", "numpy", "scipy", "einops",
    "torch_mesh_harness"}     # chip_smoke's and the tests' mesh harness, held below too
# the one place a port file may import music21: inside a method of this
# class of this file, never at module level
MUSIC21_FILE = REPO / "vqcpcb_tpu_torch" / "data" / "corpora.py"
MUSIC21_CLASS = "Music21BachCorpus"
# the one place a port file may import matplotlib or seaborn: inside these
# functions of this file, never at module level
PLOTS_FILE = REPO / "vqcpcb_tpu_torch" / "training" / "analysis.py"
PLOT_FUNCTIONS = ("plot_attention", "scatterplot_clusters_3d")
PLOT_PACKAGES = ("matplotlib", "seaborn")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _imports_with_scope(tree):
    """(root, the classes and functions that enclose the import, outermost
    first) for every import of a module."""
    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from visit(child, scope + [child])
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for root in _imported_roots(child):
                    yield root, scope
            else:
                yield from visit(child, scope)
    return visit(tree, [])


def _music21_allowed(path, scope) -> bool:
    return (path == MUSIC21_FILE and len(scope) >= 2
            and isinstance(scope[0], ast.ClassDef) and scope[0].name == MUSIC21_CLASS
            and isinstance(scope[1], (ast.FunctionDef, ast.AsyncFunctionDef)))


def _plots_allowed(path, root, scope) -> bool:
    return (root in PLOT_PACKAGES and path == PLOTS_FILE and len(scope) >= 1
            and isinstance(scope[0], (ast.FunctionDef, ast.AsyncFunctionDef))
            and scope[0].name in PLOT_FUNCTIONS)


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
    root, but music21 inside Music21BachCorpus's methods and matplotlib and
    seaborn inside the two plots; so the CLIs cannot come to need a package
    the card's machine lacks for any dataset but 'bach'."""
    for path in _port_files():
        tree = ast.parse(path.read_text())
        bad = sorted({root for root, scope in _imports_with_scope(tree)
                      if root not in ALLOWED
                      and not (root == "music21" and _music21_allowed(path, scope))
                      and not _plots_allowed(path, root, scope)})
        assert not bad, (path, bad)
    for bad in ("click", "orbax", "matplotlib", "seaborn", "music21", "jax",
                "vqcpcb_tpu", "optax"):
        assert bad not in ALLOWED


def test_music21_only_lazily_inside_the_bach_corpus():
    """music21 is imported by Music21BachCorpus's methods and by nothing
    else: not at module level, not in another class or function of
    corpora.py, not in any other port file, chip_smoke.py or
    torch_mesh_harness.py."""
    found = []
    for path in _port_files():
        for root, scope in _imports_with_scope(ast.parse(path.read_text())):
            if root == "music21":
                assert _music21_allowed(path, scope), (
                    path, [getattr(n, "name", "?") for n in scope])
                found.append(scope[1].name)
    assert found, "Music21BachCorpus imports no music21"


@pytest.mark.parametrize("package,functions", [
    ("matplotlib", set(PLOT_FUNCTIONS)), ("seaborn", {"plot_attention"})])
def test_plotting_packages_only_lazily_inside_the_plots(package, functions):
    """matplotlib is imported by plot_attention and scatterplot_clusters_3d,
    seaborn by plot_attention, and neither by anything else: not at module
    level, not in another function of analysis.py, not in any other port
    file, chip_smoke.py or torch_mesh_harness.py."""
    found = set()
    for path in _port_files():
        for root, scope in _imports_with_scope(ast.parse(path.read_text())):
            if root == package:
                assert _plots_allowed(path, root, scope), (
                    path, [getattr(n, "name", "?") for n in scope])
                found.add(scope[0].name)
    assert found == functions


def test_importing_the_port_and_its_cli_parsers_leaves_music21_out():
    """In a fresh interpreter, importing every port module, chip_smoke and
    torch_mesh_harness and building each CLI's argument parser leaves
    music21, matplotlib and seaborn out of sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "vqcpcb_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke', 'torch_mesh_harness']:\n"
        "    importlib.import_module(m)\n"
        "from vqcpcb_tpu_torch import (main_decoder, main_encoder, main_prior,\n"
        "                              migrate_reference_checkpoint)\n"
        "for cli in (main_encoder, main_decoder, main_prior):\n"
        "    cli.parse_args(['-t', '-c', 'config.py'])\n"
        "migrate_reference_checkpoint.parse_args(['ref'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('music21', 'matplotlib', 'seaborn'))\n"
        "assert not bad, bad\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
