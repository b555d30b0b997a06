"""What the benchmark runs imports no JAX: no module whose top-level name,
compared whole, is jax, jaxlib, flax or vqcpcb_tpu (vqcpcb_tpu_torch is the
program); the reference imports nothing of the program or its scripts; a
run without a card exits non-zero and prints no result."""
import ast
import subprocess
import sys

from portbench.harness import env, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "vqcpcb_tpu"}
PROGRAM = {"vqcpcb_tpu_torch", "chip_smoke", "torch_mesh_harness"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".", 1)[0])
    return roots


def test_no_file_imports_jax_or_the_jax_package():
    for path in registry.BENCH.rglob("*.py"):
        assert not imported_roots(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (registry.BENCH / "reference").rglob("*.py"):
        assert not imported_roots(path) & PROGRAM, path


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "vqcpcb_tpu_torch_lookalike", sys)
    assert env.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "vqcpcb_tpu.ops", sys)
    assert env.forbidden_loaded() == ["vqcpcb_tpu"]


def test_a_run_loads_no_jax_module():
    """A tiny cell run in a fresh interpreter, then sys.modules."""
    code = ("import sys; from portbench import run; from portbench.tests import tiny; "
            "from portbench.harness import env; "
            "run.main(['--workload', 'encoder-train', '--seed', '7', '--seconds', "
            "'0.2', '--trace', '0'], device='cpu', cell=tiny.cell('encoder-train')); "
            "print('LOADED', env.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "flagship-train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
