"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing from the port."""
import ast
import subprocess
import sys

from ._small import ROOT

REFERENCE = ROOT / "portbench" / "reference"


def test_a_cells_import_path_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import harness, calibrate\n"
        "from portbench.tests._small import small_plan\n"
        "plan = small_plan('tg8k_ns_long')\n"
        "r = harness.run_cell(plan, 9, 0.1, False, 'cpu', time.perf_counter())\n"
        "assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "noisereduce_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "noisereduce_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"torch", "contextlib", "__future__"}, (path, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.torchgate\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "noisereduce_tpu_torch" not in out.stdout


def test_forbidden_names_are_compared_whole():
    from portbench import harness

    sys.modules.setdefault("noisereduce_tpu_torch_lookalike", sys)
    assert "noisereduce_tpu_torch_lookalike" not in harness.forbidden_modules()
    assert "noisereduce_tpu_torch" not in harness.FORBIDDEN
