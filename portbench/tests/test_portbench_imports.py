"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference imports nothing of the program."""
import ast
import glob
import json
import os
import subprocess
import sys

from portbench.run import FORBIDDEN

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_dry_run_loads_no_jax(tmp_path):
    """A dry run in a fresh interpreter, then every top-level module name
    it holds."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench.tests.tiny import tiny_copy\n"
        "from portbench import run\n"
        f"b, r = tiny_copy({str(tmp_path)!r})\n"
        "rc = run.main(['--workload', 'mtv_direct.level5', '--seed', '9',"
        " '--seconds', '0.2', '--trace', '1'], device='cpu', bench_path=b,"
        " root=r)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path),
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "videoloop3d_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names():
    from portbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["videoloop3d_tpu_like"] = sys
        assert run.loaded_forbidden() == [
            m for m in sorted(saved) if m.split(".")[0] in FORBIDDEN]
        sys.modules["videoloop3d_tpu.models"] = sys
        assert "videoloop3d_tpu.models" in run.loaded_forbidden()
    finally:
        sys.modules.pop("videoloop3d_tpu_like", None)
        sys.modules.pop("videoloop3d_tpu.models", None)


def test_no_benchmark_file_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not imported_tops(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tops = imported_tops(path)
        assert "videoloop3d_torch" not in tops, path
        assert tops <= {"__future__", "math", "types", "numpy", "torch"}, \
            (path, tops)
