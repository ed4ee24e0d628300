"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names (``mythril_tpu_torch`` is the port;
``mythril_tpu`` is the JAX package)."""

import ast
import json
import os
import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "mythril_tpu"}


def test_no_source_imports_a_forbidden_module():
    for dirpath, _dirs, files in os.walk(run.HERE):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, fn)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (fn, n)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.check, portbench.control, portbench.traffic, portbench.bytes;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert "mythril_tpu_torch" not in tops and not tops & FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, json, pytest; from portbench.tests.tiny import tiny_cell; from portbench import run;"
            "bench, cell, config, mix = tiny_cell('token.frontier', pytest.MonkeyPatch());"
            "run.run_cell(cell, config, mix, 1, 0.01, False, 'cpu', log=lambda m: None);"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, check=True,
                         timeout=600)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mythril_tpu_torch" in tops and not tops & FORBIDDEN
