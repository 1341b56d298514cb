"""The PyTorch port stands alone: it never imports jax, flax, optax, orbax or
the JAX package, at runtime or in its source."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process holds both packages)
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tdfo_tpu")


def test_runtime_import_pulls_no_jax():
    # a subprocess: conftest has already imported jax into this one
    code = """
import importlib, json, pkgutil, sys
import tdfo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tdfo_tpu_torch.__path__,
                                               'tdfo_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                                    'tdfo_tpu'))
print(json.dumps({'modules': names, 'bad': bad}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=120,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tdfo_tpu_torch.train.trainer" in res["modules"]
    assert res["bad"] == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_source_imports_no_jax():
    files = sorted((ROOT / "tdfo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}, json.dumps(bad)
