"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``.

One test imports every module of the port, and ``chip_smoke``, in a
fresh interpreter where ``jax`` is unimportable and a meta-path finder
refuses ``repro``; the others read each source file for such imports,
including ones inside functions that an import alone would not run.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")
TEXT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro\.|"
                  r"from\s+repro\s|import\s+repro(?!_torch)\b)", re.M)


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        for name in {MODULES!r}:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("imported", len({MODULES!r}) + 1)
    """)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(MODULES) + 1}" in res.stdout


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_has_no_jax_or_repro_import(path):
    text = path.read_text()
    assert not TEXT.search(text), TEXT.search(text).group(0)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
