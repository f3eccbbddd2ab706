"""The port imports no JAX and nothing of the JAX package.

An AST scan of every module of ``pytorch_distributed_tpu_torch`` and of
``chip_smoke.py`` checks each import's TOP-LEVEL module name exactly (the
port's own name starts with the JAX package's, so a prefix match would be
wrong both ways); a subprocess then imports the whole port and checks
that ``jax`` never entered ``sys.modules``.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pytorch_distributed_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "pytorch_distributed_tpu"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize(
    "path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES]
)
def test_module_imports_nothing_of_jax(path):
    bad = _top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_the_port_and_matches_names_exactly():
    assert len(FILES) > 10
    engine = PORT / "serving" / "engine.py"
    assert "pytorch_distributed_tpu_torch" in _top_level_imports(engine)
    assert "pytorch_distributed_tpu_torch" not in FORBIDDEN


def test_importing_the_whole_port_loads_no_jax():
    mods = sorted(
        m.name for m in pkgutil.walk_packages(
            [str(PORT)], prefix="pytorch_distributed_tpu_torch."
        )
    )
    assert "pytorch_distributed_tpu_torch.serving.engine" in mods
    code = (
        "import importlib, sys\n"
        "import pytorch_distributed_tpu_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'pytorch_distributed_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
