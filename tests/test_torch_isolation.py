"""The port stands alone: importing every module of ``repro_torch`` pulls in
neither JAX, the JAX reference package ``repro`` nor ``ml_dtypes`` (the
card's machine has none: bf16 SVs are torch tensors there), and no source
of the port (nor ``chip_smoke.py`` or the ``scripts/profile_torch_*.py``,
which import lazily inside functions) names any of them in an import
statement."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_train.py",
           ROOT / "scripts" / "profile_torch_serve.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _port_modules() -> list:
    return sorted(p for p in PORT.rglob("*.py"))


def test_importing_every_port_module_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    want = {".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            for p in _port_modules() if p.name != "__init__.py"}
    assert want <= set(res["modules"]), want - set(res["modules"])
    assert res["bad"] == []


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_imports_jax_or_reference():
    files = _port_modules() + SCRIPTS
    assert len(files) > 40
    banned = {"jax", "jaxlib", "repro", "ml_dtypes"}
    bad = {str(p.relative_to(ROOT)): sorted(r & banned)
           for p in files for r in [_imported_roots(p)] if r & banned}
    assert bad == {}
