"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's tools import neither JAX nor anything of the JAX package
``repro`` (only the tests import both).  Module names are matched, not
substrings, so ``repro_torch`` itself is of course allowed."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
TOOLS = [os.path.join(REPO, "tools", f) for f in
         ("profile_torch_sync.py", "profile_torch_serve.py")]


def port_files() -> list:
    out = [SMOKE] + TOOLS
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_modules(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "importorskip") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_imports(path):
    bad = sorted(n for n in imported_modules(path) if forbidden(n))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_matches_module_names():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("repro") and forbidden("repro.kernels.ref")
    assert not forbidden("repro_torch") and not forbidden("repro_torch.core")
    assert not forbidden("jaxtyping_like") and not forbidden("reproduce")


def test_port_imports_with_jax_and_repro_blocked():
    """Every module of the port imports, and chip_smoke.py compiles and
    imports, in a process where ``import jax`` / ``import repro`` fail."""
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = sys.modules["repro"] = None
sys.path[:0] = [{os.path.join(REPO, "src")!r}, {REPO!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
compile(open({SMOKE!r}).read(), {SMOKE!r}, "exec")
import chip_smoke
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 20
