"""The PyTorch port, its tools (tools_torch/) and chip_smoke.py stand
alone: they import neither JAX nor any module of the TPU package
(lte_cell_scanner_tpu)."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "lte_cell_scanner_tpu_torch"
TOOLS = ROOT / "tools_torch"
FORBIDDEN = ("jax", "jaxlib", "lte_cell_scanner_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _package_files():
    # build/ holds compiled kernels, never sources of the package
    return sorted(p for p in PKG.rglob("*.py")
                  if "build" not in p.relative_to(PKG).parts)


def _tool_files():
    return sorted(TOOLS.glob("*.py"))


def _sources():
    return _package_files() + _tool_files() + [ROOT / "chip_smoke.py"]


def test_module_names_are_matched_exactly():
    assert _forbidden("jax.numpy")
    assert _forbidden("lte_cell_scanner_tpu.models.xcorr")
    assert not _forbidden("lte_cell_scanner_tpu_torch")
    assert not _forbidden("lte_cell_scanner_tpu_torch.models.xcorr")
    assert not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax_module():
    mods = sorted("lte_cell_scanner_tpu_torch." + str(
        p.relative_to(PKG).with_suffix("")).replace("/", ".")
        for p in _package_files() if p.name != "__init__.py") \
        + ["lte_cell_scanner_tpu_torch"] \
        + ["tools_torch." + p.stem for p in _tool_files()]
    assert "tools_torch.bench_kernels" in mods
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    new = json.loads(out.strip().splitlines()[-1])
    assert "lte_cell_scanner_tpu_torch.models.search" in new
    assert [m for m in new if _forbidden(m)] == []
