"""The port's import boundary: no JAX, nothing of the JAX package, and no
GPU or compiler needed to import it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_has_a_cuda_source():
    from repro_torch.kernels import _build

    for name, (src, symbol, _) in _build.KERNELS.items():
        text = src.read_text()
        assert f'extern "C" int {symbol}(' in text, name
        assert "src/repro/kernels/" in text, f"{name}: no TPU-kernel note"
        assert src.is_relative_to(PORT)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header that a source includes rebuilds the kernel."""
    from repro_torch.kernels import _build

    hdr = tmp_path / "inc" / "h.cuh"
    hdr.parent.mkdir()
    hdr.write_text("#pragma once\nconstexpr int A = 1;\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/h.cuh"\n'
                   'extern "C" int k() { return A; }\n')
    monkeypatch.setitem(_build.KERNELS, "k", (src, "k", ()))
    assert _build.source_files(src) == [src.resolve(), hdr.resolve()]
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    hdr.write_text("#pragma once\nconstexpr int A = 2;\n")
    assert _build.library_path("k") != before
    for name in ("kan_fused_v2", "kan_fused_v2_q8"):
        files = _build.source_files(_build.KERNELS[name][0])
        assert [f.name for f in files[1:]] == ["kan_fused.cuh"], name


def test_imports_need_no_gpu_or_nvcc(tmp_path):
    """Every port module imports with no nvcc on PATH and no visible GPU,
    never imports jax, and builds nothing at import."""
    code = f"""
import importlib, pathlib, pkgutil, sys
build = pathlib.Path({str(ROOT / "build")!r})
before = sorted(build.rglob("*")) if build.exists() else []
import repro_torch
from repro_torch.kernels import _build
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert "jax" not in sys.modules and "repro" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert _build.BUILD_DIR.parent == build
assert (sorted(build.rglob("*")) if build.exists() else []) == before
print(len(names))
"""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_build_without_nvcc_raises(monkeypatch):
    from repro_torch.kernels import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here; this checks its absence")
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent/build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_chip_smoke_alone_fails_without_output(tmp_path):
    """chip_smoke.py outside a checkout (or without CUDA) exits non-zero
    and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
