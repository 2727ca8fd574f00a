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
    # three KAN kernels share one body; the three with a bf16 x (the
    # mixed one's f32 rows split into bf16 planes) run their tensor-core
    # body on that one's knob checks, launch and f32 row staging, with the
    # bf16 matmul's MMA pieces; the two spline-basis kernels share theirs,
    # and only the SPU header with the KAN kernels
    for name in ("kan_fused_v2", "kan_fused_v2_q8", "kan_fused_v1"):
        files = _build.source_files(_build.KERNELS[name][0])
        assert [f.name for f in files[1:]] == [
            "kan_split.cuh", "staging.cuh", "kan_fused.cuh"], name
    for name in ("kan_fused_v2_bf16", "kan_fused_v1_bf16",
                 "kan_fused_v2_mixed"):
        files = _build.source_files(_build.KERNELS[name][0])
        assert [f.name for f in files[1:]] == [
            "kan_mma.cuh", "mma_bf16.cuh", "kan_split.cuh", "staging.cuh",
            "kan_fused.cuh"], name
    files = _build.source_files(_build.KERNELS["pattern_matmul_bf16"][0])
    assert [f.name for f in files[1:]] == [
        "epilogue.cuh", "mma_bf16.cuh", "staging.cuh"]
    for name in ("spline_basis", "spline_basis_bf16"):
        files = _build.source_files(_build.KERNELS[name][0])
        assert [f.name for f in files[1:]] == ["spline_basis.cuh",
                                               "kan_fused.cuh"], name


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


def test_resource_usage_parses_ptxas(tmp_path, monkeypatch):
    """``resource_usage`` runs one compiler per source and reads each
    entry's registers, stack and spills from what ``ptxas -v`` prints."""
    from repro_torch.kernels import _build

    report = tmp_path / "ptxas.txt"
    report.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1kILi8EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kILi8EEvv\n"
        "    80 bytes stack frame, 384 bytes spill stores, 340 bytes "
        "spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 80 bytes "
        "cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z1kILi4EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kILi4EEvv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 149 registers, used 1 barriers\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho \"$@\" >> {tmp_path}/argv\n"
                    f"cat {report}\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    got = _build.resource_usage(["kan_fused_v1", "spline_basis"])
    want = [{"entry": "_Z1kILi8EEvv", "stack": 80, "spill_stores": 384,
             "spill_loads": 340, "registers": 255},
            {"entry": "_Z1kILi4EEvv", "stack": 0, "spill_stores": 0,
             "spill_loads": 0, "registers": 149}]
    assert got == {"kan_fused_v1": want, "spline_basis": want}
    argv = (tmp_path / "argv").read_text().splitlines()
    assert len(argv) == 2 and all("-cubin" in a and "-Xptxas -v" in a
                                  for a in argv)
    assert not any("-shared" in a for a in argv)

