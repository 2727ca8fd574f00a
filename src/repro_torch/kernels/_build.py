"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point that
takes device pointers, sizes and the stream, launches, and returns
``cudaGetLastError()``.  It is compiled for ``sm_90a`` into
``build/repro_torch_kernels/`` at the repository root at first use (the
library name carries a hash of the source and flags, so an edited
source is rebuilt) and loaded with ``ctypes``.  Only sources in the
repository are compiled; nothing here runs at import time, so the
package imports on machines without ``nvcc`` or a GPU.

``LAUNCHES`` counts, per kernel, the launches made through ``launch``:
the wrappers call nothing else, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (source, C symbol, argtypes).  Every pointer and the
# stream are c_void_p.
KERNELS = {
    "kan_fused_v2": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused.cu",
        "kan_fused_v2_f32",
        # x, wt, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P)),
    "pattern_matmul": (
        KERNELS_DIR / "pattern_matmul" / "csrc" / "pattern_matmul.cu",
        "pattern_matmul_f32",
        # x, w, bias (or NULL), y, M, K, N, act, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use on a CUDA machine")
    return path


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library lives once built."""
    src = KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> library path; raises
    with the compiler's output if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNELS[n][0])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def _entry(name: str) -> ctypes._CFuncPtr:
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    _, symbol, argtypes = KERNELS[name]
    fn = getattr(lib, symbol)      # the CDLL caches it; lru_cache keeps lib
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args: object) -> None:
    """Launch kernel ``name`` on the given arguments and count it; raise if
    the launch was refused (the C entry returns ``cudaGetLastError()``)."""
    rc = _entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")
    LAUNCHES[name] += 1
