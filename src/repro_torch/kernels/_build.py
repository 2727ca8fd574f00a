"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point that
takes device pointers, sizes and the stream, launches, and returns
``cudaGetLastError()``.  It is compiled for ``sm_90a`` into
``build/repro_torch_kernels/`` at the repository root at first use (the
library name carries a hash of the source, of every header it includes
with quotes, and of the flags, so an edited source or header is rebuilt)
and loaded with ``ctypes``.  Only sources in the
repository are compiled; nothing here runs at import time, so the
package imports on machines without ``nvcc`` or a GPU.

``LAUNCHES`` counts, per kernel, the launches made through ``launch``:
the wrappers call nothing else, so a run can show that its path went
through the kernels.  ``BUILDS`` counts, per kernel, its set-up steps:
each ``nvcc`` compile of its source and each load of its library into
the process, so a timed run can show that it paid for neither.
``resource_usage`` reports what ``ptxas`` gives each compiled kernel
instance: registers, stack and spills.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

DEVICE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3")
NVCC_FLAGS = DEVICE_FLAGS + ("-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (source, C symbol, argtypes).  Every pointer and the
# stream are c_void_p.
KERNELS = {
    "kan_fused_v2": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused.cu",
        "kan_fused_v2_f32",
        # x, wt, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h,
        # bm, bi, bn, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
         _P)),
    "pattern_matmul": (
        KERNELS_DIR / "pattern_matmul" / "csrc" / "pattern_matmul.cu",
        "pattern_matmul_f32",
        # x, w, bias (or NULL), y, M, K, N, act, bm, bk, bn, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "kan_fused_v2_q8": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused_q8.cu",
        "kan_fused_v2_q8",
        # x_q, wt_q, slot_scales, slot_of, out, B, n_in, n_out, nbk, G, K,
        # x_scale, x0, hi, inv_h, bm, bi, bn, stream
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
         _I, _P)),
    "pattern_matmul_q8": (
        KERNELS_DIR / "pattern_matmul" / "csrc" / "pattern_matmul_q8.cu",
        "pattern_matmul_s8",
        # x_q, w_q, y, M, K, N, bm, bk, bn, stream
        (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "spline_basis": (
        KERNELS_DIR / "spline_basis" / "csrc" / "spline_basis.cu",
        "spline_basis_f32",
        # x, out, n, G, K, x0, inv_h, block_n, stream
        (_P, _P, _I, _I, _I, _F, _F, _I, _P)),
    "kan_fused_v1": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused_v1.cu",
        "kan_fused_v1_f32",
        # x, w_b, t_flat, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi,
        # inv_h, bm, bi, bn, stream
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
         _P)),
    # the bf16 instances
    "kan_fused_v2_bf16": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused_bf16.cu",
        "kan_fused_v2_bf16",
        # x, wt, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h,
        # out_f32, bm, bi, bn, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I,
         _P)),
    "pattern_matmul_bf16": (
        KERNELS_DIR / "pattern_matmul" / "csrc" / "pattern_matmul_bf16.cu",
        "pattern_matmul_bf16",
        # x, w, bias (or NULL), y, M, K, N, act, out_f32, bm, bk, bn, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "spline_basis_bf16": (
        KERNELS_DIR / "spline_basis" / "csrc" / "spline_basis_bf16.cu",
        "spline_basis_bf16",
        # x, out, n, G, K, x0, inv_h, block_n, stream
        (_P, _P, _I, _I, _I, _F, _F, _I, _P)),
    "kan_fused_v1_bf16": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused_v1_bf16.cu",
        "kan_fused_v1_bf16",
        # x, w_b, t_flat, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi,
        # inv_h, out_f32, bm, bi, bn, stream
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
         _I, _P)),
    # bf16 x against f32 fused weights (a bf16 model's f32 spline rows),
    # on kan_mma.cuh's tensor-core body (the rows split into bf16 planes)
    "kan_fused_v2_mixed": (
        KERNELS_DIR / "kan_fused" / "csrc" / "kan_fused_mixed.cu",
        "kan_fused_v2_mixed",
        # x, wt, slot_of, out, B, n_in, n_out, nbk, G, K, x0, hi, inv_h,
        # out_f32, bm, bi, bn, stream
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I,
         _P)),
}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
BUILDS: Dict[str, int] = {name: 0 for name in KERNELS}


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


def source_files(src: Path) -> List[Path]:
    """``src`` and every file it includes with quotes, recursively, each
    resolved against the directory of the file that includes it."""
    out: List[Path] = []
    todo = [src.resolve()]
    while todo:
        f = todo.pop(0)
        if f in out:
            continue
        out.append(f)
        todo.extend((f.parent / inc).resolve()
                    for inc in _INCLUDE.findall(f.read_text()))
    return out


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library lives once built."""
    h = hashlib.sha256()
    for f in source_files(KERNELS[name][0]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
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
            BUILDS[n] += 1
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def resource_usage(names: Optional[Iterable[str]] = None
                   ) -> Dict[str, List[Dict[str, object]]]:
    """Per kernel, each instance ``ptxas -v`` compiles from its source
    (``DEVICE_FLAGS``, device code only, one ``nvcc`` per source, all
    started together): the entry's mangled name, registers a thread,
    stack frame and spill stores and loads in bytes.  Raises with the
    compiler's output if a compile fails."""
    names = list(KERNELS) if names is None else list(names)
    nvcc = _nvcc()
    out: Dict[str, List[Dict[str, object]]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(n, subprocess.Popen(
            [nvcc, *DEVICE_FLAGS, "-cubin", "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"{n}.cubin"), str(KERNELS[n][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for n in names]
        failed = []
        for n, proc in procs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n} (nvcc exit {proc.returncode}):\n{text}")
                continue
            entries: List[Dict[str, object]] = []
            for line in text.splitlines():
                m = _ENTRY.search(line)
                if m:
                    entries.append({"entry": m.group(1)})
                elif entries and _FRAME.search(line):
                    stack, stores, loads = _FRAME.search(line).groups()
                    entries[-1].update(stack=int(stack),
                                       spill_stores=int(stores),
                                       spill_loads=int(loads))
                elif entries and _REGS.search(line):
                    entries[-1]["registers"] = int(
                        _REGS.search(line).group(1))
            out[n] = entries
    if failed:
        raise RuntimeError("ptxas report failed: " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def _entry(name: str) -> ctypes._CFuncPtr:
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    BUILDS[name] += 1
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
