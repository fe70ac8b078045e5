"""Builds the CUDA kernels of ``repro_torch/csrc`` and loads them.

Every ``*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object file
(one compiler process per source, all started together) and the objects
are linked into one shared library with a plain C interface, which
``ctypes`` loads. No source includes PyTorch's headers, so a build takes
seconds. The library goes to ``build/repro_torch/`` at the root of the
checkout, named after a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree reuses what is there. Nothing is built
when a module is imported: ``load()`` builds at first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "rt_rmsnorm": [_P, _P, _P, _I, _I, _L, _L, _F, _I, _P],
    "rt_flash_decode": [_P] * 8 + [_I] * 7 + [_L] * 10 + [_I] * 3 + [_P],
    "rt_flash_attention": [_P] * 8 + [_I] * 6 + [_L] * 12 + [_I] * 8 + [_P],
    "rt_stress_mxu": [_P, _P, _P, _I, _I, _I, _I, _P],
    "rt_stress_vpu": [_P, _P, _L, _L, _I, _I, _I, _I, _P],
    "rt_stress_hbm": [_P, _P, _L, _I, _I, _P],
    "rt_stress_vmem": [_P, _P] + [_I] * 6 + [_P],
    "rt_cache_share": [_P, _P, _D, _P, _I, _I, _P],
    "rt_ssm_scan": [_P] * 8 + [_I] * 5 + [_P],
    "rt_rope_write": [_P] * 12 + [_I] * 6 + [_L] * 15 + [_F] + [_I] * 5 + [_P],
    "rt_moe_experts": [_P] * 7 + [_I] * 4 + [_L] * 10 + [_I] + [_P],
    "rt_empty": [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch cannot "
                       "be built (looked on PATH and under CUDA_HOME)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build() -> Path:
    """Compile and link the library if it is not there yet; return its path.
    The compiler's output (registers, shared memory and spills of every
    kernel, from ``-Xptxas -v``) is kept beside it as ``<library>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objects, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objects.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"==== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    Path(f"{lib}.log").write_text("\n".join(log))
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = BUILD_DIR / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
        os.replace(tmp, lib)       # atomic: a reader sees no half-written file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with ``argtypes`` set on
    every entry point (``c_void_p`` for pointers and the stream: without
    it ctypes would cut a pointer to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_launch(rc: int, what: str) -> None:
    """Raise unless the C entry point returned 0: ``cudaGetLastError()`` of a
    launch that was refused, or -1 for a shape it does not take."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with code {rc}"
                           + (" (unsupported shape)" if rc == -1 else " (CUDA error)"))


def check_dtypes(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q and k/v share bf16 or f32, or k/v are a bf16 cache under f32 queries
    (a model with f32 parameters keeps its cache in bf16)."""
    ok = (k.dtype == v.dtype and q.dtype in DTYPE_CODES
          and (k.dtype == q.dtype
               or (q.dtype, k.dtype) == (torch.float32, torch.bfloat16)))
    if not ok:
        raise TypeError(f"{what}: unsupported dtypes q {q.dtype} k {k.dtype} "
                        f"v {v.dtype}")


def check_rows_aligned(what: str, t: torch.Tensor, *row_strides: int) -> None:
    """The kernels read rows with 16-byte loads: the last dimension must be
    contiguous, and the base pointer and every stride that separates two
    rows must be multiples of 16 bytes."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: last dimension must have stride 1")
    if t.data_ptr() % 16 or any(s % per16 for s in row_strides):
        raise ValueError(f"{what}: rows must be 16-byte aligned "
                         f"(strides {tuple(t.stride())})")
