"""Build and bind the port's CUDA kernels.

The sources in csrc/ are compiled by nvcc for sm_90a, one nvcc process per
.cu file, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes.  The build happens at first use,
into _build/ beside this file, under a name that carries a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
at once.  Nothing here runs at import time: the CPU routes never need nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (pieces, lens, out, B, S, cap, out_cap, stream) -> cudaError_t
    "snappy_concat_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (comp, comp_lens, out_lens, out, ok, B, stream) -> cudaError_t
    "snappy_decode_blocks": (_P, _P, _P, _P, _P, _I, _P),
    # (comp, comp_lens, out_lens, ctx_lens, ctx0, out, ok, N, stream) -> cudaError_t
    "snappy_decode_stream": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    # (tapes, nrecs, comp, out, ok, B, cap, stream) -> cudaError_t
    "snappy_run_tape": (_P, _P, _P, _P, _P, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc() -> str:
    """The nvcc that torch.utils.cpp_extension would use."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not path.is_file():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"libsnappytpu_torch-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for the current sources exists.
    The compilers' output (ptxas register and shared-memory report) is kept
    beside the library as .log."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    cus = [p for p in sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
    jobs = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(cus, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in jobs]
    outs = [p.communicate()[0] for p in procs]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    failed = [(cmd, out) for cmd, out, p in zip(jobs, outs, procs) if p.returncode != 0]
    if not failed:
        r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs, outs = [*jobs, link], [*outs, r.stdout]
        if r.returncode != 0:
            failed = [(link, r.stdout)]
    so.with_suffix(".log").write_text("".join(" ".join(c) + "\n" + o for c, o in zip(jobs, outs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.snappy_cuda_error_string.argtypes = [ctypes.c_int]
    lib.snappy_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError after it)."""
    if rc != 0:
        name = library().snappy_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({name})")
