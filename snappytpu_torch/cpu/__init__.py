"""ctypes bindings for the native host runtime (csrc/snappy_cpu.cc) — the
port's copy of snappytpu/cpu, the same source and the same functions.

Auto-builds the shared library with g++ on first import into the port's
_build/ directory, under a name that hashes the source, the flags and the
host's CPU (machine and ISA flags, which `-march=native` follows), so a
library built on one host never loads on another; falls back to
`available = False` if no toolchain is present, in which case callers use
the pure-Python model codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "snappy_cpu.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

available = False
_lib = None


class NativeError(ValueError):
    """Malformed input or capacity error reported by the native runtime."""


_ERRORS = {
    -1: "varint/preamble malformed or buffer too small",
    -2: "output larger than destination capacity",
    -3: "truncated stream",
    -4: "op overruns declared output length",
    -5: "copy offset out of range",
    -6: "trailing garbage after output complete",
    -7: "op straddles block boundary",
    -8: "too many blocks",
}


def _cpu_identity() -> str:
    """The host's machine and the CPU flags -march=native resolves from."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features", "model name")):
                    ident += "\n" + line.strip()
    except OSError:
        ident += "\n" + platform.processor()
    return ident


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode() + b"\0" + _cpu_identity().encode())
    return os.path.join(_BUILD_DIR, f"libsnappy_cpu-{h.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    if os.path.exists(lib):
        return True
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        r = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], capture_output=True, timeout=300)
        if r.returncode != 0:
            return False
        os.replace(tmp, lib)  # atomic: concurrent builders never load a half-written file
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, available
    path = _lib_path()
    if not _build(path):
        return
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.stpu_max_compressed.restype = i64
    lib.stpu_max_compressed.argtypes = [i64]
    lib.stpu_compress.restype = i64
    lib.stpu_compress.argtypes = [u8p, i64, u8p, i64]
    lib.stpu_decompress.restype = i64
    lib.stpu_decompress.argtypes = [u8p, i64, u8p, i64, i64p]
    lib.stpu_scan_ops.restype = i64
    lib.stpu_scan_ops.argtypes = [u8p, i64, i64, i64, i64p, i64p, i64]
    lib.stpu_compact.restype = i64
    lib.stpu_compact.argtypes = [u8p, i64, i32p, i64, u8p, i64]
    lib.stpu_build_tape.restype = i64
    lib.stpu_build_tape.argtypes = [u8p, i64, i64, i64, i64, i64, i32p, i64]
    lib.stpu_split.restype = i64
    lib.stpu_split.argtypes = [u8p, i64, i64p, i64, u8p, i64, i32p]
    _lib = lib
    available = True


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress(data: bytes | np.ndarray) -> bytes:
    """Native greedy-hash compress (raw Snappy stream with preamble)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    cap = int(_lib.stpu_max_compressed(arr.size))
    out = np.empty(cap, dtype=np.uint8)
    size = _lib.stpu_compress(_u8(arr), arr.size, _u8(out), cap)
    if size < 0:
        raise NativeError(_ERRORS.get(size, f"error {size}"))
    return out[:size].tobytes()


def decompress(data: bytes | np.ndarray) -> bytes:
    """Native validated decompress of a raw Snappy stream."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    from ..format.varint import decode_varint

    total, _ = decode_varint(arr)
    out = np.empty(total + 8, dtype=np.uint8)  # +8: overlap fast-path slack
    out_len = ctypes.c_int64(0)
    rc = _lib.stpu_decompress(
        _u8(arr), arr.size, _u8(out), total + 8, ctypes.byref(out_len)
    )
    if rc != 0:
        raise NativeError(_ERRORS.get(rc, f"error {rc}"))
    return out[: out_len.value].tobytes()


def scan_ops(ops: np.ndarray, total_out: int, block_size: int = 65536):
    """Native op-boundary scan: -> (comp_offsets int64[], out_lens int64[]).
    Raises NativeError on malformed or unsplittable streams."""
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    max_blocks = max(total_out // block_size + 2, 2)
    offs = np.empty(max_blocks, dtype=np.int64)
    lens = np.empty(max_blocks, dtype=np.int64)
    nb = _lib.stpu_scan_ops(
        _u8(ops), ops.size, total_out, block_size,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_blocks,
    )
    if nb < 0:
        raise NativeError(_ERRORS.get(nb, f"error {nb}"))
    return offs[:nb], lens[:nb]


def compact(rows: np.ndarray, lens: np.ndarray) -> bytes:
    """Native gather of variable-length rows into one contiguous stream."""
    out = np.empty(max(int(np.sum(lens, dtype=np.int64)), 1), dtype=np.uint8)
    return out[: compact_into(rows, lens, out)].tobytes()


def compact_into(rows: np.ndarray, lens: np.ndarray, out: np.ndarray) -> int:
    """compact into the front of the uint8 array `out`; returns the bytes
    written.  NativeError if they do not fit."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a contiguous uint8 array")
    w = _lib.stpu_compact(
        _u8(rows), rows.shape[1], lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows.shape[0], _u8(out), out.size,
    )
    if w < 0:
        raise NativeError("compact overflow")
    return int(w)


def build_tapes(comp_rows: np.ndarray, comp_lens: np.ndarray,
                out_lens: np.ndarray, comp_off: int, out_base: int,
                max_recs: int, out=None):
    """Host movement-tape builder for the movement-only device decoder:
    (B, stride) padded comp rows + per-block lens -> ((B, 2*max_recs) int32
    tapes, (B,) int32 n_recs).  n_recs is -9 where the tape overflowed
    (caller falls back to the parsing VM) and -10 where the stream is
    malformed (same accept set as the VM).  `out`, a (tapes, nrecs) pair
    of those shapes, is written instead of new arrays; past its records a
    tape then holds what the array held (every reader stops at n_recs)."""
    comp_rows = np.ascontiguousarray(comp_rows, dtype=np.uint8)
    B, stride = comp_rows.shape
    if out is None:
        tapes, nrecs = np.zeros((B, 2 * max_recs), dtype=np.int32), np.empty(B, dtype=np.int32)
    else:
        tapes, nrecs = out
        if tapes.shape != (B, 2 * max_recs) or tapes.dtype != np.int32 or not tapes.flags.c_contiguous \
                or nrecs.shape != (B,) or nrecs.dtype != np.int32:
            raise ValueError(f"out must be a contiguous ({B}, {2 * max_recs}) and a ({B},) int32 array")
    i32p = ctypes.POINTER(ctypes.c_int32)
    for i in range(B):
        nrecs[i] = _lib.stpu_build_tape(
            _u8(comp_rows[i]), stride, int(comp_lens[i]), int(out_lens[i]),
            comp_off, out_base, tapes[i].ctypes.data_as(i32p), max_recs,
        )
    return tapes, nrecs


def split_rows(stream: np.ndarray, cuts: np.ndarray, stride: int, out=None):
    """Native scatter of a contiguous stream into zero-padded fixed-stride
    rows given per-row start offsets; the last row ends at the stream's
    end.  `out`, a contiguous (rows, lens) pair of (n, stride) uint8 and
    (n,) int32, is written instead of new arrays."""
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    cuts64 = np.ascontiguousarray(cuts, dtype=np.int64)
    nrows = cuts64.size
    if out is None:
        rows, lens = np.empty((nrows, stride), dtype=np.uint8), np.empty(nrows, dtype=np.int32)
    else:
        rows, lens = out
        if rows.shape != (nrows, stride) or rows.dtype != np.uint8 or not rows.flags.c_contiguous \
                or lens.shape != (nrows,) or lens.dtype != np.int32:
            raise ValueError(f"out must be a contiguous ({nrows}, {stride}) uint8 and a ({nrows},) int32 array")
    rc = _lib.stpu_split(
        _u8(stream), stream.size,
        cuts64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nrows,
        _u8(rows), stride, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise NativeError("row exceeds stride")
    return rows, lens


_load()
