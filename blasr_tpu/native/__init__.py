"""Native (C++/CUDA) components, built from the sources in this directory
at first use and loaded via ctypes.

Libraries go to ``build/`` (gitignored) under a name keyed by a hash of
the sources, the compile command and the host's CPU signature, so a
library built on one machine is never loaded on another (``-march=native``
code can SIGILL elsewhere) and a source edit rebuilds.

Components:
  * sais.cpp — O(n) SA-IS suffix-array construction (index build path;
    replaces the reference's Larsson-Sadakane, utils/SAWriter.cpp:201-235),
    BWT inversion and the CIGAR decoders.  Optional: callers fall back to
    Python when it cannot be built.
  * banded_dp.cu — the Hopper banded-DP kernel (kernels/banded_cuda.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

from blasr_tpu.hostcache import host_cache_key

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path(stem: str, sources: Sequence[str],
                 command: Sequence[str]) -> str:
    """Where the library built from ``sources`` by ``command`` lives."""
    h = hashlib.sha256(host_cache_key().encode())
    h.update("\0".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_library(stem: str, sources: Sequence[str],
                  command: Sequence[str], timeout: float = 600.0) -> str:
    """Build the library once and return its path.  ``command`` is the
    compiler invocation without its output; ``-o <path>`` is appended.
    Concurrent builders each write a private file and rename it into
    place.  Raises ``OSError`` or ``subprocess.SubprocessError`` (with the
    compiler's output) when the build fails."""
    path = library_path(stem, sources, command)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*command, *sources, "-o", tmp],
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise subprocess.SubprocessError(
                f"{command[0]} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


_CXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            path = build_library("blasr_native",
                                 [os.path.join(_DIR, "sais.cpp")], _CXX,
                                 timeout=120)
            lib = ctypes.CDLL(path)
            lib.sais_u8.restype = ctypes.c_int
            lib.sais_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.bwt_invert_u8.restype = ctypes.c_int
            lib.bwt_invert_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_uint8, ctypes.POINTER(ctypes.c_uint8)]
            lib.cigar_from_pairs.restype = ctypes.c_int64
            lib.cigar_from_pairs.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
            lib.cigar_from_pairs_batch.restype = ctypes.c_int64
            lib.cigar_from_pairs_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            _lib = lib
            return _lib
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None


def sais_native(codes: np.ndarray) -> Optional[np.ndarray]:
    """Suffix array via native SA-IS; None if the extension is unavailable.
    codes: uint8 array with values < 255 (internally 1-shifted)."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(codes, dtype=np.uint8) + 1
    n = len(s)
    sa = np.empty(n, dtype=np.int64)
    rc = lib.sais_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    if n < 2**31:
        return sa.astype(np.int32)
    return sa


_OPSYM = {1: "M", 2: "I", 3: "D", 4: "X"}
_scratch = threading.local()


def cigar_native(words: np.ndarray, allow_adjacent: bool):
    """CIGAR runs from RL traceback pair words (int32, two op|count<<2
    uint16 halves each, end-first); None if the extension is unavailable.
    Returns [(op_char, count), ...] in alignment order, adjacent I/D pairs
    folded into 'X' unless allow_adjacent."""
    lib = _lib if _lib is not None else get_lib()
    if lib is None or not hasattr(lib, "cigar_from_pairs"):
        return None
    p = np.ascontiguousarray(words, dtype=np.int32)
    max_runs = p.size * 2 + 1
    bufs = getattr(_scratch, "bufs", None)
    if bufs is None or bufs[0].size < max_runs:
        bufs = (np.empty(max_runs, dtype=np.uint8),
                np.empty(max_runs, dtype=np.int32))
        _scratch.bufs = bufs
    ops, cnts = bufs
    n = lib.cigar_from_pairs(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(p.size), ctypes.c_int(1 if allow_adjacent else 0),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(max_runs))
    if n < 0:
        return None
    # bulk tolist() then zip: per-element int(np scalar) conversion was
    # ~10x slower than the C call itself
    return list(zip(map(_OPSYM.__getitem__, ops[:n].tolist()),
                    cnts[:n].tolist()))


def cigar_native_batch(words: np.ndarray, slots: np.ndarray,
                       allow_adjacent: bool):
    """Decode many RL traceback rows in one native call.  words: int32
    [n_rows, row_words]; slots: row indices to decode.  Returns
    (ops uint8 [total], counts int32 [total], offsets int64 [len(slots)+1])
    — runs for slot j live at offsets[j]:offsets[j+1] — or None if the
    extension is unavailable.  Run-for-run identical to per-row
    cigar_native."""
    lib = _lib if _lib is not None else get_lib()
    if lib is None or not hasattr(lib, "cigar_from_pairs_batch"):
        return None
    p = np.ascontiguousarray(words, dtype=np.int32)
    s = np.ascontiguousarray(slots, dtype=np.int64)
    max_total = int(s.size) * (p.shape[1] * 2 + 1)
    ops = np.empty(max_total, dtype=np.uint8)
    cnts = np.empty(max_total, dtype=np.int32)
    offs = np.empty(s.size + 1, dtype=np.int64)
    n = lib.cigar_from_pairs_batch(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(p.shape[1]),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(s.size), ctypes.c_int(1 if allow_adjacent else 0),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(max_total))
    if n < 0:
        return None
    return ops, cnts, offs


def runs_to_list(ops: np.ndarray, cnts: np.ndarray):
    """[(op_char, count), ...] from raw run arrays (cigar_native_batch)."""
    return list(zip(map(_OPSYM.__getitem__, ops.tolist()), cnts.tolist()))


def bwt_invert_native(bwt: np.ndarray, sentinel: int) -> Optional[np.ndarray]:
    """Native BWT inversion; None if the extension is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bwt_invert_u8"):
        return None
    b = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = len(b)
    out = np.empty(max(n - 1, 0), dtype=np.uint8)
    rc = lib.bwt_invert_u8(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_uint8(sentinel),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out
