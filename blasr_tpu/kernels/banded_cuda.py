"""Hopper banded-DP kernel (``native/banded_dp.cu``) called through the XLA
FFI, and the choice of banded-DP implementation per platform.

``cuda_banded_align`` has the contract of ``kernels.banded.banded_align``
for the flat-cost and QV-steered modes (the homopolymer-insertion band
runs on XLA everywhere), with one extra requirement: ``offsets`` advance
by 0, 1 or 2 per query row, as ``map_read._band_offsets`` guarantees
(``banded.slope_limit_offsets``).  Its results are bit-identical to
``banded_align``'s, so ``banded_traceback`` consumes them unchanged.

The library is compiled with ``nvcc`` from the committed source at first
use into ``native/build`` (keyed by the source hash).  On a GPU there is
no fallback: a library that cannot be built or loaded raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading

import jax
import jax.numpy as jnp

from blasr_tpu import native
from blasr_tpu.kernels.banded import BandedResult, banded_align

BAND = 128  # the kernel's band width: 32 lanes x 4 cells
_SRC = os.path.join(os.path.dirname(native.__file__), "banded_dp.cu")
_TARGETS = {"blasr_banded_dp": "BlasrBandedDp",
            "blasr_banded_dp_qv": "BlasrBandedDpQv"}
_lock = threading.Lock()
_registered = False


def dp_kernel_for(platform: str) -> str:
    """The banded-DP implementation for a JAX platform name: the CUDA
    kernel on ``"gpu"``, XLA's ``lax.scan`` (``banded_align``) elsewhere."""
    return "cuda" if platform == "gpu" else "xla"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _nvcc_command() -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-fmad=false", "-shared",
            "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir()]


def load_library() -> None:
    """Build (once per source hash) and load the kernel library, and
    register its FFI targets for CUDA.  Raises ``RuntimeError`` when the
    library cannot be built or loaded."""
    global _registered
    with _lock:
        if _registered:
            return
        try:
            path = native.build_library("banded_dp", [_SRC], _nvcc_command())
            lib = ctypes.CDLL(path)
        except Exception as e:
            raise RuntimeError(
                f"the CUDA banded-DP kernel could not be built or loaded "
                f"({e}); the GPU path has no fallback") from e
        for name, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform="CUDA")
        _registered = True


def pack_inputs(reads, offsets, qa, qb, ta, tb, submat,
                ins_open, ins_ext, del_open, del_ext):
    """The kernel's operand layout: rows int32 [N, L] = offset << 3 | read
    base (one load gives a row's band start and base), spans int32 [N, 4]
    = (qa, qb, ta, tb), costs f32 [32] = 5x5 matrix, ins/del open/extend,
    zero padding."""
    rows = (offsets.astype(jnp.int32) << 3) | reads.astype(jnp.int32)
    spans = jnp.stack([qa, qb, ta, tb], axis=1).astype(jnp.int32)
    gaps = jnp.stack([jnp.asarray(g, jnp.float32)
                      for g in (ins_open, ins_ext, del_open, del_ext)])
    costs = jnp.concatenate([jnp.asarray(submat, jnp.float32).reshape(25),
                             gaps, jnp.zeros((3,), jnp.float32)])
    return rows, spans, costs


def ffi_banded_dp(rows, windows, spans, costs, qv1=None, qv2=None):
    """The FFI call itself: (score f32 [N], cells int32 [N, L, 128],
    state int32 [N], ok int32 [N])."""
    N, L = rows.shape
    out = (jax.ShapeDtypeStruct((N,), jnp.float32),
           jax.ShapeDtypeStruct((N, L, BAND), jnp.int32),
           jax.ShapeDtypeStruct((N,), jnp.int32),
           jax.ShapeDtypeStruct((N,), jnp.int32))
    if qv1 is None:
        return jax.ffi.ffi_call("blasr_banded_dp", out)(
            rows, windows.astype(jnp.int8), spans, costs)
    return jax.ffi.ffi_call("blasr_banded_dp_qv", out)(
        rows, windows.astype(jnp.int8), spans, costs,
        qv1.astype(jnp.int32), qv2.astype(jnp.int32))


def reference_banded_dp(rows, windows, spans, costs, qv1=None, qv2=None):
    """Plain-JAX reference of the FFI contract (decodes the packed operands
    and runs ``banded_align``); what the CPU tests check the packing
    against."""
    o, rb = rows >> 3, (rows & 7).astype(jnp.int8)
    qa, qb, ta, tb = (spans[:, j] for j in range(4))
    res = banded_align(rb, windows, o, qa, qb, ta, tb, costs[:25],
                       costs[25], costs[26], costs[27], costs[28],
                       w_b=BAND, qv1=qv1, qv2=qv2)
    return (res.score, res.tbbits, res.final_state,
            res.valid.astype(jnp.int32))


def align_with(kernel, reads, windows, offsets, qa, qb, ta, tb, submat,
               ins_open, ins_ext, del_open, del_ext, *, w_b: int = BAND,
               qv1=None, qv2=None) -> BandedResult:
    """banded_align's contract on top of a kernel with the FFI operand
    layout (``ffi_banded_dp`` or ``reference_banded_dp``)."""
    if w_b != BAND:
        raise ValueError(f"the CUDA banded-DP kernel has a {BAND}-cell "
                         f"band, not {w_b}")
    rows, spans, costs = pack_inputs(reads, offsets, qa, qb, ta, tb, submat,
                                     ins_open, ins_ext, del_open, del_ext)
    score, cells, state, ok = kernel(rows, windows, spans, costs, qv1, qv2)
    return BandedResult(score=score, tbbits=cells, final_state=state,
                        valid=ok != 0)


@functools.partial(jax.jit, static_argnames=("w_b",))
def cuda_banded_align(reads, windows, offsets, qa, qb, ta, tb, submat,
                      ins_open, ins_ext, del_open, del_ext, *,
                      w_b: int = BAND, qv1=None, qv2=None) -> BandedResult:
    """``banded_align`` (flat-cost or QV mode) on the Hopper kernel."""
    load_library()
    return align_with(ffi_banded_dp, reads, windows, offsets, qa, qb, ta, tb,
                      submat, ins_open, ins_ext, del_open, del_ext, w_b=w_b,
                      qv1=qv1, qv2=qv2)
