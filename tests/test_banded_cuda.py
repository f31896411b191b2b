"""The Hopper banded-DP kernel (kernels/banded_cuda.py) against the XLA
kernel (kernels/banded.py), and the choice between them.

The CUDA kernel has no interpret mode: what the CPU can check is the
wrapper around it (operand packing, output unpacking, result shapes, the
platform choice, the no-fallback rule) through the plain-JAX reference of
its FFI contract.  The bit-identity test at real widths carries the
``gpu`` marker and skips without a card; ``chip_smoke.py`` runs it there.

Tolerance is 0 throughout: costs are integer-valued f32 below 2^24
(kernels/banded.py), so every sum and compare is exact in any order, and
the pipeline has no matrix products, so TF32 never applies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blasr_tpu import native
from blasr_tpu.kernels import banded_cuda as bc
from blasr_tpu.kernels.banded import (
    banded_align, banded_traceback, slope_limit_offsets)
from blasr_tpu.params import MappingParams

# (name, (ins_open, ins_ext, del_open, del_ext), QV mode)
MODES = [("default", (4.0, 4.0, 5.0, 5.0), False),
         ("qv", (4.0, 4.0, 5.0, 5.0), True),
         ("affine", (14.0, 1.0, 15.0, 1.0), False)]


def random_case(seed, N, L, W, w_b=128, qv=False):
    """Reads planted on a noisy diagonal of their windows (8% insertions,
    8% deletions, 10% mismatches) and a slope-{0,1,2} band path around it;
    with ``qv``, random IDS cost tracks.  Returns banded_align's operands
    (reads, windows, offsets, qa, qb, ta, tb) and the qv1/qv2 kwargs."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    qa = rng.integers(0, 8, N).astype(np.int32)
    qb = (qa + rng.integers(L // 2, L - 8, N)).astype(np.int32)
    ta = rng.integers(1, 40, N).astype(np.int32)
    r = np.arange(L)
    active = (r[None, :] >= qa[:, None]) & (r[None, :] < qb[:, None])
    u = rng.random((N, L))
    step = np.where(u < 0.08, 0, np.where(u < 0.16, 2, 1)) * active
    # target column consumed at each row (running sum of earlier steps)
    t = np.minimum(ta[:, None] + np.cumsum(step, axis=1) - step, W - 1)
    rows_i, rows_r = np.nonzero(active & (step > 0))
    plant = rng.random(rows_i.size) < 0.9
    windows[rows_i[plant], t[rows_i, rows_r][plant]] = \
        reads[rows_i[plant], rows_r[plant]]
    tb = np.minimum(t[np.arange(N), qb - 1] + 1, W).astype(np.int32)
    center = np.minimum(ta[:, None] + np.maximum(r[None, :] - qa[:, None], 0),
                        W - 1)
    offs = np.clip(center - w_b // 2, 0, W - w_b).astype(np.int32)
    offs = np.asarray(slope_limit_offsets(jnp.asarray(offs)))
    kw = {}
    if qv:
        insq, delq, subq = (rng.integers(1, 30, (N, L)) for _ in range(3))
        dtag, stag = (rng.choice([0, 1, 2, 3, 7], (N, L)) for _ in range(2))
        kw = dict(qv1=jnp.asarray(insq | (delq << 8) | (subq << 16)
                                  | (dtag << 24) | (stag << 27), jnp.int32),
                  qv2=jnp.asarray(np.full((N, L), 13 | (20 << 8)), jnp.int32))
    args = tuple(jnp.asarray(a)
                 for a in (reads, windows, offs, qa, qb, ta, tb))
    return args, kw


def submat():
    p = MappingParams().make_sane()
    return jnp.asarray(np.asarray(p.score_matrix, np.float32).reshape(25))


def assert_same_alignments(ref, out, args, t_max):
    """valid, score, final_state and traceback pairs bit-identical."""
    for f in ("valid", "score", "final_state"):
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(out, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f
    offs, qa, qb, ta, tb = args[2:7]
    t1 = banded_traceback(ref, offs, qa, qb, ta, tb, t_max=t_max)
    t2 = banded_traceback(out, offs, qa, qb, ta, tb, t_max=t_max)
    for f in t1._fields:
        assert np.array_equal(np.asarray(getattr(t1, f)),
                              np.asarray(getattr(t2, f))), f


@pytest.mark.parametrize("platform,kernel", [("gpu", "cuda"), ("cpu", "xla")])
def test_dp_kernel_follows_platform(platform, kernel):
    assert bc.dp_kernel_for(platform) == kernel


def test_gpu_choice_without_library_raises(monkeypatch, tmp_path):
    """On a GPU the pipeline takes the CUDA kernel, and a library that
    cannot be built is an error, never a quiet fall back to XLA."""
    from blasr_tpu.pipeline.map_read import DeviceIndex, map_batch
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(bc, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(bc, "_registered", False)
    with pytest.raises(RuntimeError, match="no fallback"):
        bc.load_library()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    from __graft_entry__ import _small_world, _static_cfg
    gi, reads, lens = _small_world(glen=20_000, n_reads=2, L=256)
    static = _static_cfg(256, 640)
    static.update(C=3)  # a shape no other test traces (no jit cache hit)
    gaps = jnp.asarray([4.0, 4.0, 5.0, 5.0], jnp.float32)
    dev = DeviceIndex.from_host(gi)
    with pytest.raises(RuntimeError, match="no fallback"):
        jax.eval_shape(functools.partial(map_batch, **static), dev,
                       jnp.asarray(reads), jnp.asarray(lens), submat(), gaps)


@pytest.mark.parametrize("N", [1, 5, 8, 13])
def test_packing_round_trip(N):
    """pack -> FFI operand layout -> unpack reproduces banded_align for
    batch sizes that fill no whole block of warps, and those that do."""
    args, _ = random_case(100 + N, N, 128, 384)
    gaps = (4.0, 4.0, 5.0, 5.0)
    ref = banded_align(*args, submat(), *gaps, w_b=128)
    out = bc.align_with(bc.reference_banded_dp, *args, submat(), *gaps)
    assert_same_alignments(ref, out, args, t_max=128 + 384)


def test_packing_round_trip_qv():
    args, kw = random_case(7, 6, 128, 384, qv=True)
    gaps = (4.0, 4.0, 5.0, 5.0)
    ref = banded_align(*args, submat(), *gaps, w_b=128, **kw)
    out = bc.align_with(bc.reference_banded_dp, *args, submat(), *gaps, **kw)
    assert_same_alignments(ref, out, args, t_max=128 + 384)


def test_packed_operands():
    args, _ = random_case(3, 4, 64, 256)
    reads, _, offs, qa, qb, ta, tb = args
    rows, spans, costs = bc.pack_inputs(reads, offs, qa, qb, ta, tb,
                                        submat(), 1.0, 2.0, 3.0, 4.0)
    assert rows.dtype == jnp.int32 and spans.shape == (4, 4)
    assert np.array_equal(np.asarray(rows >> 3), np.asarray(offs))
    assert np.array_equal(np.asarray(rows & 7), np.asarray(reads))
    assert np.array_equal(np.asarray(spans),
                          np.stack([qa, qb, ta, tb], axis=1))
    assert costs.shape == (32,)
    assert list(np.asarray(costs[25:])) == [1.0, 2.0, 3.0, 4.0, 0, 0, 0]


@pytest.mark.parametrize("qv", [False, True], ids=["flat", "qv"])
def test_ffi_call_shapes_match_xla(qv):
    N, L, W = 640, 2048, 3072
    i32 = jax.ShapeDtypeStruct((N,), jnp.int32)
    shapes = (jax.ShapeDtypeStruct((N, L), jnp.int8),
              jax.ShapeDtypeStruct((N, W), jnp.int8),
              jax.ShapeDtypeStruct((N, L), jnp.int32), i32, i32, i32, i32,
              jax.ShapeDtypeStruct((25,), jnp.float32))
    kw = {}
    if qv:
        kw = dict(qv1=jax.ShapeDtypeStruct((N, L), jnp.int32),
                  qv2=jax.ShapeDtypeStruct((N, L), jnp.int32))
    gaps = (4.0, 4.0, 5.0, 5.0)

    def via(kernel):
        return jax.eval_shape(
            lambda *a, **k: bc.align_with(kernel, *a, *gaps, **k),
            *shapes, **kw)

    assert via(bc.ffi_banded_dp) == jax.eval_shape(
        lambda *a, **k: banded_align(*a, *gaps, w_b=128, **k), *shapes, **kw)
    assert via(bc.ffi_banded_dp) == via(bc.reference_banded_dp)


def test_band_width_other_than_128_is_refused():
    args, _ = random_case(1, 2, 64, 256)
    with pytest.raises(ValueError, match="128"):
        bc.align_with(bc.reference_banded_dp, *args, submat(),
                      4.0, 4.0, 5.0, 5.0, w_b=64)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [m[0] for m in MODES])
def test_cuda_kernel_bit_identical_at_real_width(mode):
    """N = 640 alignments (2 strands x 32 reads x 10 candidates) of the
    2048 bucket, w_b = 128, W = 3072: the CUDA kernel against banded_align
    on the card, tolerance 0."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    _, gaps, qv = next(m for m in MODES if m[0] == mode)
    args, kw = random_case(2048, 640, 2048, 3072, qv=qv)
    ref = banded_align(*args, submat(), *gaps, w_b=128, **kw)
    out = bc.cuda_banded_align(*args, submat(), *gaps, w_b=128, **kw)
    assert_same_alignments(ref, out, args, t_max=2048 + 3072)
