"""Multi-device tests on the virtual 8-CPU mesh: data-parallel equivalence
and reference-sharded mapping (SURVEY.md §2.9 device-mesh parallelism)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blasr_tpu.dist.mesh import (
    make_mesh, map_batch_data_parallel, map_batch_ref_sharded, shard_index)
from blasr_tpu.index import build_genome_index
from blasr_tpu.params import MappingParams, ShapeConfig
from blasr_tpu.pipeline.map_read import DeviceIndex, map_batch, unpack_batch
from blasr_tpu.sim import random_genome, simulate_reads


def setup_world(B, L, glen=50_000):
    contigs = random_genome(glen, seed=21)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, B, read_len=(150, L - 30), accuracy=0.9,
                          seed=22)
    reads = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(sims):
        n = min(len(s.rec.seq), L)
        reads[i, :n] = s.rec.seq[:n]
        lens[i] = n
    p = MappingParams().make_sane()
    submat = jnp.asarray(np.asarray(p.score_matrix, np.float32).reshape(25))
    gaps = jnp.asarray([4, 4, 5, 5], jnp.float32)
    cfg = ShapeConfig(buckets=(L,), band_width=128)
    static = dict(cfg_k=12, L=L, W=cfg.window_len(L), w_b=128, C=4, A=64,
                  O=4, E=36, T=L + cfg.window_len(L), max_chain=64,
                  min_match=12, max_anchors_per_pos=1000, max_lcp=0,
                  indel_rate=0.3)
    return gi, sims, reads, lens, submat, gaps, static


def test_requires_8_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"


def test_data_parallel_matches_single_device():
    B, L = 8, 256
    gi, sims, reads, lens, submat, gaps, static = setup_world(B, L)
    dev = DeviceIndex.from_host(gi)
    ref = map_batch(dev, jnp.asarray(reads), jnp.asarray(lens), submat,
                    gaps, **static)
    mesh = make_mesh(4, 1)
    with mesh:
        out = map_batch_data_parallel(
            mesh, dev, jnp.asarray(reads), jnp.asarray(lens), submat, gaps,
            **static)
    ref_h, out_h = unpack_batch(ref), unpack_batch(out)
    np.testing.assert_array_equal(ref_h.score, out_h.score)
    np.testing.assert_array_equal(ref_h.t_start, out_h.t_start)
    np.testing.assert_array_equal(ref_h.ops, out_h.ops)


def test_shard_index_covers_genome():
    contigs = random_genome(30_000, seed=3)
    gi = build_genome_index(contigs, k=12)
    genomes, keys, pos, offs = shard_index(gi, 4, overlap=500)
    assert genomes.shape[0] == 4
    assert offs.dtype == np.int64
    # every genome position with a valid kmer appears in >= 1 shard
    # (positions are shard-local; globalize with the int64 offsets)
    all_pos = set()
    for s in range(4):
        valid = keys[s] != np.uint32(0xFFFFFFFF)
        all_pos.update((pos[s][valid].astype(np.int64) + offs[s]).tolist())
    assert len(all_pos) >= len(gi.pos_sorted)  # overlap adds duplicates


def test_shard_index_fast_path_arrays():
    """The per-shard fast-path arrays must match what a replicated
    DeviceIndex builds for the same slice (VERDICT r2 item 3: the sharded
    path ran the slow anchor fallback)."""
    contigs = random_genome(30_000, seed=3)
    gi = build_genome_index(contigs, k=12)
    genomes, keys, pos, offs, fast = shard_index(gi, 2, overlap=500,
                                                 fast_path=True)
    for s in range(2):
        valid = keys[s] != np.uint32(0xFFFFFFFF)
        m = int(valid.sum())
        # LUT brackets: bucket_starts[key] .. bucket_starts[key+1] spans
        # exactly the slots holding that key
        bs = fast["bucket_starts"][s]
        ks = keys[s][:m]
        for key in np.unique(ks[:200]):
            lo, hi = int(bs[int(key)]), int(bs[int(key) + 1])
            assert (ks[lo:hi] == key).all() and hi - lo >= 1
        # records column 0 is the sentinel-shifted local position
        np.testing.assert_array_equal(
            fast["pos_records"][s][:m, 0].astype(np.int64),
            pos[s][:m].astype(np.int64) + 1)
        # packed words agree with a from-scratch build over the slice
        from blasr_tpu.index.genome import build_packed_words
        gl = len(gi.genome)
        lo = int(offs[s])
        hi = min(gl, lo + (-(-gl // 2)) + 500)
        gsent = np.concatenate([np.full(1, 4, np.int8),
                                gi.genome[lo:hi].astype(np.int8)])
        gw, gn = build_packed_words(gsent)
        np.testing.assert_array_equal(fast["gwords"][s][: len(gw)], gw)
        np.testing.assert_array_equal(fast["gnwords"][s][: len(gn)], gn)


def test_ref_sharded_finds_same_best_hits():
    B, L = 8, 256
    gi, sims, reads, lens, submat, gaps, static = setup_world(B, L)
    dev = DeviceIndex.from_host(gi)
    ref = map_batch(dev, jnp.asarray(reads), jnp.asarray(lens), submat,
                    gaps, **static)
    mesh = make_mesh(2, 2)
    with mesh:
        out, offs, n_dp = map_batch_ref_sharded(mesh, gi, reads, lens,
                                                submat, gaps, **static)
    # rows come back per data-shard [fwd, rc] interleaved; reconstruct
    n_data = 2
    Bl = B // n_data
    row_map = {}
    for d in range(n_data):
        for i in range(Bl):
            row_map[d * Bl + i] = d * 2 * Bl + i            # fwd
            row_map[B + d * Bl + i] = d * 2 * Bl + Bl + i    # rc
    ref_np = unpack_batch(ref)
    out_np = unpack_batch(out)
    matched = 0
    for r in range(2 * B):
        if not ref_np.valid[r].any():
            continue
        rbest = ref_np.score[r][ref_np.valid[r]].min()
        obest = out_np.score[row_map[r]][out_np.valid[row_map[r]]].min() \
            if out_np.valid[row_map[r]].any() else None
        if obest is not None and obest <= rbest:
            matched += 1
    total = sum(1 for r in range(2 * B) if ref_np.valid[r].any())
    assert matched >= total * 0.9, f"{matched}/{total}"


def test_ref_sharded_boundary_reads_and_global_coords():
    """Reads straddling a shard cut must be recovered via the overlap, and
    globalize_sharded must reproduce the replicated run's coordinates
    (int64; VERDICT r2 item 3)."""
    from blasr_tpu.dist.mesh import globalize_sharded

    B, L = 8, 256
    contigs = random_genome(50_000, seed=21)
    gi = build_genome_index(contigs, k=12)
    n_ref = 2
    # place every read across the (overlap-free) shard cut at ceil(G/2)
    cut = -(-len(gi.genome) // n_ref)
    rng = np.random.default_rng(5)
    reads = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    truth = []
    for i in range(B):
        start = cut - 100 - int(rng.integers(0, 60))
        seq = gi.genome[start:start + 220].copy()
        reads[i, : len(seq)] = seq
        lens[i] = len(seq)
        truth.append(start)
    p = MappingParams().make_sane()
    submat = jnp.asarray(np.asarray(p.score_matrix, np.float32).reshape(25))
    gaps = jnp.asarray([4, 4, 5, 5], jnp.float32)
    cfg = ShapeConfig(buckets=(L,), band_width=128)
    static = dict(cfg_k=12, L=L, W=cfg.window_len(L), w_b=128, C=4, A=64,
                  O=4, E=36, T=L + cfg.window_len(L), max_chain=64,
                  min_match=12, max_anchors_per_pos=1000, max_lcp=0,
                  indel_rate=0.3)
    mesh = make_mesh(2, n_ref)
    with mesh:
        out, offs, n_dp = map_batch_ref_sharded(mesh, gi, reads, lens,
                                                submat, gaps, **static)
    res = unpack_batch(out)
    ts, te = globalize_sharded(res, offs, n_dp)
    assert ts.dtype == np.int64
    # rows per data shard: [fwd x B/2, rc x B/2]
    n_data, Bl = 2, B // 2
    found = 0
    for d in range(n_data):
        for i in range(Bl):
            row = d * 2 * Bl + i
            ok = res.valid[row] & (res.dp_slot[row] >= 0)
            if not ok.any():
                continue
            best = int(np.argmin(np.where(ok, res.score[row], 1 << 30)))
            t0 = int(ts[row][best])
            if abs(t0 - truth[d * Bl + i]) <= 50:
                found += 1
    assert found >= int(B * 0.9), f"boundary reads found: {found}/{B}"


def test_globalize_sharded_exact_past_int32():
    """Host-side globalization stays exact beyond 2^31 (the reference's
    4 Gbp / 32-bit SA ceiling, utils/SAWriter.cpp:186-193): shard-local
    int32 coords + int64 shard offsets from a >4 Gbp virtual layout."""
    from types import SimpleNamespace

    from blasr_tpu.dist.mesh import globalize_sharded

    n_dp = 8
    # shard offsets for a 4.8 Gbp genome in 8 slices of 600 Mbp
    offs = np.arange(8, dtype=np.int64) * 600_000_000
    # candidates: (row, cand) grid; slots place cand c of row r on shard c
    slot = np.tile(np.arange(4, dtype=np.int32) * n_dp + 1, (2, 1))
    slot[1, 2] = -1                       # one unaligned candidate
    ts_local = np.full((2, 4), 2_000_000, dtype=np.int32)
    te_local = ts_local + 1500
    res = SimpleNamespace(dp_slot=slot, t_start=ts_local, t_end=te_local)
    ts, te = globalize_sharded(res, offs, n_dp)
    assert ts.dtype == np.int64 and te.dtype == np.int64
    want = offs[:4] + 2_000_000
    np.testing.assert_array_equal(ts[0], want)
    np.testing.assert_array_equal(te[0], want + 1500)
    assert ts[0, 3] == 1_802_000_000 and int(te[0, 3]) > 0
    # shard 7's coordinates exceed int32 and stay exact
    res2 = SimpleNamespace(
        dp_slot=np.full((1, 1), 7 * n_dp, np.int32),
        t_start=np.full((1, 1), 3_000_000, np.int32),
        t_end=np.full((1, 1), 3_001_500, np.int32))
    ts2, te2 = globalize_sharded(res2, offs, n_dp)
    assert int(ts2[0, 0]) == 4_203_000_000   # > 2^31: int32 would wrap
    assert int(te2[0, 0]) == 4_203_001_500
    # the unaligned candidate keeps its local value un-offset
    assert ts[1, 2] == 2_000_000
