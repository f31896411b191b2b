"""Multi-device mapping: data-parallel reads and reference-sharded genomes.

Device-mesh replacement for the reference's parallelism stack (SURVEY.md
§2.9): pthreads + semaphores become a ``jax.sharding.Mesh`` with a ``data``
axis (reads; the --nproc/--stride analog) and a ``ref`` axis (genome
shards; the automated version of the reference's documented
"split reference into multiple files and merge results" guidance for
>4 Gbp genomes, utils/SAWriter.cpp:186-193).

  * data axis: the batch dimension of ``map_batch`` is sharded; XLA
    partitions every kernel with no communication (reads are independent).
  * ref axis: each shard holds a contiguous genome slice + its k-mer
    index; every read runs the full anchor->chain->align pipeline against
    the local slice; per-shard candidate alignments are then
    ``all_gather``-ed over the ref axis and the global best selected —
    deterministically, since scores are integers and ties break on
    (shard, candidate) order.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from blasr_tpu.index.genome import GenomeIndex, build_kmer_index
from blasr_tpu.pipeline.map_read import (
    COL_DPSLOT, COL_NANCH, COL_NCLIP, COL_SCORE, COL_VALID, N_COLS,
    DeviceIndex, PackedBatch, map_batch)


def make_mesh(n_data: int, n_ref: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_ref, (
        f"need {n_data * n_ref} devices, have {len(devices)}")
    arr = np.array(devices[: n_data * n_ref]).reshape(n_data, n_ref)
    return Mesh(arr, ("data", "ref"))


def map_batch_data_parallel(mesh: Mesh, index: DeviceIndex, reads, read_len,
                            submat, gap_costs, **static):
    """Pure data parallelism: reads sharded over the 'data' axis, index
    replicated.  XLA inserts no collectives — the per-read pipeline is
    embarrassingly parallel, like the reference's per-ZMW thread loop."""
    dshard = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    reads = jax.device_put(reads, dshard)
    read_len = jax.device_put(read_len, dshard)
    index = jax.tree.map(lambda x: jax.device_put(x, repl), index)
    return map_batch(index, reads, read_len,
                     jax.device_put(submat, repl),
                     jax.device_put(gap_costs, repl), **static)


def shard_index(gi: GenomeIndex, n_shards: int, overlap: int = 65536,
                fast_path: bool = False):
    """Split the genome into n_shards contiguous slices (with right-overlap
    so alignments near boundaries are found by exactly one shard... the
    overlap region's anchors are indexed by the left shard only up to
    slice end; candidates crossing the cut are recovered by the overlap).

    Returns stacked per-shard arrays, padded to common sizes:
      genomes  int8  [S, Gs]
      keys     uint32[S, Ms]
      pos      int32 [S, Ms]  (positions are *shard-local* slice
               coordinates — int32-safe no matter the global genome size;
               globalization happens on the host via ``offsets``)
      offsets  int64 [S]      global start of each slice

    With ``fast_path=True`` additionally returns a dict of the anchor
    fast-path arrays (the same ones DeviceIndex.from_host builds for the
    replicated index): per-shard direct LUT ``bucket_starts``
    [S, 4^k+1], packed words ``gwords``/``gnwords`` [S, Gs+1], and fused
    gather records ``pos_records`` [S, Ms, 6] in the sentinel-shifted
    local coordinates per_shard uses.
    """
    from blasr_tpu.index.genome import build_packed_words

    g = gi.genome
    n = len(g)
    base = -(-n // n_shards)
    assert base + overlap < 2 ** 31, (
        f"a single shard would span {base + overlap} bp >= 2^31; "
        f"raise n_shards (global coordinates stay int64-safe, but "
        f"shard-local coordinates are int32)")
    slices, offs = [], []
    for s in range(n_shards):
        lo = s * base
        hi = min(n, lo + base + overlap)
        lo_c = min(lo, n)
        slices.append(g[lo_c:hi])
        offs.append(lo_c)
    gs = max(len(x) for x in slices)
    genomes = np.full((n_shards, gs), 4, dtype=np.int8)
    keys_l, pos_l = [], []
    for s, sl in enumerate(slices):
        genomes[s, : len(sl)] = sl
        k, p = build_kmer_index(sl, gi.k)
        keys_l.append(k)
        pos_l.append(p.astype(np.int32))
    ms = max(len(k) for k in keys_l)
    keys = np.full((n_shards, ms), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    pos = np.zeros((n_shards, ms), dtype=np.int32)
    for s in range(n_shards):
        keys[s, : len(keys_l[s])] = keys_l[s]
        pos[s, : len(pos_l[s])] = pos_l[s]
    offs = np.asarray(offs, dtype=np.int64)
    if not fast_path:
        return genomes, keys, pos, offs

    nb = 4 ** gi.k + 1
    bucket_starts = np.zeros((n_shards, nb), dtype=np.int32)
    gwords = np.zeros((n_shards, gs + 1), dtype=np.uint32)
    gnwords = np.zeros((n_shards, gs + 1), dtype=np.uint32)
    records = np.zeros((n_shards, ms, 6), dtype=np.uint32)
    allN = np.uint32(0xFFFFFFFF)
    for s, sl in enumerate(slices):
        # padding keys are 0xFFFFFFFF > any real k-mer key, so the
        # boundary search stays inside the valid prefix
        bucket_starts[s] = np.searchsorted(
            keys[s], np.arange(nb, dtype=np.int64)).astype(np.int32)
        gsent = np.concatenate([np.full(1, 4, dtype=sl.dtype), sl])
        gw, gn = build_packed_words(gsent)
        gwords[s, : len(gw)] = gw
        gnwords[s, : len(gn)] = gn
        gnwords[s, len(gn):] = allN
        # fused gather records in sentinel-shifted local coords
        # (DeviceIndex._build_records layout)
        t = pos_l[s].astype(np.int64) + 1
        G1 = len(gsent)
        m = len(t)
        records[s, :m, 0] = t.astype(np.uint32)
        records[s, :m, 1] = gsent[np.clip(t - 1, 0, G1 - 1)].astype(np.uint32)
        for j in range(2):
            off = gi.k + 16 * j
            gidx = np.clip(t + off, 0, G1 - 1)
            records[s, :m, 2 + 2 * j] = gwords[s][gidx]
            records[s, :m, 3 + 2 * j] = np.where(
                t + off < G1, gnwords[s][gidx], allN)
        records[s, m:, 3] = allN  # padded slots extend nowhere
        records[s, m:, 5] = allN
    fast = dict(bucket_starts=bucket_starts, gwords=gwords,
                gnwords=gnwords, pos_records=records)
    return genomes, keys, pos, offs, fast


def map_batch_ref_sharded(
    mesh: Mesh,
    gi: GenomeIndex,
    reads: np.ndarray,
    read_len: np.ndarray,
    submat, gap_costs,
    **static,
):
    """Reference-sharded mapping over mesh axes (data, ref).

    Each (data, ref) device runs the full pipeline for its read shard
    against its genome shard; results are all-gathered over 'ref' and the
    global top candidates selected per read.  This is SURVEY.md §2.9's
    'index sharding' row made automatic.
    """
    n_ref = mesh.shape["ref"]
    genomes, keys, pos, offs, fast = shard_index(gi, n_ref, fast_path=True)
    starts = np.asarray(gi.seqdb.starts, np.int64)
    ends = np.asarray(gi.seqdb.starts + gi.seqdb.lengths, np.int64)

    C = static["C"]

    # contig boundaries in per-shard local coords: int64 host arithmetic,
    # clamped into each slice's range before the int32 narrowing
    gs_len = genomes.shape[1]
    lstarts = np.clip(starts[None, :] - offs[:, None], 0, gs_len
                      ).astype(np.int32)
    lends = np.clip(ends[None, :] - offs[:, None], 0, gs_len
                    ).astype(np.int32)

    def per_shard(genome_s, keys_s, pos_s, lstarts_s, lends_s, bstarts_s,
                  gw_s, gn_s, rec_s, reads_s, rlen_s):
        # strip leading shard axes added by shard_map
        genome_s = genome_s[0]
        keys_s = keys_s[0]
        pos_s = pos_s[0]
        # positions are shard-local slice coords (int32-safe no matter the
        # global genome size); outputs stay local and the host globalizes
        # with the int64 shard offsets (globalize_sharded).  A sentinel N
        # is prepended (map_batch's coordinate convention).
        genome_sent = jnp.concatenate(
            [jnp.full((1,), 4, genome_s.dtype), genome_s])
        local_pos = pos_s.astype(jnp.int32) + 1
        idx = DeviceIndex(
            genome=genome_sent,
            keys_sorted=keys_s,
            pos_sorted=local_pos,
            contig_starts=lstarts_s[0] + 1,
            contig_ends=lends_s[0] + 1,
            k=gi.k,
            bucket_starts=bstarts_s[0],
            gwords=gw_s[0],
            gnwords=gn_s[0],
            pos_records=rec_s[0],
        )
        res = map_batch(idx, reads_s, rlen_s, submat, gap_costs, **static)
        ints = res.ints
        # gather every shard's candidates, keep global top-C by score
        g_ints = jax.lax.all_gather(ints, "ref", axis=0)   # [R, 2B, C, N_COLS]
        g_ops = jax.lax.all_gather(res.ops, "ref", axis=0)

        n_shards = g_ints.shape[0]
        n_dp, t_len = res.ops.shape
        # translate per-shard dp slots into rows of the concatenated ops
        slot = g_ints[..., COL_DPSLOT]
        slot_global = jnp.where(
            slot >= 0,
            slot + jnp.arange(n_shards, dtype=jnp.int32)[:, None, None] * n_dp,
            -1)
        g_ints = g_ints.at[..., COL_DPSLOT].set(slot_global)
        nanch = jnp.sum(g_ints[..., COL_NANCH], axis=0)    # psum over shards
        nclip = jnp.sum(g_ints[..., COL_NCLIP], axis=0)
        merged = jnp.moveaxis(g_ints, 0, 1).reshape(
            g_ints.shape[1], n_shards * C, N_COLS)         # [2B, R*C, cols]
        key = jnp.where(merged[..., COL_VALID] > 0,
                        merged[..., COL_SCORE], jnp.int32(0x3FFFFFFF))
        order = jnp.argsort(key, axis=1, stable=True)[:, :C]
        top = jnp.take_along_axis(merged, order[..., None], axis=1)
        top = top.at[..., COL_NANCH].set(nanch[:, :1])
        top = top.at[..., COL_NCLIP].set(nclip[:, :1])
        # merge cluster lists: union over shards, keep the heaviest
        # gate-passing clusters (ClusterList analog stays fixed-width)
        g_cl = jax.lax.all_gather(res.clusters, "ref", axis=0)
        c_stat = res.clusters.shape[1]
        mcl = jnp.moveaxis(g_cl, 0, 1).reshape(
            g_cl.shape[1], n_shards * c_stat, 2)
        ckey = jnp.where(mcl[..., 1] > 0, -mcl[..., 0],
                         jnp.int32(0x3FFFFFFF))
        corder = jnp.argsort(ckey, axis=1, stable=True)[:, :c_stat]
        top_cl = jnp.take_along_axis(mcl, corder[..., None], axis=1)
        return PackedBatch(ints=top, ops=g_ops.reshape(n_shards * n_dp, t_len),
                           clusters=top_cl)

    from jax import shard_map
    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("ref"), P("ref"), P("ref"), P("ref"), P("ref"),
                  P("ref"), P("ref"), P("ref"), P("ref"),
                  P("data"), P("data")),
        out_specs=P("data"),
        check_vma=False,
    )
    out = fn(jnp.asarray(genomes), jnp.asarray(keys), jnp.asarray(pos),
             jnp.asarray(lstarts), jnp.asarray(lends),
             jnp.asarray(fast["bucket_starts"]),
             jnp.asarray(fast["gwords"]), jnp.asarray(fast["gnwords"]),
             jnp.asarray(fast["pos_records"]),
             jnp.asarray(reads), jnp.asarray(read_len))
    # per-(data,ref)-shard traceback rows: dp_slot values are local to a
    # data shard's block and stride by this over the ref axis
    n_dp = out.ops.shape[0] // (n_ref * mesh.shape["data"])
    return out, offs, n_dp


def globalize_sharded(result, offs: np.ndarray, n_dp: int):
    """Host-side coordinate globalization for map_batch_ref_sharded
    results: per-shard local t coordinates + the producing shard's int64
    offset (shard = dp_slot // n_dp — every collected candidate has a
    traceback slot; slotless ones are dropped at collection, as on the
    replicated path).  Returns int64 (t_start, t_end) arrays — exact past
    the reference's 4 Gbp / int32 limit (utils/SAWriter.cpp:186-193)."""
    slot = result.dp_slot
    shard = np.where(slot >= 0, slot // max(n_dp, 1), 0)
    off = np.asarray(offs, np.int64)[shard]
    ts = result.t_start.astype(np.int64) + np.where(slot >= 0, off, 0)
    te = result.t_end.astype(np.int64) + np.where(slot >= 0, off, 0)
    return ts, te


def placement_parity(rep, res, ts, te, n_data: int):
    """Per read, does the sharded run ``res`` (an unpacked
    ``map_batch_ref_sharded`` result with global coordinates ``ts``/``te``)
    place it where the replicated single-device run ``rep`` does?  The
    criterion: same winning strand, sharded score within +16 of the
    replicated one, and >50% overlap of the target intervals.  Per-row
    score equality is the wrong contract: each shard spends its full
    anchor budget on 1/n_ref of the genome.  Sharded rows are laid out
    per data shard as [fwd x B/n_data, rc x B/n_data].  Returns
    (reads that agree, reads the replicated run maps)."""
    B = rep.score.shape[0] // 2
    Bl = B // n_data
    row_map = {}
    for d in range(n_data):
        for i in range(Bl):
            row_map[d * Bl + i] = d * 2 * Bl + i             # fwd rows
            row_map[B + d * Bl + i] = d * 2 * Bl + Bl + i    # rc rows

    def best(valid, score, row):
        ok = np.asarray(valid[row])
        if not ok.any():
            return None, None
        sc = np.where(ok, np.asarray(score[row]), 1 << 30)
        j = int(np.argmin(sc))
        return j, float(sc[j])

    checked = agree = 0
    for r in range(B):  # per read: compare the winning strand row
        cand = []
        for row in (r, B + r):
            j, sc = best(rep.valid, rep.score, row)
            if j is not None:
                cand.append((sc, row, j))
        if not cand:
            continue
        checked += 1
        rsc, rrow, rj = min(cand)
        scand = []
        for row in (r, B + r):
            srow = row_map[row]
            j, sc = best(res.valid, res.score, srow)
            if j is not None:
                scand.append((sc, row, srow, j))
        if not scand:
            continue
        ssc, srow_logical, srow, sj = min(scand)
        if srow_logical != rrow or ssc > rsc + 16:
            continue
        a0, a1 = int(rep.t_start[rrow][rj]), int(rep.t_end[rrow][rj])
        b0, b1 = int(ts[srow][sj]), int(te[srow][sj])
        inter = min(a1, b1) - max(a0, b0)
        if inter > 0.5 * min(a1 - a0, b1 - b0):
            agree += 1
    return agree, checked
