"""End-to-end batched mapping pipeline (the reference's ``MapRead``,
iblasr/BlasrAlignImpl.hpp:4-505, re-shaped for fixed-shape device batches).

One jitted function takes a fixed-shape batch of reads plus the device
genome index and runs: anchor search -> chain/cluster -> candidate windows
-> guided banded affine DP -> traceback + stats, for both strands.  The
host wrapper (:class:`Mapper`) handles length bucketing, strand/coordinate
bookkeeping, CIGAR building, filtering, mapQV and hit policy.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from blasr_tpu.index.genome import GenomeIndex
from blasr_tpu.io.fasta import FastaRecord
from blasr_tpu.kernels.anchor import find_anchors, read_kmer_keys
from blasr_tpu.kernels.banded import (
    banded_align, banded_traceback, slope_limit_offsets)
from blasr_tpu.kernels.banded_cuda import cuda_banded_align, dp_kernel_for
from blasr_tpu.kernels.chain import chain_anchors, chain_members
from blasr_tpu.params import MappingParams, ShapeConfig

BIG32 = 0x3FFFFFFF

# bucket shapes already AOT-compiled by Mapper.warmup (module-level: the
# jit cache is shared across Mapper instances, re-tracing is not)
_WARMED_SHAPES: set = set()


@functools.partial(
    jax.jit,
    static_argnames=("k", "build_lut", "build_pairs", "build_records"))
def _derive_index(gsent, pos_raw, *, k: int, build_lut: bool,
                  build_pairs: bool, build_records: bool):
    """Derive every index array from (genome, pos_sorted) on device.

    Each output is bit-identical to its host-built counterpart
    (tests/test_device_index.py): packed extension words reproduce
    ``index.genome.build_packed_words``, the gathered keys equal
    ``keys_sorted`` because every pos_sorted slot is a valid k-window,
    and the LUT counts+cumsum equals ``build_bucket_starts``'s
    run-length scatter.  One dispatch instead of ~260 MB of host->device
    transfers.
    """
    G = gsent.shape[0]
    g32 = gsent.astype(jnp.int32)

    def shifted(j):
        if j == 0:
            return g32
        return jnp.concatenate([g32[j:], jnp.full((j,), 4, jnp.int32)])

    gw = jnp.zeros(G, jnp.uint32)
    gn = jnp.zeros(G, jnp.uint32)
    for j in range(16):
        sh = shifted(j)
        gw = gw | ((sh & 3).astype(jnp.uint32) << (2 * j))
        gn = gn | (jnp.where(sh >= 4, jnp.uint32(3), jnp.uint32(0))
                   << (2 * j))
    keys = jnp.zeros(G, jnp.uint32)
    for j in range(k):
        keys = (keys << 2) | (shifted(j) & 3).astype(jnp.uint32)
    pos_d = pos_raw.astype(jnp.int32) + 1
    keys_sorted = jnp.take(keys, pos_d)
    bucket_starts = bucket_pairs = records = None
    if build_lut:
        nb = 1 << (2 * k)
        counts = jnp.zeros(nb + 1, jnp.int32)
        counts = counts.at[keys_sorted.astype(jnp.int32) + 1].add(
            1, mode="drop")
        bucket_starts = jnp.cumsum(counts, dtype=jnp.int32)
        if build_pairs:
            bucket_pairs = jnp.stack(
                [bucket_starts[:-1], bucket_starts[1:]], axis=1)
    if build_records:
        records = DeviceIndex._build_records(gsent, pos_d, gw, gn, k)
    return keys_sorted, bucket_starts, bucket_pairs, gw, gn, records, pos_d


class DeviceIndex(NamedTuple):
    """Genome index resident on device (replicated or per-shard slice)."""

    genome: jnp.ndarray         # int8 [G]
    keys_sorted: jnp.ndarray    # uint32 [M]
    pos_sorted: jnp.ndarray     # int32 [M]
    contig_starts: jnp.ndarray  # int32 [n_contigs]
    contig_ends: jnp.ndarray    # int32 [n_contigs]
    k: int
    bucket_starts: Optional[jnp.ndarray] = None  # int32 [4^k+1] direct LUT
    # [4^k, 2] rows (start, end) of the same LUT: ONE row-gather per read
    # position instead of two scattered element gathers — the anchor stage
    # is gather-latency-bound and the paired load halves its largest cost
    bucket_pairs: Optional[jnp.ndarray] = None
    gwords: Optional[jnp.ndarray] = None   # uint32 [G] packed 16-base words
    gnwords: Optional[jnp.ndarray] = None  # uint32 [G] non-ACGT bit pairs
    # per-SA-slot gather records [M, 6] uint32: (t, genome[t-1],
    # gwords[t+k], gnwords[t+k], gwords[t+k+16], gnwords[t+k+16]) — one
    # contiguous 24-byte row replaces 6 scattered 4-byte gathers in the
    # anchor hot path (random device-memory accesses fetch a line either
    # way)
    pos_records: Optional[jnp.ndarray] = None

    # build records only while the memory cost (24 B/slot) stays modest;
    # beyond this find_anchors falls back to the separate gathers
    RECORDS_MAX_SLOTS = 1 << 26

    # pad rows appended to pos_records so a block gather of up to
    # RECORDS_PAD consecutive slots never clips valid rows at table end
    # (kernels.anchor occ_block_sample; pad rows are all-N/invalid)
    RECORDS_PAD = 1024

    @staticmethod
    def _build_records(genome, pos_sorted, gw, gn, k: int):
        G = genome.shape[0]
        pos = pos_sorted
        recs = [pos.astype(jnp.uint32),
                jnp.take(genome, jnp.clip(pos - 1, 0, G - 1)
                         ).astype(jnp.uint32)]
        allN = jnp.uint32(0xFFFFFFFF)
        for j in range(2):
            off = k + 16 * j
            gidx = jnp.clip(pos + off, 0, G - 1)
            recs.append(jnp.take(gw, gidx))
            recs.append(jnp.where(pos + off < G, jnp.take(gn, gidx), allN))
        table = jnp.stack(recs, axis=1)
        pad = jnp.zeros((DeviceIndex.RECORDS_PAD, table.shape[1]),
                        table.dtype).at[:, 2:].set(allN)
        return jnp.concatenate([table, pad], axis=0)

    @staticmethod
    def from_host(gi: GenomeIndex) -> "DeviceIndex":
        # one sentinel N is prepended so every genome coordinate is >= 1:
        # the banded DP needs its boundary cell at ta-1 to be addressable
        # even for alignments starting at the very first contig base.
        # map_batch subtracts the offset from its outputs.
        sentinel = np.full(1, 4, dtype=gi.genome.dtype)
        gsent = np.concatenate([sentinel, gi.genome])
        genome_d = jnp.asarray(gsent)
        contig_s = jnp.asarray(gi.seqdb.starts, dtype=jnp.int32) + 1
        contig_e = jnp.asarray(
            gi.seqdb.starts + gi.seqdb.lengths, dtype=jnp.int32) + 1
        build_records = gi.pos_sorted.shape[0] <= DeviceIndex.RECORDS_MAX_SLOTS
        build_lut = gi.bucket_starts is not None
        # paired rows double the LUT footprint; worth it only while
        # the table is small (k=14 large-genome LUTs would pay 2 GB
        # of device memory for one gather per read position)
        build_pairs = build_lut and gi.bucket_starts.shape[0] <= (1 << 25)
        if (gi.pos_sorted.dtype == np.int32 and gi.k <= 16
                and gi.glen <= (1 << 27)
                and not getattr(gi, "synthetic_kmer_rows", False)):
            # warm-start path: transfer ONLY genome + pos_sorted (~1/12 the
            # bytes) and derive every other array on device in one jitted
            # dispatch instead of transferring the full 280 MB k=12/4.6 Mbp
            # index.
            # Bounded to glen <= 128 Mbp: at 200 Mbp the derive's live-
            # buffer peak (several [G] int32 temporaries + the k=14 LUT
            # scatter+cumsum tables) exhausted device memory next to a second
            # index's residency (soak builds a k=14 + k=12 pair), so
            # genome-scale indexes keep the host-transfer path below.
            # Big-k LUTs (k=14: 268M buckets, >1 GB table) are also NOT
            # derived on device — those transfer the host table.
            derive_lut = build_lut and (1 << (2 * gi.k)) <= (1 << 25)
            keys_d, bs_d, bp_d, gw_d, gn_d, rec_d, pos_d = _derive_index(
                genome_d, jnp.asarray(gi.pos_sorted), k=gi.k,
                build_lut=derive_lut, build_pairs=build_pairs,
                build_records=build_records)
            if build_lut and not derive_lut:
                bs_d = jnp.asarray(gi.bucket_starts)
            if gi.glen >= (1 << 26):
                # multi-GB derive: synchronize so a second index's derive
                # can't overlap it on device (their peaks don't co-fit)
                keys_d.block_until_ready()
            return DeviceIndex(
                genome=genome_d, keys_sorted=keys_d, pos_sorted=pos_d,
                contig_starts=contig_s, contig_ends=contig_e, k=gi.k,
                bucket_starts=bs_d, bucket_pairs=bp_d,
                gwords=gw_d, gnwords=gn_d, pos_records=rec_d)
        # fallback (int64 positions / k > 16): host-built arrays transferred
        from blasr_tpu.index.genome import build_packed_words
        gw, gn = build_packed_words(gsent)
        pos_d = jnp.asarray(gi.pos_sorted) + 1
        gw_d, gn_d = jnp.asarray(gw), jnp.asarray(gn)
        records = None
        if build_records:
            records = DeviceIndex._build_records(
                genome_d, pos_d, gw_d, gn_d, gi.k)
        return DeviceIndex(
            genome=genome_d,
            keys_sorted=jnp.asarray(gi.keys_sorted),
            pos_sorted=pos_d,
            contig_starts=contig_s,
            contig_ends=contig_e,
            k=gi.k,
            bucket_starts=(jnp.asarray(gi.bucket_starts)
                           if build_lut else None),
            bucket_pairs=(jnp.asarray(
                np.stack([gi.bucket_starts[:-1], gi.bucket_starts[1:]],
                         axis=1))
                if build_pairs else None),
            gwords=gw_d,
            gnwords=gn_d,
            pos_records=records,
        )


# column indices of PackedBatch.ints
(COL_VALID, COL_QA, COL_QB, COL_TS, COL_TE, COL_NMATCH, COL_NMIS, COL_NINS,
 COL_NDEL, COL_DPSLOT, COL_SCORE, COL_CHSCORE, COL_CHANCH, COL_NANCH,
 COL_CVALID, COL_OVF, COL_NCLIP) = range(17)
N_COLS = 17


class PackedBatch(NamedTuple):
    """Device-side result of map_batch, packed for cheap host transfer."""

    ints: jnp.ndarray       # int32 [2B, C, N_COLS] columns per COL_*
    ops: jnp.ndarray        # int32 [N_tb, P/2] RL traceback pairs
    #                         (kernels.banded.TracebackResult.pairs)
    clusters: jnp.ndarray   # int32 [2B, C_stat, 2] (chain weight, gate ok):
    #                         the ClusterList analog, deeper than C so
    #                         numSignificantClusters can exceed nCandidates
    flat: Optional[jnp.ndarray] = None  # int32 [*]: ints+clusters+ops in
    #                         one buffer — a single device->host transfer


class BatchResult(NamedTuple):
    """Host view of a PackedBatch (strand rows are [fwd x B, rc x B];
    scores are integer-valued, carried through the int32 block)."""

    score: np.ndarray       # [2B, C]
    valid: np.ndarray       # bool [2B, C]
    q_start: np.ndarray     # [2B, C] strand-local read coords
    q_end: np.ndarray       # [2B, C]
    t_start: np.ndarray     # [2B, C] forward-genome coords
    t_end: np.ndarray       # [2B, C]
    n_match: np.ndarray     # [2B, C]
    n_mismatch: np.ndarray
    n_ins: np.ndarray
    n_del: np.ndarray
    ops: np.ndarray         # int32 [N_tb, P/2] RL traceback pairs
    dp_slot: np.ndarray     # [2B, C] row into ops, -1 if not aligned
    chain_score: np.ndarray   # [2B, C] anchor-chain weight
    chain_anchors: np.ndarray  # [2B, C]
    n_anchors: np.ndarray      # [2B] anchors found on this strand
    chain_valid: np.ndarray    # bool [2B, C] candidate passed the
    #                            significance gate (ClusterList entry)
    cluster_bases: np.ndarray  # [2B, C_stat] chain weight per examined
    #                            cluster (ClusterList.numBases analog)
    cluster_valid: np.ndarray  # bool [2B, C_stat]
    overflow: np.ndarray       # bool [2B, C]: traceback pair capacity
    #                            exceeded — rerun the batch with tb_cap=T
    n_clipped: np.ndarray      # [2B] seed occurrences dropped by the
    #                            occ-per-position cap (ambiguity signal)


def unpack_batch(pb: PackedBatch) -> BatchResult:
    """Fetch a PackedBatch to host numpy and expand the column block.
    When the fused buffer is present, ONE transfer covers everything."""
    if pb.flat is not None:
        buf = np.asarray(pb.flat)
        n_i = int(np.prod(pb.ints.shape))
        n_c = int(np.prod(pb.clusters.shape))
        ints = buf[:n_i].reshape(pb.ints.shape)
        clusters = buf[n_i:n_i + n_c].reshape(pb.clusters.shape)
        ops = buf[n_i + n_c:].reshape(pb.ops.shape)
    else:
        ints = np.asarray(pb.ints)
        ops = np.asarray(pb.ops)
        clusters = np.asarray(pb.clusters)
    c = [ints[..., i] for i in range(ints.shape[-1])]
    return BatchResult(
        score=c[10].astype(np.float32), valid=c[0] > 0,
        q_start=c[1], q_end=c[2], t_start=c[3], t_end=c[4],
        n_match=c[5], n_mismatch=c[6], n_ins=c[7], n_del=c[8],
        ops=ops, dp_slot=c[9], chain_score=c[11].astype(np.float32),
        chain_anchors=c[12], n_anchors=c[13][:, 0], chain_valid=c[14] > 0,
        cluster_bases=clusters[..., 0].astype(np.float32),
        cluster_valid=clusters[..., 1] > 0,
        overflow=c[15] > 0,
        n_clipped=c[16][:, 0],
    )


def _revcomp_batch(reads: jnp.ndarray, read_len: jnp.ndarray) -> jnp.ndarray:
    """Per-row reverse complement of the first read_len codes, re-padded."""
    B, L = reads.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    src = read_len[:, None] - 1 - pos
    ok = src >= 0
    comp = jnp.array([3, 2, 1, 0, 4], dtype=jnp.int8)
    gathered = jnp.take_along_axis(reads, jnp.clip(src, 0, L - 1), axis=1)
    return jnp.where(ok, comp[gathered], jnp.int8(4))


def _revcomp_qv(qv: jnp.ndarray, read_len: jnp.ndarray,
                tag_shifts=()) -> jnp.ndarray:
    """Reverse a packed per-row QV cost track (QV values follow their
    bases); 3-bit tag fields at ``tag_shifts`` are complemented."""
    B, L = qv.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    src = read_len[:, None] - 1 - pos
    ok = src >= 0
    g = jnp.take_along_axis(qv, jnp.clip(src, 0, L - 1), axis=1)
    for sh in tag_shifts:
        tag = (g >> sh) & 7
        ctag = jnp.where(tag < 4, 3 - tag, tag)
        g = (g & ~jnp.int32(7 << sh)) | (ctag << sh)
    return jnp.where(ok, g, 0)


def _band_offsets(mq, mt, ws, L, W, w_b,
                  frag_diag=None, frag_valid=None, between_only=False):
    """Band start per query row from the chain guide path (window coords),
    batched over items.  mq/mt: int32 [N, MC] chain anchors, q-ascending,
    invalid entries mq == BIG32.  The device stand-in for the reference's SDP
    guide path (between-anchor SDPAlign + GuidedAlign block following,
    iblasr/BlasrAlignImpl.hpp:785-1004, BlasrUtilsImpl.hpp:705-732).

    Formulation: each anchor contributes a diagonal (t - q in window
    coords); between anchors the guide *interpolates* linearly between
    the flanking diagonals, so drift across anchor deserts is tracked
    instead of held.  (row, diagonal) pairs are packed into one int32 so
    a scatter-max + cummax/cummin pair forward/backward-fills the
    flanking anchors — no per-row binary searches.

    frag_diag/frag_valid ([N, L, occ], from
    kernels.sdp.window_fragment_diags) densify the path with SDP k-mer
    fragments, gated by the flanking chain-anchor diagonal range (+- one
    band) so repeat-induced stray matches cannot drag the guide.  With
    ``between_only`` (--refineBetweenAnchorsOnly) fragments outside the
    chain's anchor span are ignored.
    """
    N, MC = mq.shape
    assert L <= 1 << 16, (
        "band-offset packing supports buckets up to 65536 query rows")
    DBITS = 15
    DBIAS = 1 << (DBITS - 1)
    DMASK = 2 * DBIAS - 1
    SENT = jnp.int32(0x7FFFFFFF)
    valid = mq < BIG32
    tw = mt - ws[:, None]                        # window coords
    diag = jnp.clip(tw - mq, -DBIAS + 1, DBIAS - 2)
    packed = jnp.where(valid, (mq << DBITS) | (diag + DBIAS), -1)
    rows = jnp.clip(jnp.where(valid, mq, L - 1), 0, L - 1)
    arr = jnp.full((N, L), -1, jnp.int32)
    arr = arr.at[jnp.arange(N, dtype=jnp.int32)[:, None], rows].max(packed)

    def fills(a):
        ff = jax.lax.cummax(a, axis=1)           # nearest anchor at <= r
        nx = jnp.flip(jax.lax.cummin(
            jnp.flip(jnp.where(a >= 0, a, SENT), 1), axis=1), 1)  # at >= r
        return (ff >= 0, ff >> DBITS, (ff & DMASK) - DBIAS,
                nx < SENT, nx >> DBITS, (nx & DMASK) - DBIAS)

    p_ok, pq, pd, n_ok, nq, nd = fills(arr)
    r = jnp.arange(L, dtype=jnp.int32)[None, :]
    if frag_diag is not None:
        lo_d = jnp.where(p_ok & n_ok, jnp.minimum(pd, nd),
                         jnp.where(p_ok, pd, nd))
        hi_d = jnp.where(p_ok & n_ok, jnp.maximum(pd, nd),
                         jnp.where(p_ok, pd, nd))
        has_flank = (p_ok & n_ok) if between_only else (p_ok | n_ok)
        fd = jnp.clip(frag_diag, -DBIAS + 1, DBIAS - 2)
        ok = (frag_valid & has_flank[:, :, None]
              & (fd >= (lo_d - w_b)[:, :, None])
              & (fd <= (hi_d + w_b)[:, :, None]))
        fpacked = jnp.max(
            jnp.where(ok, (r[:, :, None] << DBITS) | (fd + DBIAS), -1),
            axis=2)
        # chain anchors keep priority at their own rows
        arr = jnp.where(arr >= 0, arr, fpacked)
        p_ok, pq, pd, n_ok, nq, nd = fills(arr)
    both = p_ok & n_ok
    denom = jnp.maximum(nq - pq, 1)
    d_interp = pd + (r - pq) * (nd - pd) // denom
    d = jnp.where(both, d_interp,
                  jnp.where(p_ok, pd, jnp.where(n_ok, nd, 0)))
    center = r + d
    off = jnp.clip(center - w_b // 2, 0, W - w_b)
    # monotone nondecreasing, slope-limited to {0, 1, 2} per row (the
    # CUDA kernel's shift contract; local indel bursts beyond slope 2 are
    # absorbed by the band width)
    return slope_limit_offsets(off)


@functools.partial(
    jax.jit,
    static_argnames=("cfg_k", "L", "W", "w_b", "C", "A", "O", "E", "T",
                     "max_chain", "min_match", "max_anchors_per_pos",
                     "max_lcp", "indel_rate", "C_dp",
                     "p_value_type", "lookback", "global_chain",
                     "aggressive_cut",
                     "advance_exact", "k_sdp", "sdp_occ", "between_only",
                     "use_hp", "use_qv", "qv_score_type",
                     "occ_block_sample", "guide_drift", "cand_drift",
                     "full_widen", "profile_stop", "tb_cap"),
)
def map_batch(
    index: DeviceIndex,
    reads: jnp.ndarray,        # int8 [B, L]
    read_len: jnp.ndarray,     # int32 [B]
    submat: jnp.ndarray,       # float32 [25]
    gap_costs: jnp.ndarray,    # float32 [4] ins_open, ins_ext, del_open, del_ext
    sig_thresh=0.0,            # float: min chain -log P (significance gate,
    #                            the LookupAnchorDistribution analog)
    min_interval_weight=0.0,   # float: min summed anchor bases per
    #                            candidate (reference minInterval weight)
    sdp_bypass=1e6,            # float: sdpBypassThreshold — candidates
    #                            whose chain interval covers >= this
    #                            fraction of the read skip SDP guide
    #                            densification (anchors alone suffice,
    #                            BlasrAlignImpl.hpp:780,992-1004)
    qv1=None,                  # int32 [B, L] packed per-row QV costs
    #                            (forward orientation; kernels.banded
    #                            layout) — QV-steered DP when use_qv
    qv2=None,                  # int32 [B, L] packed per-row priors
    qv_rescore=None,           # float32 [4] match/mismatch/ins/del used
    #                            to re-score the QV-chosen path distance-
    #                            style (PairwiseLocalAlign tail:
    #                            ComputeAlignmentStats assigns the
    #                            printed score; scoreType 0)
    *,
    cfg_k: int, L: int, W: int, w_b: int, C: int, A: int, O: int, E: int,
    T: int, max_chain: int, min_match: int, max_anchors_per_pos: int,
    max_lcp: int, indel_rate: float, C_dp: int = 0,
    p_value_type: int = 3, lookback: int = 0, global_chain: bool = False,
    aggressive_cut: bool = False,
    advance_exact: int = 0, k_sdp: int = 0, sdp_occ: int = 2,
    between_only: bool = False, use_hp: bool = False, use_qv: bool = False,
    qv_score_type: int = 0, occ_block_sample: bool = False,
    guide_drift: float = 1.0, cand_drift: float = 0.0,
    full_widen: bool = False,
    # anchor-bases charged per base of |Δt - Δq| in the GUIDE-extraction
    # chain pass only (kernels.chain drift_penalty): keeps the band guide
    # from hopping between tandem-repeat copies for free.  Candidate
    # ranking stays penalty-free (reference LIS weightor semantics).
    profile_stop: int = 0,
    tb_cap: int = 0,
    # traceback pair capacity: 0 = T//4 (covers ~2x(indel events)+2 pairs
    # with wide margin; overflowing rows are flagged and the host reruns
    # the batch with tb_cap=T, which cannot overflow)
) -> PackedBatch:
    B = reads.shape[0]
    G = index.genome.shape[0]

    def _stop(*arrs):
        # dev-only: truncate the graph after a stage so cumulative stage
        # times can be measured on hardware
        s = sum(jnp.sum(a.astype(jnp.float32)) for a in arrs)
        z = jnp.zeros((1,), jnp.uint8)
        return PackedBatch(ints=s.reshape(1, 1, 1), ops=z, clusters=z)

    rc = _revcomp_batch(reads, read_len)
    reads2 = jnp.concatenate([reads, rc], axis=0)          # [2B, L]
    rlen2 = jnp.concatenate([read_len, read_len], axis=0)

    anchors = find_anchors(
        index.genome, index.keys_sorted, index.pos_sorted, reads2, rlen2,
        k=cfg_k, occ_per_pos=O, max_anchors=A, anchor_ext=E,
        min_match=min_match, max_anchors_per_pos=max_anchors_per_pos,
        max_lcp=max_lcp, advance_exact=advance_exact,
        occ_block_sample=occ_block_sample,
        bucket_starts=index.bucket_starts,
        bucket_pairs=index.bucket_pairs,
        gwords=index.gwords, gnwords=index.gnwords,
        pos_records=index.pos_records)
    if profile_stop == 1:
        return _stop(anchors.hits_t, anchors.q, anchors.t,
                     anchors.l, anchors.n_total)

    # the chain scan emits max(2C, 16) intervals: the first C feed the
    # DP path (the selection scan is greedy, so a deeper extraction
    # picks the identical first C); all of them are recorded as the
    # ClusterList analog so numSignificantClusters can EXCEED
    # nCandidates — required for ScaleMapQVByClusterSize to ever fire
    # (the reference's clusterList sees every examined window,
    # BlasrAlignImpl.hpp:436-455; with C_stat == C the count was capped
    # at nCandidates and the guard was dead code)
    C_stat = max(2 * C, 16)
    cands_all = chain_anchors(anchors, rlen2, n_cand=C_stat,
                              indel_rate=indel_rate,
                              rank_by_pvalue=p_value_type in (0, 1, 2),
                              p_value_type=p_value_type, lookback=lookback,
                              global_chain=global_chain,
                              drift_penalty=cand_drift)
    # significance gate: drop candidate intervals explainable by chance
    # (reference: anchor-distribution mapQV gate + LIS P-value,
    # BlasrAlignImpl.hpp:391-488)
    cands_all = cands_all._replace(
        valid=(cands_all.valid & (cands_all.nlogp >= jnp.float32(sig_thresh))
               & (cands_all.score >= jnp.float32(min_interval_weight))))
    if aggressive_cut:
        # --aggressiveIntervalCut (RegisterBlasrOptions.h:334-337): once a
        # promising candidate exists, drop non-promising ones (< 1/3 of
        # the best chain weight) — short ALU-like hits are ignored
        best_w = jnp.max(jnp.where(cands_all.valid, cands_all.score, 0.0),
                         axis=1, keepdims=True)
        cands_all = cands_all._replace(
            valid=cands_all.valid & (cands_all.score * 3.0 >= best_w))
    cluster_stats = jnp.stack(
        [cands_all.score.astype(jnp.int32),
         cands_all.valid.astype(jnp.int32)], axis=-1)
    # zero invalid candidates' spans so their DP rows degenerate to a
    # 1-cell alignment and the kernel's early exit skips them
    cands_all = cands_all._replace(
        q_start=jnp.where(cands_all.valid, cands_all.q_start, 0),
        q_end=jnp.where(cands_all.valid, cands_all.q_end, 0),
        t_start=jnp.where(cands_all.valid, cands_all.t_start, 0),
        t_end=jnp.where(cands_all.valid, cands_all.t_end, 0))
    cands = cands_all._replace(
        q_start=cands_all.q_start[:, :C], q_end=cands_all.q_end[:, :C],
        t_start=cands_all.t_start[:, :C], t_end=cands_all.t_end[:, :C],
        score=cands_all.score[:, :C], n_anchors=cands_all.n_anchors[:, :C],
        nlogp=cands_all.nlogp[:, :C], valid=cands_all.valid[:, :C],
        end_idx=cands_all.end_idx[:, :C])
    if profile_stop == 2:
        return _stop(cands.q_start, cands.q_end, cands.t_start, cands.t_end,
                     cands.score, cands.valid)
    if guide_drift > 0.0:
        # guide members come from a drift-penalized chain pass: same end
        # anchors, but the path into the past pays |Δt - Δq| per
        # transition, so it cannot mosaic across tandem-repeat copies
        # (a real structural indel still hops — no same-diagonal
        # alternative exists to outbid it).  Candidate intervals/scores
        # above stay penalty-free.
        pen = chain_anchors(anchors, rlen2, n_cand=1,
                            indel_rate=indel_rate,
                            rank_by_pvalue=p_value_type in (0, 1, 2),
                            p_value_type=p_value_type, lookback=lookback,
                            global_chain=global_chain,
                            drift_penalty=guide_drift)
        cands_for_guide = cands._replace(parent=pen.parent)
    else:
        cands_for_guide = cands
    mq, mt, ml, mvalid = chain_members(cands_for_guide, anchors,
                                       max_chain=max_chain)
    if profile_stop == 3:
        return _stop(mq, mt, ml, mvalid)

    # candidate compaction: with C_dp == 0 (the default) every candidate
    # slot gets a banded-DP row — the reference aligns every
    # WeightedInterval (iblasr/BlasrAlignImpl.hpp:553-607) and dp-block
    # early exit makes the (mostly invalid) tail cheap.  With C_dp > 0
    # only n2*C_dp rows run DP, selected by *within-read candidate rank*
    # first, then chain weight: every read's top-r candidates outrank any
    # read's rank-(r+1) ones, so each read is guaranteed its C_dp best
    # candidates (lossless whenever total valid <= n2*C_dp).
    n2 = 2 * B
    c_dp = C_dp if C_dp > 0 else C
    n_dp = n2 * c_dp
    flat_valid = cands.valid.reshape(-1)
    # chain_anchors emits candidates best-first per row, so the column
    # index is the within-read rank; scores are anchor bases < 2^17
    c_rank = jax.lax.broadcasted_iota(jnp.int32, (n2, C), 1).reshape(-1)
    sc_i = jnp.clip(cands.score.reshape(-1), 0, 131071).astype(jnp.int32)
    rank = jnp.where(flat_valid, c_rank * 131072 + (131071 - sc_i), BIG32)
    sel = jnp.argsort(rank, stable=True)[:n_dp].astype(jnp.int32)
    # group similar query spans next to each other so the warps of one
    # CUDA DP block (one alignment each, early exit at its own qb) finish
    # together
    span_key = -jnp.take(cands.q_end.reshape(-1), sel)
    sel = jnp.take(sel, jnp.argsort(span_key, stable=True))
    sel_valid = jnp.take(flat_valid, sel)

    def pick(x):
        return jnp.take(x.reshape(n2 * C, *x.shape[2:]), sel, axis=0)

    # widen the chain span toward the read ends: error-dense head/tail
    # regions often carry no anchors, but the banded DP aligns them
    # correctly once inside the span (AlignIntervals aligns the whole
    # subread against the interval; chain spans underestimate it).
    # Default cap 96: the DP is GLOBAL inside [qa, qb], so unbounded
    # widening would force junk through alignments whose read genuinely
    # ends elsewhere (a spliced read's other half, chimeras — the onegap
    # path needs the two pieces SEPARATE).  full_widen=True (the
    # ambiguity-rescue deep pass) widens to the whole read: in a deep
    # tandem array the true copy's chain often starts mid-read, and its
    # honest full-span alignment can never materialize under the cap,
    # losing on span to a mosaic wrong-copy alignment
    # (tools/diag_tandem.py); W is sized for a full read + band either
    # way.
    margin = L if full_widen else 96
    read_row = sel // C                                      # [N_dp]
    rlen_sel = jnp.take(rlen2, read_row)
    qa0 = pick(cands.q_start)
    qb0 = jnp.maximum(pick(cands.q_end), qa0 + 1)
    vsel_i = sel_valid.astype(jnp.int32)   # no widening for invalid slots
    head = jnp.minimum(qa0, margin) * vsel_i
    tail = jnp.clip(rlen_sel - qb0, 0, margin) * vsel_i
    ts0 = pick(cands.t_start)
    ts = jnp.maximum(ts0 - head, 0)
    te = pick(cands.t_end) + tail
    # contig lookup uses the unwidened start (the widening may cross a
    # boundary; the clamps below pull the span back inside the contig)
    ci = jnp.searchsorted(index.contig_starts, ts0, side="right") - 1
    ci = jnp.clip(ci, 0, index.contig_starts.shape[0] - 1)
    c_lo = index.contig_starts[ci]
    c_hi = index.contig_ends[ci]
    # window may start one base before the contig (the sentinel / spacer):
    # that base is only the DP boundary cell, never consumed
    ws = jnp.clip(ts - w_b, c_lo - 1, jnp.maximum(c_hi - W, c_lo - 1))
    ws = jnp.maximum(ws, 0)

    gpad = jnp.concatenate(
        [index.genome, jnp.full((W,), 4, dtype=index.genome.dtype)])
    windows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(gpad, (s,), (W,)))(ws)  # [N_dp, W]

    # clamp aligned target range into the window and contig
    ta = jnp.maximum(ts, c_lo) - ws
    tb = jnp.minimum(jnp.minimum(te, c_hi), ws + W) - ws
    tb = jnp.maximum(tb, ta + 1)

    reads_sel = jnp.take(reads2, read_row, axis=0)           # [N_dp, L]
    qa = qa0 - head
    qb = jnp.maximum(jnp.minimum(qb0 + tail, rlen_sel), qa + 1)
    if profile_stop == 40:
        return _stop(windows, reads_sel, qa, qb, ta, tb)

    # SDP guide densification (the reference always SDP-aligns candidate
    # intervals unless the bypass fires, BlasrAlignImpl.hpp:780-1004).
    # Default: the anchor stage's raw per-position hits double as the SDP
    # fragment set — they are already computed, so the dense guide is
    # free.  A dedicated window-level k-mer pass (below) only runs when
    # the caller asks for tuples shorter than the index seed.
    q3 = jax.lax.broadcasted_iota(jnp.int32, (n_dp, L, O), 1)
    ht = jnp.take(anchors.hits_t, read_row, axis=0)          # [N_dp, L, O]
    hv = jnp.take(anchors.hits_valid, read_row, axis=0)
    frag_diag = ht - ws[:, None, None] - q3
    # sdpBypassThreshold: anchors-as-guide fast path for candidates whose
    # chain interval already covers enough of the read
    ratio = ((pick(cands.t_end) - ts0).astype(jnp.float32)
             / jnp.maximum(rlen_sel, 1).astype(jnp.float32))
    no_bypass = ratio < jnp.float32(sdp_bypass)
    frag_ok = (hv & (ht >= ws[:, None, None]) & (ht < (ws + W)[:, None, None])
               & no_bypass[:, None, None])

    mcw = mq.shape[-1]
    mqs = pick(mq.reshape(n2, C, mcw))
    mts = pick(mt.reshape(n2, C, mcw))
    offs = _band_offsets(mqs, mts, ws, L, W, w_b,
                         frag_diag, frag_ok, between_only)
    if profile_stop == 41:
        return _stop(offs, windows, qa, qb, ta, tb)
    if k_sdp > 0:
        # short-tuple window pass (sdpTupleSize below the index seed
        # size): always the top-2 chain-ranked candidates per strand-row,
        # plus lower-ranked candidates whose guide path has an
        # inter-anchor desert wider than the DP band — exactly the case
        # the dense pass exists for (the reference SDP-aligns every
        # interval, BlasrAlignImpl.hpp:980-990; window k-mer sorting for
        # every slot is too expensive, so deserts buy the extra capacity)
        from blasr_tpu.kernels.sdp import window_fragment_diags_banded
        n_sdp = min(3 * n2, n_dp)
        gmask = (sel % C) < 2
        mv = mqs < BIG32
        desert = (jnp.any(mv[:, 1:] & mv[:, :-1]
                          & (mqs[:, 1:] - mqs[:, :-1] > w_b), axis=1)
                  & sel_valid & no_bypass)
        prio = jnp.where(gmask, 0, jnp.where(desert, 1, 2))
        srows = jnp.argsort(prio,
                            stable=True)[:n_sdp].astype(jnp.int32)

        def sub(x):
            return jnp.take(x, srows, axis=0)

        rk2, rv2 = read_kmer_keys(reads2, rlen2, k_sdp)
        rr = jnp.take(read_row, srows)
        wfd, wfo = window_fragment_diags_banded(
            jnp.take(rk2, rr, axis=0), jnp.take(rv2, rr, axis=0),
            sub(windows), jnp.full((n_sdp,), W, jnp.int32), sub(offs),
            k=k_sdp, occ=sdp_occ, w_b=w_b)
        fd2 = jnp.concatenate([sub(frag_diag), wfd], axis=2)
        fo2 = jnp.concatenate(
            [sub(frag_ok), wfo & sub(no_bypass)[:, None, None]], axis=2)
        offs_sub = _band_offsets(sub(mqs), sub(mts), sub(ws), L, W, w_b,
                                 fd2, fo2, between_only)
        offs = offs.at[srows].set(offs_sub)

    dp_args = (reads_sel, windows, offs, qa, qb, ta, tb, submat,
               gap_costs[0], gap_costs[1], gap_costs[2], gap_costs[3])
    qv = {}
    if use_qv:
        # QV-steered DP (PairwiseLocalAlign QV branch): per-read packed
        # cost tracks, reversed (+tag-complemented) for the rc rows
        qv1_2 = jnp.concatenate(
            [qv1, _revcomp_qv(qv1, read_len, tag_shifts=(24, 27))], axis=0)
        qv2_2 = jnp.concatenate([qv2, _revcomp_qv(qv2, read_len)], axis=0)
        qv = dict(qv1=jnp.take(qv1_2, read_row, axis=0),
                  qv2=jnp.take(qv2_2, read_row, axis=0))
    if profile_stop == 4:
        # the banded-DP operands themselves (kernel comparisons at the
        # shapes and data of a real batch)
        return dp_args, qv
    if use_hp and not use_qv:
        # affine path with the homopolymer-insertion band
        # (AffineKBandAlign, BlasrAlignImpl.hpp:1262-1266): XLA everywhere
        res = banded_align(*dp_args, w_b=w_b, use_hp=True,
                           hp_open=gap_costs[4], hp_ext=gap_costs[5])
    elif dp_kernel_for(jax.default_backend()) == "cuda":
        res = cuda_banded_align(*dp_args, w_b=w_b, **qv)
    else:
        res = banded_align(*dp_args, w_b=w_b, **qv)
    if profile_stop == 5:
        return _stop(res.score, res.tbbits, res.final_state, res.valid)
    valid_sel = sel_valid & res.valid

    # traceback compaction: only the top nCandidates alignments per READ
    # (both strands, ranked by DP score with deterministic ties) get a
    # traceback — the reference caps reportable intervals per read at
    # nCandidates, and untraced rows are beyond it.  Halves the
    # sequential traceback scan and the ops transfer.
    n_tb = min(B * C, n_dp)
    read_of = read_row % B
    sc_key = jnp.where(valid_sel, res.score.astype(jnp.int32), BIG32)
    ii = jnp.arange(n_dp, dtype=jnp.int32)
    same_read = read_of[:, None] == read_of[None, :]
    better = ((sc_key[None, :] < sc_key[:, None])
              | ((sc_key[None, :] == sc_key[:, None])
                 & (ii[None, :] < ii[:, None])))
    tb_rank = jnp.sum(same_read & better, axis=1)
    keep_tb = valid_sel & (tb_rank < C)
    tb_rows = jnp.argsort(jnp.where(keep_tb, 0, 1),
                          stable=True)[:n_tb].astype(jnp.int32)

    def sub_tb(x):
        return jnp.take(x, tb_rows, axis=0)

    res_sub = type(res)(score=sub_tb(res.score), tbbits=sub_tb(res.tbbits),
                        final_state=sub_tb(res.final_state),
                        valid=sub_tb(res.valid))
    # pair capacity: junk candidates inside the band top out near 0.8
    # pairs/column (measured p99.9 = 1559 at T = 5120), so 3T/8 leaves
    # zero overflows on CLR-like workloads; the while_loop exits early,
    # so a roomier buffer costs transfer bytes only
    t_rl = tb_cap if tb_cap > 0 else max(128, (3 * T) // 8)
    tbk = banded_traceback(res_sub, sub_tb(offs), sub_tb(qa), sub_tb(qb),
                           sub_tb(ta), sub_tb(tb), t_max=t_rl, w_b=w_b)

    if profile_stop == 6:
        return _stop(tbk.pairs, tbk.n_match, tbk.n_mismatch, tbk.n_ins,
                     tbk.n_del)

    def back(v):
        return jnp.zeros((n_dp,), v.dtype).at[tb_rows].set(v)

    slot_of_dp = jnp.full((n_dp,), -1, jnp.int32).at[tb_rows].set(
        jnp.arange(n_tb, dtype=jnp.int32))
    slot_of_dp = jnp.where(keep_tb, slot_of_dp, -1)

    # RL pairs travel as-is (already 2 packed uint16 per int32; size
    # scales with the error count, not the read length)
    packed = tbk.pairs

    def scatter(vals, fill=0):
        buf = jnp.full((n2 * C,) + vals.shape[1:], fill, vals.dtype)
        return buf.at[sel].set(vals).reshape(n2, C, *vals.shape[1:])

    dp_slot = jnp.full((n2 * C,), -1, jnp.int32).at[sel].set(
        slot_of_dp).reshape(n2, C)
    # pack everything the host needs into two contiguous arrays: each
    # device->host array is a separate transfer, so one int32 block + the
    # uint8 ops block beat ~15 small transfers
    if use_qv and not qv_score_type:
        # the QV DP chose the path; the reported score is the distance-
        # matrix rescore of that path (ComputeAlignmentStats with
        # distScoreFn2, BlasrAlignImpl.hpp:1304-1306; scoreType 0).
        # Untraced rows keep the QV score (they are never reported).
        # With --scoreType 1 the QV DP score itself is reported
        # (sumQVScore, BlasrAlignImpl.hpp:1306-1308) — res.score as-is.
        score_dist = (qv_rescore[0] * tbk.n_match.astype(jnp.float32)
                      + qv_rescore[1] * tbk.n_mismatch.astype(jnp.float32)
                      + qv_rescore[2] * tbk.n_ins.astype(jnp.float32)
                      + qv_rescore[3] * tbk.n_del.astype(jnp.float32))
        score_out = jnp.where(keep_tb, back(score_dist), res.score)
    else:
        score_out = res.score
    ints = jnp.stack([
        scatter(valid_sel.astype(jnp.int32)),
        scatter(qa),
        scatter(qb),
        scatter(ta + ws - 1),  # -1: device genome sentinel
        scatter(tb + ws - 1),
        scatter(back(tbk.n_match)),
        scatter(back(tbk.n_mismatch)),
        scatter(back(tbk.n_ins)),
        scatter(back(tbk.n_del)),
        dp_slot,
        scatter(score_out, 1e30).astype(jnp.int32),
        cands.score.reshape(n2, C).astype(jnp.int32),
        cands.n_anchors.reshape(n2, C),
        jnp.broadcast_to(anchors.n_total[:, None], (n2, C)),
        cands.valid.reshape(n2, C).astype(jnp.int32),
        scatter(back(tbk.overflow.astype(jnp.int32))),
        jnp.broadcast_to(anchors.n_clipped[:, None], (n2, C)),
    ], axis=-1)
    flat = jnp.concatenate([ints.reshape(-1), cluster_stats.reshape(-1),
                            packed.reshape(-1)])
    return PackedBatch(ints=ints, ops=packed, clusters=cluster_stats,
                       flat=flat)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

@dataclass
class Alignment:
    """Host-side alignment record (reference AlignmentCandidate analog,
    iblasr/ReadAlignments.hpp:8)."""

    qname: str
    qlen: int
    qstart: int          # forward-read coordinates
    qend: int
    strand: int          # 0 fwd, 1 rc
    tindex: int          # contig index
    tname: str
    tlen: int
    tstart: int          # forward contig coordinates
    tend: int
    score: float
    n_match: int
    n_mismatch: int
    n_ins: int
    n_del: int
    map_qv: int = 254
    cigar: Optional[List] = None      # list of (op_char, count), query-fwd order
    read: Optional[np.ndarray] = None  # read codes (forward orientation)
    qual: Optional[np.ndarray] = None
    tracks: Optional[dict] = None      # named QV tracks (fwd orientation)
    n_candidates: int = 0
    n_significant_clusters: int = 0
    cluster_weight: float = 0.0  # anchor bases of the producing chain
    #                              (WeightedInterval size; feeds the
    #                              anchor-distribution significance gate)
    band_width: int = 128  # DP band that produced this alignment (the
    #                        nCells metric scales with it)

    @property
    def pct_similarity(self) -> float:
        n = self.n_match + self.n_mismatch + self.n_ins + self.n_del
        return 100.0 * self.n_match / n if n else 0.0

    @property
    def n_cells(self) -> int:
        return (self.qend - self.qstart) * self.band_width


# placeholder CIGAR for alignments awaiting batched assembly: truthy (the
# has-blocks bit is known before assembly) and visibly bogus if it leaks
_CIGAR_PENDING: List = [("?", -1)]


class LazyCigar:
    """CIGAR runs held as raw (op-code, count) arrays; the [(op_char, n),
    ...] tuple list materializes on first element access and is cached.

    Building the tuple list is the single largest host cost of the
    mapping loop (~0.4 ms for a noisy 2 kb alignment with ~1400 runs),
    and the loop itself only ever needs truthiness/len — which this
    answers from the array shape.  Printing/rescoring of the alignments
    that survive hit selection pays materialization, exactly once."""

    __slots__ = ("_ops", "_cnts", "_list")

    def __init__(self, ops: np.ndarray, cnts: np.ndarray):
        self._ops = ops
        self._cnts = cnts
        self._list = None

    def _mat(self) -> List:
        if self._list is None:
            from blasr_tpu.native import runs_to_list
            self._list = runs_to_list(self._ops, self._cnts)
        return self._list

    def __len__(self):
        return int(self._ops.shape[0])

    def __bool__(self):
        return self._ops.shape[0] > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __add__(self, other):
        return self._mat() + list(other)

    def __radd__(self, other):
        return list(other) + self._mat()

    def __eq__(self, other):
        if isinstance(other, LazyCigar):
            other = other._mat()
        return self._mat() == other

    def __repr__(self):
        return f"LazyCigar({self._mat()!r})"

    def arrays(self):
        """(op codes uint8 [n] per 1=M 2=I 3=D 4=X, counts int32 [n])."""
        return self._ops, self._cnts


def unpack_pairs(words: np.ndarray):
    """RL traceback words (one TracebackResult.pairs row) -> (ops, counts)
    end-first.  Each int32 word holds two uint16 halves (low first), each
    half = op | count << 2; op 0 = stop."""
    u = np.ascontiguousarray(words, dtype=np.int32).view(np.uint32)
    h = np.empty(u.size * 2, dtype=np.uint32)
    h[0::2] = u & 0xFFFF
    h[1::2] = u >> 16
    ops = (h & 3).astype(np.uint8)
    stop = np.nonzero(ops == 0)[0]
    n = int(stop[0]) if stop.size else len(ops)
    cnts = (h[:n] >> 2).astype(np.int64)
    keep = cnts > 0  # zero-count no-op pairs (traceback stall steps)
    return ops[:n][keep], cnts[keep]


def pairs_to_cigar(words: np.ndarray) -> List:
    """RL traceback words -> run-length [(op, n), ...] in alignment order.
    Adjacent same-op pairs (RUN_CAP segments, single-base indel steps)
    coalesce.  op codes: 1 'M', 2 'I', 3 'D'."""
    ops, cnts = unpack_pairs(words)
    n = len(ops)
    if n == 0:
        return []
    ops = ops[::-1]
    cnts = cnts[::-1]
    sym = "?MID"
    keep = np.concatenate([[True], ops[1:] != ops[:-1]])
    starts = np.nonzero(keep)[0]
    ends = np.concatenate([starts[1:], [n]])
    csum = np.concatenate([[0], np.cumsum(cnts)])
    return [(sym[ops[s]], int(csum[e] - csum[s]))
            for s, e in zip(starts, ends)]


def split_match_runs(cigar: List, query: np.ndarray,
                     target: np.ndarray) -> List:
    """Split 'M' runs into '='/'X' by sequence comparison (cigarUseSeqMatch,
    RegisterBlasrOptions.h --cigarUseSeqMatch).  query/target: the aligned
    subsequences (strand-local query [qa:qb], target [ts:te])."""
    out: List = []
    qi = ti = 0
    for op, n in cigar:
        if op == "M":
            eq = query[qi:qi + n] == target[ti:ti + n]
            start = 0
            for j in range(1, n + 1):
                if j == n or eq[j] != eq[start]:
                    sym = "=" if eq[start] else "X"
                    if out and out[-1][0] == sym:
                        out[-1] = (sym, out[-1][1] + j - start)
                    else:
                        out.append((sym, j - start))
                    start = j
            qi += n
            ti += n
        else:
            out.append((op, n))
            if op in "I=X":
                qi += n
            if op in "D":
                ti += n
            if op in "=X":
                ti += n
    return out


def merge_adjacent_indels(cigar: List) -> List:
    """Convert adjacent I/D (or D/I) pairs into match columns, as the
    reference SAM printer does unless --allowAdjacentIndels
    (ctest/cigarAdjecentIndels.t contract: no ID or DI in CIGAR)."""
    runs = list(cigar)
    changed = True
    while changed:
        changed = False
        out: List = []
        i = 0
        while i < len(runs):
            if (i + 1 < len(runs)
                    and runs[i][0] in "ID" and runs[i + 1][0] in "ID"
                    and runs[i][0] != runs[i + 1][0]):
                a, na = runs[i]
                b, nb = runs[i + 1]
                m = min(na, nb)
                # folded columns consume both sides with unknown match
                # status -> 'M' (the reference's SAM convention; claiming
                # 'X' would assert a mismatch the bases may not have).
                # --cigarUseSeqMatch later splits 'M' into '='/'X' by
                # actual comparison.
                out.append(("M", m))
                if na > m:
                    out.append((a, na - m))
                if nb > m:
                    out.append((b, nb - m))
                i += 2
                changed = True
            else:
                out.append(runs[i])
                i += 1
        # coalesce equal neighbours
        runs = []
        for op, n in out:
            if runs and runs[-1][0] == op:
                runs[-1] = (op, runs[-1][1] + n)
            else:
                runs.append((op, n))
    return runs


class Mapper:
    """Host driver: buckets reads by length, invokes the jitted pipeline,
    and produces :class:`Alignment` records (coordinate bookkeeping,
    CIGAR assembly, strand flips)."""

    def __init__(self, gi: GenomeIndex, params: MappingParams,
                 cfg: Optional[ShapeConfig] = None, metrics=None, dev=None,
                 rescue: Optional["Mapper"] = None):
        # rescue: a second Mapper over a more sensitive index (e.g. k=12
        # when this one uses the k=14 large-genome LUT); reads that end up
        # unmapped or weakly mapped re-run through it and keep the better
        # result.  The large-genome analog of the reference's default
        # minMatch-12 sensitivity (iblasr/MappingParameters.h:258).
        from blasr_tpu.pipeline.metrics import MappingMetrics
        self.rescue = rescue
        # per-read anchor totals of the latest pass (keyed by record id);
        # feeds the anchor-ambiguity rescue in map_reads
        self._anchor_totals: Dict[int, int] = {}
        self._ambiguity_rescue = True
        self._vlog_file = None
        self.gi = gi
        self.params = params.make_sane()
        # --nCandidates drives the device candidate capacity when no
        # explicit shape config is given
        self.cfg = cfg or ShapeConfig(n_candidates=self.params.n_candidates)
        # emit-all anchoring reachable by flag: the reference emits every
        # SA occurrence up to --maxAnchorsPerPosition (default 10000,
        # RegisterBlasrOptions.h:104-106); an explicitly bounded value
        # (<= 256) becomes the per-position emission capacity instead of
        # the default occurrence sampling (batch_size_for folds the
        # anchor-stage memory into the batch bound)
        mapp = self.params.max_anchors_per_position
        if 0 < mapp <= 256 and mapp > self.cfg.occ_per_pos:
            self.cfg = dataclasses.replace(
                self.cfg, occ_per_pos=mapp,
                max_anchors=max(self.cfg.max_anchors, 4 * mapp))
        self.metrics = metrics or MappingMetrics()
        self.dev = dev if dev is not None else DeviceIndex.from_host(gi)
        m = np.asarray(self.params.score_matrix, dtype=np.float32).reshape(25)
        self.submat = jnp.asarray(m)
        self.submat_np = m
        p = self.params
        # QV-steered DP (--useQuality): the IDS/QV score function runs
        # inside the banded kernel, so QVs change the traceback path
        # (PairwiseLocalAlign QV branch, BlasrAlignImpl.hpp:1276-1298);
        # reads without QVs in the same run get flat per-row costs that
        # reproduce the non-affine kernel exactly
        self.use_qv = not p.ignore_qualities
        # distance-matrix rescore of the QV-chosen path: match/mismatch
        # from the matrix, indels at params.indel (distScoreFn2,
        # BlasrAlignImpl.hpp:1245-1246,1304-1306)
        self.qv_rescore = jnp.asarray(
            [m[0], m[1], p.indel, p.indel], jnp.float32)
        if p.affine_align:
            gaps = [p.affine_open + p.insertion, max(p.affine_extend, 1),
                    p.affine_open + p.deletion, max(p.affine_extend, 1),
                    # hp ins open/extend = indel+2 / indel-3
                    # (AffineKBandAlign call, BlasrAlignImpl.hpp:1262-1263)
                    p.indel + 2, max(p.indel - 3, 1)]
        else:
            gaps = [p.insertion, p.insertion, p.deletion, p.deletion, 0, 0]
        self.gap_costs = jnp.asarray(gaps, dtype=jnp.float32)

    def _chain_lookback(self) -> int:
        """Transition-window size for the chain DP: --fastMaxInterval
        limits each anchor to the 64 most recent predecessors (the
        reference's faster, less exhaustive interval search); --advanceHalf
        halves whatever window applies (its "clustering begins at
        a_(n/2)" speed trick, RegisterBlasrOptions.h:312-316)."""
        p = self.params
        d = 64 if p.fast_max_interval else 0
        if p.advance_half:
            base = d if d else self.cfg.max_anchors
            d = max(base // 2, 32)
        return d

    def batch_size_for(self, bucket: int) -> int:
        # keep traceback memory bounded: 2B*C*L*w_b bytes
        budget = self.cfg.hbm_budget
        b = budget // (2 * self.cfg.n_candidates * bucket * self.cfg.band_width)
        # the anchor stage materializes [2B, L, O] expansions (~16 int32
        # planes incl. the fused 24-byte records); deep occ_per_pos runs
        # (emit-all flag / ambiguity rescue) must shrink the batch
        b2 = budget // (2 * bucket * self.cfg.occ_per_pos * 16)
        return int(max(1, min(self.cfg.batch_size, b, b2)))

    def _batch_call_args(self, L: int, tb_cap: int = 0):
        """(positional args after reads/lens, static kwargs) of the
        map_batch call for bucket L — shared by dispatch and warmup."""
        cfg, p = self.cfg, self.params
        W = cfg.window_len(L)
        sig = float(np.log(2.0 * max(self.gi.glen, 2) * L))
        pos = (self.submat, self.gap_costs, np.float32(sig),
               np.float32(p.min_interval_weight),
               np.float32(p.sdp_bypass_threshold))
        kw = dict(
            cfg_k=self.gi.k, L=L, W=W, w_b=cfg.band_width,
            C=cfg.n_candidates, A=cfg.max_anchors, O=cfg.occ_per_pos,
            E=cfg.anchor_ext, T=L + W,
            max_chain=min(cfg.guide_anchors, cfg.max_anchors),
            min_match=p.min_match_length,
            max_anchors_per_pos=p.max_anchors_per_position,
            max_lcp=p.max_match_length, indel_rate=p.indel_rate,
            C_dp=cfg.dp_cands,
            p_value_type=p.p_value_type,
            lookback=self._chain_lookback(),
            global_chain=p.global_chain_type >= 1,
            aggressive_cut=p.aggressive_interval_cut,
            advance_exact=p.advance_exact_matches,
            k_sdp=min(p.sdp_tuple_size, 16),
            sdp_occ=1 if p.fast_sdp else 2,
            between_only=p.refine_between_anchors_only,
            use_hp=p.affine_align and not self.use_qv,
            use_qv=self.use_qv, qv_score_type=p.score_type,
            occ_block_sample=(cfg.occ_block_sample or bool(int(
                os.environ.get("BLASR_TPU_OCC_BLOCK", "0")))),
            cand_drift=p.candidate_drift_penalty,
            full_widen=cfg.full_widen,
            tb_cap=tb_cap)
        return pos, kw

    _TAG_CODE = None

    @classmethod
    def _tag_codes(cls):
        if cls._TAG_CODE is None:
            t = np.full(256, 7, np.int32)  # 7 = matches no target base
            for i, c in enumerate("ACGT"):
                t[ord(c)] = i
            cls._TAG_CODE = t
        return cls._TAG_CODE

    def pack_qv_rows(self, group, batch: int, L: int):
        """Per-read packed QV cost tracks (kernels.banded layout).

        Per-row fallbacks make every flavor exact: full IDS tracks use
        insertion/deletion/substitution QVs with tag-gated priors;
        plain-QV reads (FASTQ) price mismatches at the base's quality
        with flat indels (QualityValueScoreFunction, scoreFn.ins/del =
        params.indel); reads with no QVs at all reproduce the flat
        non-affine costs bit-for-bit."""
        p = self.params
        q1 = np.zeros((batch, L), np.int32)
        q2 = np.zeros((batch, L), np.int32)
        mm_default = int(np.clip(self.submat_np[1], 0, 255))
        tagc = self._tag_codes()
        for i, r in enumerate(group):
            n = min(len(r.seq), L)
            if n == 0:
                continue
            t = getattr(r, "tracks", None) or {}
            iq = t.get("InsertionQV")
            if iq is not None and len(np.unique(iq[:n])) > 1:
                # IDS flavor (reference gate: insertionQV present and
                # meaningful, BlasrMiscsImpl.hpp:50-77)
                insq = np.clip(iq[:n], 0, 255).astype(np.int32)
                dq = t.get("DeletionQV")
                if dq is not None:
                    delq = np.clip(dq[:n], 0, 255).astype(np.int32)
                    dt = t.get("DeletionTag")
                    if dt is not None:
                        dtag = tagc[np.asarray(dt[:n], np.uint8)]
                        dpri = np.full(n, p.global_deletion_prior,
                                       np.int32)
                    else:  # no tag: always the deletionQV
                        dtag = np.full(n, 7, np.int32)
                        dpri = delq
                else:
                    delq = np.zeros(n, np.int32)
                    dtag = np.full(n, 7, np.int32)
                    dpri = np.full(n, p.deletion, np.int32)
                sq = t.get("SubstitutionQV")
                if sq is not None:
                    subq = np.clip(sq[:n], 0, 255).astype(np.int32)
                    st = t.get("SubstitutionTag")
                    if st is not None:
                        stag = tagc[np.asarray(st[:n], np.uint8)]
                        spri = np.full(n, p.substitution_prior, np.int32)
                    else:
                        stag = np.full(n, 7, np.int32)
                        spri = subq
                else:
                    subq = np.zeros(n, np.int32)
                    stag = np.full(n, 7, np.int32)
                    spri = np.full(n, mm_default, np.int32)
            elif r.qual is not None and len(r.qual) >= n \
                    and len(np.unique(r.qual[:n])) > 1:
                # plain-QV flavor: mismatch = base quality, flat indels
                insq = np.full(n, p.indel, np.int32)
                delq = np.zeros(n, np.int32)
                dtag = np.full(n, 7, np.int32)
                dpri = np.full(n, p.indel, np.int32)
                subq = np.zeros(n, np.int32)
                stag = np.full(n, 7, np.int32)
                spri = np.clip(r.qual[:n], 0, 255).astype(np.int32)
            else:
                # no QVs: flat costs identical to the non-affine kernel
                insq = np.full(n, p.insertion, np.int32)
                delq = np.zeros(n, np.int32)
                dtag = np.full(n, 7, np.int32)
                dpri = np.full(n, p.deletion, np.int32)
                subq = np.zeros(n, np.int32)
                stag = np.full(n, 7, np.int32)
                spri = np.full(n, mm_default, np.int32)
            q1[i, :n] = (insq | (delq << 8) | (subq << 16)
                         | (dtag << 24) | (stag << 27))
            q2[i, :n] = dpri | (spri << 8)
        return q1, q2

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               n_threads: int = 0) -> None:
        """Pre-compile the given buckets' map_batch concurrently
        (default: every configured bucket).

        XLA compilation releases the GIL, so lowering+compiling the
        bucket shapes in threads overlaps the compiles; with the
        persistent compilation cache enabled the subsequent jit calls
        load the cached executables instead of recompiling.  Cuts the
        multi-bucket cold warmup roughly n_buckets-fold."""
        from concurrent.futures import ThreadPoolExecutor

        def _key(L):
            pos, kw = self._batch_call_args(L)
            # the compile signature includes every index-array shape
            return (self.batch_size_for(L), self.gi.glen, self.gi.k,
                    int(self.dev.pos_sorted.shape[0]),
                    self.dev.bucket_starts is None,
                    self.dev.bucket_pairs is None,
                    self.dev.pos_records is None,
                    tuple(sorted(kw.items())))

        buckets = [b for b in
                   (self.cfg.buckets if buckets is None else buckets)
                   if _key(b) not in _WARMED_SHAPES]
        if len(buckets) < 2:
            return  # a single compile gains nothing from the fan-out
        if not n_threads:
            n_threads = len(buckets)

        def _compile(L):
            batch = self.batch_size_for(L)
            arr = jnp.zeros((batch, L), dtype=jnp.int8)
            lens = jnp.full((batch,), L, dtype=jnp.int32)
            pos, kw = self._batch_call_args(L)
            qvkw = {}
            if self.use_qv:
                z = jnp.zeros((batch, L), dtype=jnp.int32)
                qvkw = dict(qv1=z, qv2=z, qv_rescore=self.qv_rescore)
            map_batch.lower(self.dev, arr, lens, *pos, **qvkw,
                            **kw).compile()
            _WARMED_SHAPES.add(_key(L))

        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            list(ex.map(_compile, buckets))

    def _run_bucket(self, recs: Sequence[FastaRecord], bucket: int,
                    batch: int) -> List[List[Alignment]]:
        cfg, p = self.cfg, self.params
        L = bucket
        W = cfg.window_len(L)
        T = L + W
        out: List[List[Alignment]] = []
        def dispatch(arr, lens, tb_cap=0, qv=None):
            pos, kw = self._batch_call_args(L, tb_cap)
            if self.use_qv:
                q1, q2 = qv
                return map_batch(
                    self.dev, jnp.asarray(arr), jnp.asarray(lens), *pos,
                    qv1=jnp.asarray(q1), qv2=jnp.asarray(q2),
                    qv_rescore=self.qv_rescore, **kw)
            return map_batch(
                self.dev, jnp.asarray(arr), jnp.asarray(lens), *pos, **kw)

        # sliding-window pipeline: input transfers are staged LOOKAHEAD
        # batches ahead of dispatch (async device_put, so copies pipeline
        # over the transfer link instead of serializing with the previous
        # batch's dispatch), and results are collected once more than
        # LOOKAHEAD dispatches are in flight (collect overlaps with the
        # queued batches' compute).  Both ends bounded: host and device
        # memory stay O(LOOKAHEAD), not O(reads).
        def stage(base):
            group = recs[base:base + batch]
            arr = np.full((batch, L), 4, dtype=np.int8)
            lens = np.zeros(batch, dtype=np.int32)
            for i, r in enumerate(group):
                n = min(len(r.seq), L)
                arr[i, :n] = r.seq[:n]
                lens[i] = n
            qv = None
            if self.use_qv:
                q1, q2 = self.pack_qv_rows(group, batch, L)
                qv = (jax.device_put(q1), jax.device_put(q2))
            return (group, arr, lens,
                    jax.device_put(arr), jax.device_put(lens), qv)

        def collect(group, arr, lens, qv, res):
            with self.metrics.clock("collectAlignments"):
                res = unpack_batch(res)
                # dense rerun only when an overflowed traceback can reach
                # the output: candidates without a traceback slot are
                # dropped at collection, so their truncation is harmless
                # (junk placements routinely overflow; a whole-batch rerun
                # for them doubled device time)
                if (res.overflow & res.valid & (res.dp_slot >= 0)).any():
                    with self.metrics.clock("mapToGenome"):
                        res = unpack_batch(
                            dispatch(arr, lens, tb_cap=T, qv=qv))
                out.extend(self._collect_batch(res, group, lens, batch))
            self.metrics.add("numReads", len(group))
            self.metrics.add("totalAnchors", int(res.n_anchors.sum()))
            self.metrics.add("totalCandidates", int(res.valid.sum()))
            self.metrics.add(
                "cells", int((res.q_end - res.q_start)[res.valid].sum())
                * cfg.band_width)

        LOOKAHEAD = 4
        bases = list(range(0, len(recs), batch))
        staged = {i: stage(b) for i, b in enumerate(bases[:LOOKAHEAD])}
        pending = []
        for i in range(len(bases)):
            if i + LOOKAHEAD < len(bases):
                staged[i + LOOKAHEAD] = stage(bases[i + LOOKAHEAD])
            group, arr, lens, arr_d, lens_d, qv = staged.pop(i)
            with self.metrics.clock("mapToGenome"):
                res = dispatch(arr_d, lens_d, qv=qv)
            # start the device->host copy of the fused result buffer now:
            # it queues behind this batch's compute and streams back while
            # later batches run, so collect()'s np.asarray doesn't wait
            # for a whole transfer per batch
            if res.flat is not None and hasattr(res.flat,
                                               "copy_to_host_async"):
                try:
                    res.flat.copy_to_host_async()
                except Exception:
                    pass  # backend without async D2H: collect fetches
            pending.append((group, arr, lens, qv, res))
            if len(pending) > LOOKAHEAD:
                collect(*pending.pop(0))
        for item in pending:
            collect(*item)
        return out

    def _collect_batch(self, res: BatchResult, group: Sequence[FastaRecord],
                       lens: np.ndarray, B: int) -> List[List[Alignment]]:
        """Collect one batch's alignments (the host side of the per-ZMW
        print loop, Blasr.cpp:832-840): a vectorized candidate survey,
        per-read pruning on cheap fields, then ONE native call assembling
        every surviving CIGAR (run-for-run identical to the per-candidate
        path; tests/test_pipeline.py pins the decoder)."""
        p = self.params
        seqdb = self.gi.seqdb
        C = res.score.shape[1]
        valid = res.valid & (res.dp_slot >= 0)
        if p.forward_only:
            valid[B:] = False
        # contig lookup + boundary-crossing drop: one searchsorted for the
        # whole batch instead of one per candidate
        starts = seqdb.starts
        ci = np.clip(np.searchsorted(starts, res.t_start, side="right") - 1,
                     0, seqdb.n_contigs - 1)
        lo = starts[ci]
        valid &= res.t_end <= lo + seqdb.lengths[ci]
        # bulk scalar conversion: list indexing in the loops below is ~10x
        # cheaper than per-element numpy scalar reads
        valid_l = valid.tolist()
        qa_l, qb_l = res.q_start.tolist(), res.q_end.tolist()
        te_l, lo_l = res.t_end.tolist(), lo.tolist()
        ts_l = res.t_start.tolist()
        sc_l, ch_l = res.score.tolist(), res.chain_score.tolist()
        nm_l, nx_l = res.n_match.tolist(), res.n_mismatch.tolist()
        ni_l, nd_l = res.n_ins.tolist(), res.n_del.tolist()
        ci_l, slot_l = ci.tolist(), res.dp_slot.tolist()
        # an empty traceback (no blocks) starts with op 0 in halfword 0
        has_runs = ((res.ops[:, 0] & 3) != 0).tolist()
        names, tlens = seqdb.names, seqdb.lengths
        from blasr_tpu.pipeline.select import (
            num_significant_clusters, prune_alignments)
        out: List[List[Alignment]] = []
        deferred: List[tuple] = []  # (alignment, traceback slot)
        for i, rec in enumerate(group):
            rlen = int(lens[i])
            self._anchor_totals[id(rec)] = (
                int(res.n_anchors[i]) + int(res.n_anchors[i + B]),
                int(res.n_clipped[i]) + int(res.n_clipped[i + B]))
            alns: List[Alignment] = []
            slot_of: Dict[int, int] = {}
            for strand in (0, 1):
                row = i + strand * B
                vrow, qar, qbr = valid_l[row], qa_l[row], qb_l[row]
                for c in range(C):
                    if not vrow[c]:
                        continue
                    qa, qb = qar[c], qbr[c]
                    cidx = ci_l[row][c]
                    clo = lo_l[row][c]
                    slot = slot_l[row][c]
                    if strand == 0:
                        qs, qe = qa, qb
                    else:
                        qs, qe = rlen - qb, rlen - qa
                    a = Alignment(
                        qname=rec.name if rec.name else f"read/{i}",
                        qlen=rlen, qstart=qs, qend=qe, strand=strand,
                        tindex=cidx, tname=names[cidx],
                        tlen=int(tlens[cidx]),
                        tstart=ts_l[row][c] - clo, tend=te_l[row][c] - clo,
                        score=float(sc_l[row][c]),
                        n_match=nm_l[row][c], n_mismatch=nx_l[row][c],
                        n_ins=ni_l[row][c], n_del=nd_l[row][c],
                        cigar=_CIGAR_PENDING if has_runs[slot] else [],
                        read=rec.seq, qual=rec.qual,
                        tracks=getattr(rec, "tracks", None),
                        cluster_weight=float(ch_l[row][c]),
                        band_width=self.cfg.band_width,
                    )
                    alns.append(a)
                    slot_of[id(a)] = slot
            # alignment-level pruning (RemoveLowQualitySDPAlignments /
            # RemoveLowQualityAlignments / RemoveOverlappingAlignments,
            # BlasrUtilsImpl.hpp:447-605); needs no CIGAR beyond the
            # has-blocks bit, so assembly is deferred to the survivors
            alns = prune_alignments(alns, p, read_len=rlen)
            deferred.extend((a, slot_of[id(a)]) for a in alns)
            # anchor-distribution significance gate ->
            # numSignificantClusters (BlasrAlignImpl.hpp:391-488); the
            # cluster list is the gate-passing examined-cluster chain
            # weights of both strands
            cl = np.concatenate([
                res.cluster_bases[i][res.cluster_valid[i]],
                res.cluster_bases[i + B][res.cluster_valid[i + B]]])
            nsig = num_significant_clusters(alns, cl, p, k=self.gi.k)
            for a in alns:
                a.n_candidates = len(alns)
                a.n_significant_clusters = nsig
            out.append(alns)
        self._materialize_cigars(res.ops, deferred)
        if p.verbosity >= 1:
            # interval prints (reference -V, BlasrAlignImpl.hpp:260-277);
            # -V >=3 routes them to a per-process pid.shard.log file
            # (Blasr.cpp:757-764) and -V >=2 adds the sequence dumps
            w = self._vlog().write
            if p.verbosity >= 2:
                from blasr_tpu.io.fasta import decode
                for i, rec in enumerate(group):
                    w(f"read {rec.name if rec.name else f'read/{i}'} "
                      f"{int(lens[i])}\n{decode(rec.seq[:int(lens[i])])}\n")
            for alns in out:
                for a in alns:
                    w(f"interval {a.qname} {a.qstart} {a.qend} {a.tname} "
                      f"{a.tstart} {a.tend} {int(a.score)} {a.strand}\n")
        return out

    def _vlog(self):
        """Verbose-log sink: stderr for -V 1/2, a per-process
        ``<pid>.<shard>.log`` file for -V >=3 (the reference opens one
        log per worker thread, Blasr.cpp:757-764)."""
        import sys
        if self.params.verbosity < 3:
            return sys.stderr
        if self._vlog_file is None:
            shard = os.environ.get("BLASR_TPU_HOST_ID", "0")
            self._vlog_file = open(f"{os.getpid()}.{shard}.log", "a")
        return self._vlog_file

    def _materialize_cigars(self, ops: np.ndarray,
                            deferred: List[tuple]) -> None:
        """Assemble CIGAR runs for (alignment, slot) pairs — one native
        call for the whole batch, per-slot fallback without the
        extension."""
        if not deferred:
            return
        p = self.params
        batch = None
        try:
            from blasr_tpu.native import cigar_native_batch
            slots = np.fromiter((s for _, s in deferred), dtype=np.int64,
                                count=len(deferred))
            batch = cigar_native_batch(ops, slots, p.allow_adjacent_indels)
        except Exception:
            batch = None
        if batch is not None:
            ops_b, cnt_b, offs = batch
            for j, (a, _) in enumerate(deferred):
                a.cigar = LazyCigar(ops_b[offs[j]:offs[j + 1]],
                                    cnt_b[offs[j]:offs[j + 1]])
        else:
            for a, slot in deferred:
                cg = pairs_to_cigar(ops[slot])
                if not p.allow_adjacent_indels:
                    cg = merge_adjacent_indels(cg)
                a.cigar = cg
        if p.cigar_use_seq_match:
            from blasr_tpu.io.fasta import revcomp
            for a, _ in deferred:
                if a.strand == 0:
                    oq, qa = a.read, a.qstart
                else:
                    oq, qa = revcomp(a.read[:a.qlen]), a.qlen - a.qend
                gs = self.gi.seqdb.chrom_to_genome(a.tindex, a.tstart)
                a.cigar = split_match_runs(
                    a.cigar, oq[qa:qa + (a.qend - a.qstart)],
                    self.gi.genome[gs:gs + (a.tend - a.tstart)])

    def _max_seed_depth(self, rec: FastaRecord) -> int:
        """Deepest k-mer occurrence count along a read, BOTH orientations
        (host-side; feeds the ambiguity rescue's emit-all occurrence
        capacity).  The index is forward-strand only, so a reverse-strand
        read's own k-mers barely hit it — the rc probe is what sees the
        true depth (a strand-1 tandem read measured depth 3 vs ~100)."""
        fwd = np.asarray(rec.seq)
        comp = np.array([3, 2, 1, 0, 4], dtype=fwd.dtype)
        rc = comp[fwd[::-1]]
        return max(self._max_seed_depth_1(fwd),
                   self._max_seed_depth_1(rc))

    def _max_seed_depth_1(self, seq: np.ndarray) -> int:
        gi = self.gi
        k = gi.k
        if len(seq) < k:
            return 0
        keys = np.zeros(len(seq) - k + 1, dtype=np.int64)
        ok = np.ones(len(seq) - k + 1, dtype=bool)
        for j in range(k):
            c = seq[j: j + len(keys)].astype(np.int64)
            keys = (keys << 2) | (c & 3)
            ok &= c < 4
        if not ok.any():
            return 0
        keys = keys[ok]
        if gi.bucket_starts is not None:
            nocc = (gi.bucket_starts[keys + 1].astype(np.int64)
                    - gi.bucket_starts[keys].astype(np.int64))
        else:
            ks = gi.keys_sorted
            nocc = (np.searchsorted(ks, keys.astype(np.uint32), "right")
                    - np.searchsorted(ks, keys.astype(np.uint32), "left"))
        # only depths the emitter would accept (over-abundant seeds are
        # skipped outright by maxAnchorsPerPosition)
        mapp = self.params.max_anchors_per_position
        if mapp:
            nocc = nocc[nocc <= mapp]
        return int(nocc.max()) if nocc.size else 0

    def _expanded(self, expand: int) -> "Mapper":
        """Mapper with anchoring loosened by 2^expand (the reference's
        expand parameter widens SA search bounds per retry)."""
        cfg = dataclasses.replace(
            self.cfg,
            occ_per_pos=self.cfg.occ_per_pos * 2 ** expand,
            max_anchors=self.cfg.max_anchors * 2 ** expand)
        return Mapper(self.gi, self.params, cfg, metrics=self.metrics,
                      dev=self.dev)

    def map_reads(self, recs: Sequence[FastaRecord]) -> List[List[Alignment]]:
        """Map reads; returns per-read alignment lists in input order."""
        p = self.params
        self._anchor_totals.clear()
        order: Dict[int, List[Alignment]] = {}
        kept = [(j, r) for j, r in enumerate(recs)
                if len(r.seq) >= p.min_read_length
                and (p.max_read_length == 0 or len(r.seq) <= p.max_read_length)]
        for j in range(len(recs)):
            order[j] = []
        # reads beyond the largest bucket take the segment+stitch path
        long_items = [(j, r) for j, r in kept
                      if len(r.seq) > self.cfg.buckets[-1]]
        kept = [(j, r) for j, r in kept
                if len(r.seq) <= self.cfg.buckets[-1]]
        buckets: Dict[int, List] = {}
        for j, r in kept:
            b = self.cfg.bucket_for(len(r.seq))
            buckets.setdefault(b, []).append((j, r))
        # the initial pass runs at expansion level minExpand (the
        # reference's expand loop starts there, BlasrAlignImpl.hpp:24,
        # RegisterBlasrOptions.h --minExpand)
        first = self if p.min_expand == 0 else self._expanded(p.min_expand)
        if len(buckets) > 1:
            # compile the used buckets concurrently (XLA releases the
            # GIL): cold multi-bucket warmup in max() not sum() time
            first.warmup(sorted(buckets))
        for b, items in sorted(buckets.items()):
            batch = first.batch_size_for(b)
            results = first._run_bucket([r for _, r in items], b, batch)
            for (j, _), alns in zip(items, results):
                order[j] = alns
        # expand-retry loop (reference minExpand..maxExpand,
        # BlasrAlignImpl.hpp:319-336): reads with no alignment are retried
        # with progressively looser anchoring (more seed occurrences and
        # anchor capacity per retry)
        for expand in range(p.min_expand + 1, p.max_expand + 1):
            misses = [(j, r) for j, r in kept if not order[j]]
            if not misses:
                break
            retry = self._expanded(expand)
            rbuckets: Dict[int, List] = {}
            for j, r in misses:
                rbuckets.setdefault(
                    retry.cfg.bucket_for(len(r.seq)), []).append((j, r))
            for b, items in sorted(rbuckets.items()):
                batch = retry.batch_size_for(b)
                results = retry._run_bucket([r for _, r in items], b, batch)
                for (j, _), alns in zip(items, results):
                    order[j] = alns
        # anchor-ambiguity rescue (unrolled/repetitive templates,
        # ctest/bug25328.t): the reference's default emits every SA
        # occurrence per position (maxAnchorsPerPosition=10000,
        # MappingParameters.h:731), so its base pass resolves highly
        # repetitive templates that occ_per_pos sampling cannot.  Reads
        # whose anchor search saturated the capacity yet produced no
        # alignment get one deep-occurrence retry.
        if self._ambiguity_rescue:
            def coverage(j, r):
                if not order[j]:
                    return 0.0
                return max(a.qend - a.qstart for a in order[j]) / len(r.seq)

            def ambiguous(j, rlen):
                """Best placement has a distinct-locus competitor that is
                either within 15% of its score, or TRUNCATED but per-base
                competitive (full-span extrapolation would beat the best,
                and its identity is at least the best's): occurrence
                sampling may have starved the true copy's anchors, handing
                the win to a fully-anchored wrong copy via chain coverage
                (the reference never has this failure mode because it
                emits every occurrence — repeat microbench: 20/24 own-copy
                default vs 24/24 emit-all; 150-copy tandem diag: the true
                chain interval often starts mid-read)."""
                alns = order[j]
                if not alns or len(alns) < 2:
                    return False
                best = min(alns, key=lambda a: a.score)
                bspan = max(best.qend - best.qstart, 1)
                for a in alns:
                    if a is best:
                        continue
                    distinct = (a.tindex != best.tindex
                                or a.strand != best.strand)
                    if not distinct:
                        ov = (min(a.tend, best.tend)
                              - max(a.tstart, best.tstart))
                        distinct = 2 * ov < min(a.tend - a.tstart,
                                                best.tend - best.tstart)
                    if not distinct:
                        continue
                    if a.score <= best.score * 0.85:
                        return True
                    span = max(a.qend - a.qstart, 1)
                    if (span < 0.9 * rlen and span < bspan
                            and a.pct_similarity
                            >= best.pct_similarity - 2.0
                            and (a.score / span) * rlen < best.score):
                        return True
                return False

            deep = []
            for j, r in kept:
                total, clipped = self._anchor_totals.get(id(r), (0, 0))
                if clipped > max(total, 64) and coverage(j, r) < 0.5:
                    deep.append((j, r))
                elif clipped > 0 and ambiguous(j, len(r.seq)):
                    deep.append((j, r))
                elif clipped > 16 * max(total, 64):
                    # the read lives inside a deep repeat family (nearly
                    # every seed clipped): sampling may have handed the
                    # win to a wrong copy without leaving a visible
                    # competitor, so no score-based trigger can fire.
                    # The retry's result only replaces on a strictly
                    # better score, so this can't hurt accuracy.
                    deep.append((j, r))
            if deep:
                # raise the occurrence capacity to the deepest observed
                # seed depth among the rescued reads (bounded by
                # --maxAnchorsPerPosition and a device-memory cap),
                # rounded to a power of two so retry shapes stay reusable
                # — emit-all semantics where the heuristic fired
                # (reference default maxAnchorsPerPosition=10000)
                depth = max(self._max_seed_depth(r) for _, r in deep)
                mapp = self.params.max_anchors_per_position or 1024
                occ = min(max(48, depth), mapp, 1024)
                occ = 1 << (occ - 1).bit_length()
                dcfg = dataclasses.replace(
                    self.cfg,
                    occ_per_pos=max(occ, self.cfg.occ_per_pos),
                    max_anchors=max(2048, self.cfg.max_anchors),
                    # a 150-copy family competes for candidate slots;
                    # 10 of ~150 near-ties rarely include the true copy
                    # even with drift-penalized ranking
                    n_candidates=max(32, self.cfg.n_candidates),
                    full_widen=True)
                # the deep pass also ranks candidates drift-penalized:
                # with emit-all anchors every repeat copy chains to a
                # near-tie and mosaic chains hop copies for free, so the
                # true copy often misses the top-C cut (150-copy tandem
                # diag).  The rescue is already beyond reference
                # semantics; penalized ranking here leaves the default
                # pass reference-faithful while making the retry actually
                # resolve what it was invoked for.
                p_deep = (p if p.candidate_drift_penalty > 0 else
                          dataclasses.replace(
                              p, candidate_drift_penalty=1.0))
                dm = Mapper(self.gi, p_deep, dcfg, metrics=self.metrics,
                            dev=self.dev)
                dm._ambiguity_rescue = False
                with self.metrics.clock("ambiguityRescue"):
                    res = dm.map_reads([r for _, r in deep])
                for (j, r), alns in zip(deep, res):
                    if alns and (not order[j] or
                                 min(a.score for a in alns)
                                 < min(a.score for a in order[j])):
                        order[j] = alns
                    elif alns and p.full_span_mapqv:
                        # --fullSpanMapQV: the deep pass aligned every
                        # candidate against the FULL read span; even when
                        # its best does not beat the original, its
                        # near-tie competitors are the phase-ambiguity
                        # evidence the mapQV partition needs (reference
                        # AlignIntervals semantics).  Merge non-duplicate
                        # placements.
                        def dup(a, existing):
                            for e in existing:
                                if (e.strand == a.strand
                                        and e.tindex == a.tindex
                                        and abs(e.tstart - a.tstart) < 128):
                                    return True
                            return False
                        extra = [a for a in alns if not dup(a, order[j])]
                        if extra:
                            order[j] = order[j] + extra
        if self.rescue is not None:
            # cross-index rescue: unmapped or weak (< 72% similar) reads
            # re-map on the sensitive index; the better score wins
            weak = [(j, r) for j, r in kept
                    if not order[j]
                    or max(a.pct_similarity for a in order[j]) < 72.0]
            if weak:
                with self.metrics.clock("rescue"):
                    res = self.rescue.map_reads([r for _, r in weak])
                for (j, r), alns in zip(weak, res):
                    if alns and (not order[j]
                                 or min(a.score for a in alns)
                                 < min(a.score for a in order[j])):
                        order[j] = alns
        if p.do_sensitive_search:
            # --useSensitiveSearch (Blasr.cpp:404-414): reads that are
            # unmapped or whose best alignment is < 80% similar are re-run
            # with SetForSensitivity parameters (advanceExactMatches=0 +
            # looser anchoring); the sensitive result replaces the first
            # when it finds anything
            weak = [(j, r) for j, r in kept
                    if not order[j]
                    or max(a.pct_similarity for a in order[j]) < 80.0]
            if weak:
                sp = dataclasses.replace(p, advance_exact_matches=0,
                                         do_sensitive_search=False)
                scfg = dataclasses.replace(
                    self.cfg, occ_per_pos=self.cfg.occ_per_pos * 2,
                    max_anchors=self.cfg.max_anchors * 2)
                sens = Mapper(self.gi, sp, scfg, metrics=self.metrics,
                              dev=self.dev)
                for (j, r), alns in zip(
                        weak, sens.map_reads([r for _, r in weak])):
                    if alns:
                        order[j] = alns
        if long_items:
            from blasr_tpu.pipeline.longread import map_long_reads
            with self.metrics.clock("longReads"):
                res = map_long_reads(self, [r for _, r in long_items], p)
            for (j, _), alns in zip(long_items, res):
                order[j] = alns
        if p.extend_alignments:
            from blasr_tpu.pipeline.extend import extend_alignment
            with self.metrics.clock("extendAlignments"):
                for alns in order.values():
                    for a in alns:
                        extend_alignment(a, self.gi, p)
        return [order[j] for j in range(len(recs))]

    def dump_debug(self, recs: Sequence[FastaRecord],
                   anchors_out=None, clusters_out=None) -> None:
        """Debug taps: raw anchor dump (--anchors,
        BlasrAlignImpl.hpp:62-87) and per-read cluster statistics
        (--clusters, Blasr.cpp:1197-1204, BlasrAlignImpl.hpp:465-486)."""
        from blasr_tpu.kernels.anchor import find_anchors
        from blasr_tpu.kernels.chain import chain_anchors
        cfg, p = self.cfg, self.params
        if clusters_out is not None:
            clusters_out.write(
                "nBases qLength tLength nAnchors\n")
        for rec in recs:
            L = cfg.bucket_for(len(rec.seq))
            arr = np.full((1, L), 4, dtype=np.int8)
            n = min(len(rec.seq), L)
            arr[0, :n] = rec.seq[:n]
            reads2 = jnp.concatenate(
                [jnp.asarray(arr), _revcomp_batch(
                    jnp.asarray(arr), jnp.asarray([n], jnp.int32))])
            rlen2 = jnp.asarray([n, n], jnp.int32)
            anchors = find_anchors(
                self.dev.genome, self.dev.keys_sorted, self.dev.pos_sorted,
                reads2, rlen2, k=self.gi.k, occ_per_pos=cfg.occ_per_pos,
                max_anchors=cfg.max_anchors, anchor_ext=cfg.anchor_ext,
                min_match=p.min_match_length,
                max_anchors_per_pos=p.max_anchors_per_position,
                max_lcp=p.max_match_length,
                bucket_starts=self.dev.bucket_starts,
                bucket_pairs=self.dev.bucket_pairs,
                gwords=self.dev.gwords, gnwords=self.dev.gnwords)
            if anchors_out is not None:
                q = np.asarray(anchors.q)
                t = np.asarray(anchors.t)
                ln = np.asarray(anchors.l)
                v = np.asarray(anchors.valid)
                for strand in (0, 1):
                    for q_, t_, l_ in zip(q[strand][v[strand]],
                                          t[strand][v[strand]],
                                          ln[strand][v[strand]]):
                        anchors_out.write(
                            f"{rec.name} {int(q_)} {int(t_) - 1} {int(l_)} "
                            f"{strand}\n")
            if clusters_out is not None:
                cands = chain_anchors(anchors, rlen2, n_cand=cfg.n_candidates,
                                      indel_rate=p.indel_rate,
                                      global_chain=p.global_chain_type >= 1)
                sc = np.asarray(cands.score)
                na = np.asarray(cands.n_anchors)
                cv = np.asarray(cands.valid)
                for strand in (0, 1):
                    for c in range(sc.shape[1]):
                        if cv[strand, c]:
                            clusters_out.write(
                                f"{int(sc[strand, c])} {n} "
                                f"{int(self.gi.glen)} "
                                f"{int(na[strand, c])}\n")
