"""Batched anchor search on device.

Batched re-derivation of BLASR's ``MapBySuffixArray::MapReadToGenome``
(usage: iblasr/BlasrAlignImpl.hpp:34-58): for every read position, find
genome positions whose k-mer matches exactly, extend each hit maximally,
and emit (q, t, length) anchors subject to ``minMatchLength``,
``maxAnchorsPerPosition`` and containment pruning
(``RemoveOverlappingAnchors``, BlasrAlignImpl.hpp:143-148).

Instead of per-suffix binary search over a suffix array (pointer-chasing,
hostile to vector units), the genome is indexed as a *sorted fixed-k k-mer
table* (keys_sorted / pos_sorted, built in index/genome.py) and the whole
batch of read positions is resolved with two vectorized ``searchsorted``
calls; hit extension is a data-parallel compare over gathered genome
windows.  All shapes are static: [B, L] reads -> [B, A] anchors with
validity masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

BIG = jnp.int32(0x3FFFFFFF)


class Anchors(NamedTuple):
    """Fixed-capacity anchor set per read (sorted by t, invalid at end)."""

    q: jnp.ndarray       # int32 [B, A] read position
    t: jnp.ndarray       # int32 [B, A] genome position
    l: jnp.ndarray       # int32 [B, A] exact-match length
    valid: jnp.ndarray   # bool  [B, A]
    n_total: jnp.ndarray  # int32 [B] anchors found before capacity cap
    nlogp: jnp.ndarray   # float32 [B, A] -log P(anchor by chance): the
    #                      tuple-frequency significance weight
    #                      (LISPValueWeightor family, BlasrHeaders.h:54-57)
    # raw per-position hits before top-A selection / containment pruning:
    # the free SDP-fragment set reused by the band-guide densification
    # (position i, occurrence o) -> genome position hits_t[b, i, o]
    hits_t: jnp.ndarray = None      # int32 [B, L, O]
    hits_valid: jnp.ndarray = None  # bool [B, L, O]
    n_clipped: jnp.ndarray = None  # int32 [B] seed occurrences dropped by
    #                      the occ-per-position cap: the anchor-ambiguity
    #                      signal (the reference emits every occurrence,
    #                      maxAnchorsPerPosition=10000)


def read_kmer_keys(reads: jnp.ndarray, read_len: jnp.ndarray, k: int):
    """(keys [B,L] uint32, valid [B,L]) k-mer starting at every position."""
    B, L = reads.shape
    r = reads.astype(jnp.int32)
    keys = jnp.zeros((B, L), dtype=jnp.uint32)
    ok = jnp.ones((B, L), dtype=bool)
    for j in range(k):
        shifted = jnp.concatenate(
            [r[:, j:], jnp.full((B, j), 4, dtype=jnp.int32)], axis=1)
        keys = (keys << 2) | (shifted & 3).astype(jnp.uint32)
        ok &= shifted < 4
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    ok &= pos + k <= read_len[:, None]
    return keys, ok


@functools.partial(
    jax.jit,
    static_argnames=("k", "occ_per_pos", "max_anchors", "anchor_ext",
                     "min_match", "max_anchors_per_pos", "max_lcp",
                     "advance_exact", "occ_block_sample", "profile_stop"),
)
def find_anchors(
    genome: jnp.ndarray,        # int8 [G]
    keys_sorted: jnp.ndarray,   # uint32 [M]
    pos_sorted: jnp.ndarray,    # int32 [M]
    reads: jnp.ndarray,         # int8 [B, L]
    read_len: jnp.ndarray,      # int32 [B]
    *,
    k: int,
    occ_per_pos: int,
    max_anchors: int,
    anchor_ext: int,
    min_match: int,
    max_anchors_per_pos: int,
    max_lcp: int = 0,
    advance_exact: int = 0,
    # --advanceExactMatches E (RegisterBlasrOptions.h:64-65): after an
    # exact match of length l at read position q, skip query positions up
    # to q + l - E before seeding again — a speed knob trading sensitivity
    occ_block_sample: bool = False,
    # occurrence sampling layout: False = strided picket with rotating
    # phase (default; each over-abundant seed spreads its O samples
    # across the whole [lo, hi) range); True = a CONTIGUOUS window of O
    # occurrences whose base rotates with the read position — same
    # copy-coverage property across a read, but the record fetch becomes
    # ONE [O, 6]-slice gather per position (4x fewer gather descriptors;
    # the stage is gather-latency-bound)
    bucket_starts: jnp.ndarray = None,  # int32 [4^k+1] direct lookup table
    bucket_pairs: jnp.ndarray = None,   # int32 [4^k, 2] (start, end) rows:
    #                              one row-gather replaces the two element
    #                              gathers (the stage is latency-bound)
    gwords: jnp.ndarray = None,   # uint32 [G] packed 16-base genome words
    gnwords: jnp.ndarray = None,  # uint32 [G] non-ACGT bit pairs
    pos_records: jnp.ndarray = None,  # uint32 [M, 6] fused per-slot records
    #                              (DeviceIndex._build_records): one 24-byte
    #                              row gather replaces 6 scattered gathers
    profile_stop: int = 0,  # dev-only (tools/profile_anchor2.py): truncate
    #                              the graph after a sub-stage
) -> Anchors:
    """See module docstring.  Anchor significance: an anchor whose seed
    k-mer occurs n times in an M-position index and extends to length l
    has -log P = log(M/n) + (l-k)*log(4) — the occurrence count doubles
    as the reference's TupleCountTable frequency (Blasr.cpp:1136-1147)."""
    B, L = reads.shape
    G = genome.shape[0]
    O = occ_per_pos

    def _stop(*arrs):
        s = sum(jnp.sum(a.astype(jnp.float32)) for a in arrs)
        z = s.reshape(1, 1)
        return Anchors(q=z, t=z, l=z, valid=z, n_total=z, nlogp=z)

    keys, kvalid = read_kmer_keys(reads, read_len, k)
    if bucket_pairs is not None:
        # direct lookup table, paired rows: ONE contiguous 8-byte row
        # gather per position (device-native BuildLookupTable with
        # p == k, Blasr.cpp:1101)
        flatk = keys.reshape(-1).astype(jnp.int32)
        pair = jnp.take(bucket_pairs, flatk, axis=0)       # [B*L, 2]
        lo = pair[:, 0].reshape(B, L).astype(jnp.int32)
        hi = pair[:, 1].reshape(B, L).astype(jnp.int32)
    elif bucket_starts is not None:
        # direct lookup table: 2 gathers replace the binary search
        flatk = keys.reshape(-1).astype(jnp.int32)
        lo = jnp.take(bucket_starts, flatk).reshape(B, L).astype(jnp.int32)
        hi = jnp.take(bucket_starts, flatk + 1).reshape(B, L).astype(jnp.int32)
    else:
        flatk = keys.reshape(-1)
        lo = jnp.searchsorted(keys_sorted, flatk, side="left").reshape(B, L)
        hi = jnp.searchsorted(keys_sorted, flatk, side="right").reshape(B, L)
    if profile_stop == 1:
        return _stop(lo, hi, kvalid)
    nocc = (hi - lo).astype(jnp.int32)
    # maxAnchorsPerPosition: skip over-abundant seeds entirely
    # (AnchorParameters, RegisterBlasrOptions.h:104-106)
    pos_ok = kvalid & (nocc > 0) & (nocc <= max_anchors_per_pos)

    # expand each position into up to O occurrences.  When a seed has more
    # occurrences than O, sample them STRIDED across [lo, hi) rather than
    # taking the lowest-position prefix: the reference emits every
    # occurrence (maxAnchorsPerPosition=10000), and a prefix sample
    # systematically starves later copies of a repeat of their true-locus
    # anchors (reads from high-position copies then misplace onto the
    # first copy).
    # The stride phase rotates with the read position: with a constant
    # phase, seeds sharing one occurrence count (the common case inside a
    # repeat) would all sample the SAME subset of copies, and the unlucky
    # copies would get no anchors at all.
    occ = jnp.arange(O, dtype=jnp.int32)
    occ3 = occ[None, None, :]
    nocc3 = nocc[:, :, None]
    q = jax.lax.broadcasted_iota(jnp.int32, (B, L, O), 1)
    use_rec = (pos_records is not None and gwords is not None
               and anchor_ext <= 32)
    if occ_block_sample:
        # rotating contiguous window: O consecutive slots starting at a
        # q-rotating base inside [lo, hi-O]; any copy of a repeat gets
        # anchors from ~L/copies read positions, like the strided picket
        q2 = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        span = jnp.maximum(nocc - O + 1, 1)
        base = lo + jnp.where(nocc > O, (q2 * 97) % span, 0)
        idx = base[:, :, None] + occ3                      # [B, L, O]
        cand_valid = pos_ok[:, :, None] & (occ3 < nocc3)
        idx = jnp.clip(idx, 0, pos_sorted.shape[0] - 1)
        if profile_stop == 2:
            return _stop(idx, cand_valid)
        if use_rec:
            M_rows = pos_records.shape[0]
            starts = jnp.clip(base, 0, M_rows - O).reshape(-1, 1)
            dn = jax.lax.GatherDimensionNumbers(
                offset_dims=(1, 2), collapsed_slice_dims=(),
                start_index_map=(0,))
            rec = jax.lax.gather(
                pos_records, starts, dn,
                slice_sizes=(O, pos_records.shape[1]),
            ).reshape(B, L, O, pos_records.shape[1])
            t = rec[..., 0].astype(jnp.int32)
            gprev = rec[..., 1].astype(jnp.int32)
        else:
            rec = None
            t = jnp.take(pos_sorted, idx).astype(jnp.int32)
    else:
        # occ3*(nocc3//O) + (occ3*(nocc3%O))//O == (occ3*nocc3)//O without
        # the int32 overflow a huge maxAnchorsPerPosition could hit
        stride0 = occ3 * (nocc3 // O) + (occ3 * (nocc3 % O)) // O
        strided = (stride0 + q) % jnp.maximum(nocc3, 1)
        occ_off = jnp.where(nocc3 > O, strided, occ3)
        idx = lo[:, :, None] + occ_off                     # [B, L, O]
        cand_valid = pos_ok[:, :, None] & (occ3 < nocc3)
        idx = jnp.clip(idx, 0, pos_sorted.shape[0] - 1)
        if profile_stop == 2:
            return _stop(idx, cand_valid)
        if use_rec:
            rec = jnp.take(pos_records, idx, axis=0)       # [B, L, O, 6]
            t = rec[..., 0].astype(jnp.int32)
            gprev = rec[..., 1].astype(jnp.int32)
        else:
            rec = None
            t = jnp.take(pos_sorted, idx).astype(jnp.int32)

    if profile_stop == 3:
        return _stop(t, gprev if use_rec else t)
    # containment prune: if the previous diagonal position also matches,
    # this anchor is inside a longer one (RemoveOverlappingAnchors) —
    # except periodic representatives every E/2 positions, so exact runs
    # longer than the measured extension cap still chain to full span
    if not use_rec:
        gprev = jnp.take(genome, jnp.clip(t - 1, 0, G - 1)).astype(jnp.int32)
    rprev_2d = jnp.concatenate(
        [jnp.full((B, 1), 4, dtype=jnp.int32), reads[:, :-1].astype(jnp.int32)],
        axis=1)
    rprev = rprev_2d[:, :, None]  # [B, L, 1]: read[q-1] since q == position iota
    keep_stride = max(anchor_ext // 2, 1)
    periodic = q % keep_stride == 0
    contained = ((q > 0) & (t > 0) & (gprev == rprev) & (rprev < 4)
                 & ~periodic)
    cand_valid &= ~contained

    # forward extension: compare genome[t+k..] with read[q+k..]
    E = anchor_ext
    if gwords is not None:
        # word path: 16 bases per XOR + count-trailing-zeros, 2 gathers per
        # word instead of 16 byte gathers
        rw = jnp.zeros((B, L), dtype=jnp.uint32)
        rn = jnp.zeros((B, L), dtype=jnp.uint32)
        r32 = reads.astype(jnp.int32)
        for j16 in range(16):
            shifted = jnp.concatenate(
                [r32[:, j16:], jnp.full((B, j16), 4, jnp.int32)], axis=1)
            rw = rw | ((shifted & 3).astype(jnp.uint32) << (2 * j16))
            rn = rn | (jnp.where(shifted >= 4, jnp.uint32(3),
                                 jnp.uint32(0)) << (2 * j16))
        n_words = -(-E // 16)
        ext = jnp.zeros((B, L, O), dtype=jnp.int32)
        full_prev = jnp.ones((B, L, O), dtype=jnp.int32)
        allN = jnp.uint32(0xFFFFFFFF)
        for j in range(n_words):
            off = k + 16 * j
            if use_rec:
                gw_j = rec[..., 2 + 2 * j]
                gn_j = rec[..., 3 + 2 * j]
            else:
                gidx = jnp.clip(t + off, 0, G - 1)
                gw_j = jnp.take(gwords, gidx)
                gn_j = jnp.take(gnwords, gidx)
                gn_j = jnp.where(t + off < G, gn_j, allN)
            rw_sh = jnp.concatenate(
                [rw[:, off:], jnp.zeros((B, min(off, L)), jnp.uint32)],
                axis=1)[:, :L]
            rn_sh = jnp.concatenate(
                [rn[:, off:], jnp.full((B, min(off, L)), allN)],
                axis=1)[:, :L]
            diff = (gw_j ^ rw_sh[:, :, None]) | gn_j | rn_sh[:, :, None]
            lsb = diff & (~diff + jnp.uint32(1))
            tz = jax.lax.population_count(lsb - jnp.uint32(1))
            mlen = (tz >> 1).astype(jnp.int32)
            ext = ext + mlen * full_prev
            full_prev = full_prev * (mlen == 16).astype(jnp.int32)
        length = k + jnp.minimum(ext, E)
    else:
        e = jnp.arange(E, dtype=jnp.int32)
        gidx = t[..., None] + k + e                          # [B, L, O, E]
        gext = jnp.take(genome, jnp.clip(gidx, 0, G - 1)).astype(jnp.int32)
        gext = jnp.where(gidx < G, gext, 4)
        # read extension window: rext[b, i, e] = reads[b, i + k + e]
        pad = jnp.full((B, k + E), 4, dtype=jnp.int8)
        rpad = jnp.concatenate([reads, pad], axis=1)
        ridx = jnp.arange(L)[:, None] + k + e[None, :]       # [L, E]
        rext = rpad[:, ridx].astype(jnp.int32)               # [B, L, E]
        m = (gext == rext[:, :, None, :]) & (rext[:, :, None, :] < 4)
        run = jnp.cumprod(m.astype(jnp.int32), axis=-1)
        length = k + jnp.sum(run, axis=-1).astype(jnp.int32)  # [B, L, O]
    if max_lcp > 0:
        length = jnp.minimum(length, max_lcp)
    if profile_stop == 4:
        return _stop(length, cand_valid, t)
    cand_valid &= length >= min_match

    if advance_exact > 0:
        # suppress query positions inside any earlier anchor's exact run
        # (up to its length minus advance_exact): skip[q] iff
        # q < max_{j<q}(j + len_j - advance_exact)
        maxlen = jnp.max(jnp.where(cand_valid, length, 0), axis=2)  # [B, L]
        pos2 = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        reach = jnp.where(maxlen > 0, pos2 + maxlen - advance_exact, -1)
        reach_prev = jnp.concatenate(
            [jnp.full((B, 1), -1, jnp.int32),
             jax.lax.cummax(reach, axis=1)[:, :-1]], axis=1)
        cand_valid &= (pos2 >= reach_prev)[:, :, None]

    # anchor significance in nats (see docstring)
    LOG4 = jnp.float32(1.3862944)
    m_total = jnp.float32(pos_sorted.shape[0])
    seed_nlogp = jnp.log(m_total / jnp.maximum(nocc, 1).astype(jnp.float32))
    nlogp = seed_nlogp[:, :, None] + (length - k).astype(jnp.float32) * LOG4

    # top-A selection: valid first, longer first, equal lengths spread
    # across read positions by a bit-reversed (low-discrepancy) tie-break
    # (a full argsort, which fuses into the pipeline graph, rather than
    # lax.top_k).  A first-flat-index tie-break would cluster
    # the kept anchors at the read start whenever the anchor count
    # saturates max_anchors — on repetitive templates (all anchors the
    # same length, ctest/bug25328.t unrolled resequencing) that starves
    # the chain of coverage past the first few hundred bases.
    flat_valid = cand_valid.reshape(B, L * O)
    flat_len = length.reshape(B, L * O)
    flat_q = q.reshape(B, L * O)
    flat_t = t.reshape(B, L * O)
    flat_p = nlogp.reshape(B, L * O)
    nbits = max(1, (L * O - 1).bit_length())
    iota = np.arange(L * O, dtype=np.uint32)
    rev = np.zeros_like(iota)
    for b in range(nbits):
        rev |= ((iota >> b) & 1) << (nbits - 1 - b)
    spread = jnp.asarray(rev.astype(np.int32))[None, :]
    rank = jnp.where(flat_valid,
                     (-flat_len << nbits) + spread, BIG)
    order = jnp.argsort(rank, axis=1, stable=True)[:, :max_anchors]
    sel_q = jnp.take_along_axis(flat_q, order, axis=1)
    sel_t = jnp.take_along_axis(flat_t, order, axis=1)
    sel_l = jnp.take_along_axis(flat_len, order, axis=1)
    sel_v = jnp.take_along_axis(flat_valid, order, axis=1)
    sel_p = jnp.take_along_axis(flat_p, order, axis=1)
    if profile_stop == 5:
        return _stop(sel_q, sel_t, sel_l, sel_v, sel_p)
    n_total = jnp.sum(flat_valid, axis=1).astype(jnp.int32)
    n_clipped = jnp.sum(
        jnp.where(pos_ok, jnp.maximum(nocc - O, 0), 0),
        axis=1).astype(jnp.int32)

    # final order: by genome position (SortMatchPosList,
    # BlasrAlignImpl.hpp:92-95), invalid pushed to the end
    tkey = jnp.where(sel_v, sel_t, BIG)
    order2 = jnp.argsort(tkey, axis=1, stable=True)
    return Anchors(
        q=jnp.take_along_axis(sel_q, order2, axis=1),
        t=jnp.take_along_axis(sel_t, order2, axis=1),
        l=jnp.take_along_axis(sel_l, order2, axis=1),
        valid=jnp.take_along_axis(sel_v, order2, axis=1),
        n_total=n_total,
        n_clipped=n_clipped,
        nlogp=jnp.take_along_axis(sel_p, order2, axis=1),
        hits_t=t,
        hits_valid=pos_ok[:, :, None] & (occ[None, None, :] < nocc[:, :, None])
        & (length >= min_match),
    )
