"""Ultra-long-read handling: segment, map, stitch.

The reference handles unbounded read lengths with per-read dynamic
allocation; the device pipeline works on fixed length buckets.  Reads longer
than the largest bucket are split into overlapping segments, each segment
maps through the standard pipeline, and collinear segment alignments are
stitched back into one alignment (coordinates shifted by segment origin,
the query overlap trimmed from the later segment's CIGAR).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from blasr_tpu.io.fasta import FastaRecord
from blasr_tpu.pipeline.map_read import Alignment, merge_adjacent_indels

OVERLAP = 512
GAP_MAX_Q = 512    # bridgeable query gap between collinear pieces
GAP_DRIFT = 400    # |target gap - query gap| bound for a bridge


def split_read(rec: FastaRecord, seg_len: int,
               overlap: int = OVERLAP) -> List[Tuple[int, FastaRecord]]:
    """[(offset, segment record)] covering the read with overlaps."""
    n = len(rec.seq)
    step = seg_len - overlap
    out = []
    off = 0
    while off < n:
        end = min(off + seg_len, n)
        out.append((off, FastaRecord(
            f"{rec.title}|seg{off}", rec.seq[off:end],
            rec.qual[off:end] if rec.qual is not None else None)))
        if end >= n:
            break
        off += step
    return out


def trim_cigar_query_start(cigar: List, n: int):
    """Drop the first n query-consuming columns.  Returns
    (new_cigar, q_trimmed, t_trimmed, (match, mismatch, ins) removed upper
    bounds) or None if the CIGAR can't supply n query bases cleanly.

    Index-based scan (round 5): the pop(0) version was O(runs^2) per trim
    and dominated long-read stitch time (7.2M pops / 32 reads profiled)."""
    runs = cigar if isinstance(cigar, list) else list(cigar)
    q_rm = t_rm = m_rm = i_rm = 0
    i, N = 0, len(runs)
    head = None  # partially-consumed first surviving run
    while i < N and q_rm < n:
        op, cnt = runs[i]
        if op in "M=X":
            take = min(cnt, n - q_rm)
            q_rm += take
            t_rm += take
            m_rm += take
            if take == cnt:
                i += 1
            else:
                head = (op, cnt - take)
                i += 1
        elif op == "I":
            take = min(cnt, n - q_rm)
            q_rm += take
            i_rm += take
            if take == cnt:
                i += 1
            else:
                head = (op, cnt - take)
                i += 1
        elif op in "DN":
            t_rm += cnt
            i += 1
        else:
            return None
    if q_rm < n:
        return None
    # don't start on a gap op
    while head is None and i < N and runs[i][0] in "DN":
        t_rm += runs[i][1]
        i += 1
    if head is None and i >= N:
        return None
    out = runs[i:]
    if head is not None:
        out.insert(0, head)
    return out, q_rm, t_rm, (m_rm, i_rm)


def trim_cigar_target_start(cigar: List, n: int):
    """Drop the first n target-consuming columns.  Returns
    (new_cigar, q_trimmed, match_trimmed) or None.  Leading query-only
    (I) columns swallowed along the way count toward q_trimmed.
    Index-based for the same reason as trim_cigar_query_start."""
    runs = cigar if isinstance(cigar, list) else list(cigar)
    q_rm = t_rm = m_rm = 0
    i, N = 0, len(runs)
    head = None
    while i < N and t_rm < n:
        op, cnt = runs[i]
        if op in "M=X":
            take = min(cnt, n - t_rm)
            t_rm += take
            q_rm += take
            m_rm += take
            if take == cnt:
                i += 1
            else:
                head = (op, cnt - take)
                i += 1
        elif op in "DN":
            take = min(cnt, n - t_rm)
            t_rm += take
            if take == cnt:
                i += 1
            else:
                head = (op, cnt - take)
                i += 1
        elif op == "I":
            q_rm += cnt
            i += 1
        else:
            return None
    if t_rm < n or (head is None and i >= N):
        return None
    out = runs[i:]
    if head is not None:
        out.insert(0, head)
    return out, q_rm, m_rm


def stitch_segments(
    rec: FastaRecord,
    seg_alns: List[Tuple[int, List[Alignment]]],
    params,
) -> List[Alignment]:
    """Merge per-segment alignments of one long read.

    The merge runs in *oriented* coordinates (strand-local query
    positions increase with target positions on both strands, and CIGARs
    are stored in oriented order), so one pass handles both strands:
    overlap trimmed from the later piece's CIGAR, small target gaps kept
    as deletions."""
    qlen = len(rec.seq)
    shifted: List[Alignment] = []
    for off, alns in seg_alns:
        for a in alns[: params.n_best]:
            shifted.append(dataclasses.replace(
                a, qname=rec.name, qlen=qlen,
                qstart=a.qstart + off, qend=a.qend + off))
    # oriented query start: increases with tstart on both strands
    def qo(a):
        return a.qstart if a.strand == 0 else qlen - a.qend

    def qo_end(a):
        return a.qend if a.strand == 0 else qlen - a.qstart

    shifted.sort(key=lambda a: (a.strand, a.tindex, qo(a), a.tstart))

    merged: List[Alignment] = []
    bridged = set()
    for a in shifted:
        ok = False
        # try every open piece (newest first): a spurious interleaved hit
        # must not break the collinear chain
        for mi in range(len(merged) - 1, -1, -1):
            m = merged[mi]
            if not (m.strand == a.strand and m.tindex == a.tindex):
                continue
            q_overlap = qo_end(m) - qo(a)
            # positive: trim the duplicated overlap from a's CIGAR.
            # negative: a query gap (both pieces clipped noisy ends) —
            # bridgeable below.  Indel drift makes both inexact.
            if q_overlap > 2 * OVERLAP or -q_overlap > GAP_MAX_Q:
                continue
            if q_overlap >= qo_end(a) - qo(a):
                # the chain already covers a's whole query span (duplicate
                # same-locus piece, e.g. a segment's secondary hit): the
                # trim below would consume the entire CIGAR and return
                # None — skip the O(runs) walk (bit-identical; this was
                # 2/3 of all trim calls in the 32-read profile)
                continue
            if q_overlap >= 0:
                trimmed = trim_cigar_query_start(a.cigar or [], q_overlap)
                if trimmed is None:
                    continue
                new_cigar, _, t_rm, (m_rm, i_rm) = trimmed
                qg = 0
                t_gap = (a.tstart + t_rm) - m.tend
            else:
                new_cigar = list(a.cigar or [])
                m_rm = i_rm = 0
                qg = -q_overlap
                t_gap = a.tstart - m.tend
            extra_i = m_rm2 = 0
            if t_gap < 0:
                # indel drift in the trimmed overlap overshot the chain's
                # target end: drop the duplicated target columns; their
                # query bases become an insertion
                tt = trim_cigar_target_start(new_cigar, -t_gap)
                if tt is None:
                    continue
                new_cigar, extra_i, m_rm2 = tt
                t_gap = 0
            if abs(t_gap - qg) > GAP_DRIFT or t_gap > GAP_MAX_Q + GAP_DRIFT:
                continue
            gap_cigar = []
            if qg + extra_i:
                gap_cigar.append(("I", qg + extra_i))
            if t_gap:
                gap_cigar.append(("D", t_gap))
            # the trimmed overlap columns were matches in the earlier
            # piece: compensate with the matrix's match score; gap
            # bridges pay per-base indel penalties
            match_score = -params.score_matrix[0][0] \
                if params.score_matrix else 5
            merged[mi] = dataclasses.replace(
                m,
                qstart=min(m.qstart, a.qstart),
                qend=max(m.qend, a.qend),
                tend=a.tend,
                score=(m.score + a.score + match_score * m_rm
                       + params.insertion * (qg + extra_i)
                       + params.deletion * t_gap),
                n_match=m.n_match + max(a.n_match - m_rm - m_rm2, 0),
                n_mismatch=m.n_mismatch + a.n_mismatch,
                n_ins=m.n_ins + max(a.n_ins - i_rm, 0) + qg + extra_i,
                n_del=m.n_del + a.n_del + t_gap,
                cigar=(m.cigar or []) + gap_cigar + new_cigar,
            )
            if gap_cigar:
                bridged.add(mi)
            ok = True
            break
        if not ok:
            merged.append(a)
    if not getattr(params, "allow_adjacent_indels", False):
        # gap bridges emit I and D runs back to back; fold them into M
        # columns as the SAM printer contract requires
        # (ctest/cigarAdjecentIndels.t)
        merged = [dataclasses.replace(m, cigar=merge_adjacent_indels(m.cigar))
                  if i in bridged and m.cigar else m
                  for i, m in enumerate(merged)]
    merged.sort(key=lambda x: x.score)
    return merged


def map_long_reads(mapper, recs, params) -> List[List[Alignment]]:
    """Map reads longer than the largest bucket by segmenting + stitching."""
    seg_len = mapper.cfg.buckets[-1]
    out: List[List[Alignment]] = []
    flat: List[FastaRecord] = []
    index: List[List[Tuple[int, int]]] = []   # per read: (offset, flat idx)
    for rec in recs:
        segs = split_read(rec, seg_len)
        index.append([(off, len(flat) + i) for i, (off, _) in enumerate(segs)])
        flat.extend(s for _, s in segs)
    seg_results = mapper.map_reads(flat)
    for rec, segs in zip(recs, index):
        per_seg = [(off, seg_results[i]) for off, i in segs]
        out.append(stitch_segments(rec, per_seg, params))
    return out
