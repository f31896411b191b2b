"""ZMW / subread machinery: grouping, template selection, concordant and
CCS mapping modes.

Re-derivations of:
  * subread grouping by hole number (ReaderAgglomerate GetNextBases ZMW
    grouping, Blasr.cpp:1321-1351)
  * ``GetIndexOfConcordantTemplate`` — median-length interior subread
    (BlasrMiscsImpl.hpp:152-179; FMR1 case tested by ctest/bamConcordant.t)
  * concordant mapping (MapReadsNonCCS concordant branch,
    Blasr.cpp:476-542): map the template, then align every other subread
    of the ZMW to each selected template target window (FlankTAlignedSeq
    +- flankSize, BlasrAlignImpl.hpp:1314-1353).
  * CCS all-pass/full-pass re-alignment (MapReadsCCS, Blasr.cpp:550-729):
    same machinery with the CCS read as template.

Batched shape: the per-ZMW target windows of a whole batch are concatenated
into a *mini genome index* (windows as contigs) and all subreads are
mapped against it with the standard device pipeline; alignments landing in
a foreign ZMW's window are dropped, and coordinates are translated back.
This turns the reference's per-subread GuidedAlign loop into one batched
device call.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from blasr_tpu.index.genome import build_genome_index
from blasr_tpu.io.fasta import FastaRecord
from blasr_tpu.params import MappingParams
from blasr_tpu.pipeline.map_read import Alignment, Mapper

_SUBREAD_RE = re.compile(r"^(.+)/(\d+)/(\d+)_(\d+)$")
_ZMW_RE = re.compile(r"^(.+)/(\d+)$")


def zmw_key(qname: str) -> str:
    """movie/holeNumber prefix identifying the ZMW, or the full name."""
    if qname.endswith("/ccs"):           # CCS read naming convention
        qname = qname[: -len("/ccs")]
    m = _SUBREAD_RE.match(qname)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    m = _ZMW_RE.match(qname)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    return qname


def subread_interval(qname: str) -> Optional[Tuple[int, int]]:
    m = _SUBREAD_RE.match(qname)
    if m:
        return int(m.group(3)), int(m.group(4))
    return None


def group_by_zmw(recs: Sequence[FastaRecord]) -> List[List[int]]:
    """Indices grouped by ZMW, preserving input order."""
    groups: Dict[str, List[int]] = {}
    order: List[str] = []
    for i, r in enumerate(recs):
        k = zmw_key(r.name)
        if k not in groups:
            order.append(k)
            groups[k] = []
        groups[k].append(i)
    return [groups[k] for k in order]


def concordant_template_index(group: List[FastaRecord],
                              mode: str = "mediansubread") -> int:
    """Template subread choice (GetIndexOfConcordantTemplate):
    median-length among *interior* subreads (first/last excluded when
    there are >= 3), or longest / typical."""
    n = len(group)
    if n == 1:
        return 0
    if n in (2,):
        lens = [len(g.seq) for g in group]
        return int(np.argmax(lens))
    interior = list(range(1, n - 1)) if n >= 3 else list(range(n))
    lens = sorted(interior, key=lambda i: len(group[i].seq))
    if mode == "longestsubread":
        return max(interior, key=lambda i: len(group[i].seq))
    if mode == "typicalsubread":
        # second longest interior (reference 'typical' behavior)
        ordered = sorted(interior, key=lambda i: -len(group[i].seq))
        return ordered[1] if len(ordered) > 1 else ordered[0]
    return lens[len(lens) // 2]  # mediansubread


@dataclass
class TargetWindow:
    zmw: str
    contig: int      # real-genome contig
    tstart: int      # forward contig coords (flanked)
    tend: int
    strand: int      # template alignment strand


def _pad_mini_index(mini):
    """Pad the mini-genome index arrays (genome, k-mer table, contig
    table) to power-of-two tiers so consecutive concordant/CCS window
    sets of similar size reuse ONE compiled executable instead of
    re-jitting per distinct shape (BAM-concordant throughput)."""
    import numpy as np

    def tier(n, lo):
        t = lo
        while t < n:
            t *= 2
        return t

    g = len(mini.genome)
    gp = tier(g, 4096)
    if gp > g:
        mini.genome = np.concatenate(
            [mini.genome, np.full(gp - g, 4, np.int8)])
    m = len(mini.keys_sorted)
    mp = tier(m, 1024)
    if mp > m:
        mini.keys_sorted = np.concatenate(
            [mini.keys_sorted,
             np.full(mp - m, 0xFFFFFFFF, np.uint32)])
        mini.pos_sorted = np.concatenate(
            [mini.pos_sorted, np.zeros(mp - m, mini.pos_sorted.dtype)])
        # the pad rows are not genome k-mer windows: the device-derive
        # path would reconstruct real keys at position 0 for them
        mini.synthetic_kmer_rows = True
    nc = mini.seqdb.n_contigs
    cp = tier(nc, 8)
    if cp > nc:
        pad = cp - nc
        end = int(len(mini.genome))
        mini.seqdb.names = list(mini.seqdb.names) + [
            f"~pad{j}" for j in range(pad)]
        mini.seqdb.starts = np.concatenate(
            [mini.seqdb.starts, np.full(pad, end, np.int64)])
        mini.seqdb.lengths = np.concatenate(
            [mini.seqdb.lengths, np.zeros(pad, np.int64)])
        mini.seqdb.md5s = list(mini.seqdb.md5s) + [""] * pad
    return mini


def map_concordant(
    mapper: Mapper,
    recs: Sequence[FastaRecord],
    params: MappingParams,
) -> List[List[Alignment]]:
    """Concordant mapping of a set of subread records.

    Returns per-input-record alignment lists (template alignments for the
    template subread; window-constrained alignments for the others).
    """
    groups = group_by_zmw(recs)
    templates = [
        g[concordant_template_index([recs[i] for i in g],
                                    params.concordant_template)]
        for g in groups]
    return _map_to_template_windows(mapper, recs, groups, templates, params)


def _map_to_template_windows(
    mapper: Mapper,
    recs: Sequence[FastaRecord],
    groups: List[List[int]],
    templates: List[int],
    params: MappingParams,
) -> List[List[Alignment]]:
    gi = mapper.gi
    out: List[List[Alignment]] = [[] for _ in recs]

    # 1) map each group's template with the full pipeline
    template_alns = mapper.map_reads([recs[t] for t in templates])

    # 2) build the mini genome of flanked target windows
    windows: List[TargetWindow] = []
    win_recs: List[FastaRecord] = []
    flank = params.flank_size
    for g, ti, alns in zip(groups, templates, template_alns):
        out[ti] = alns
        for a in alns[: params.n_best]:
            lo, hi = gi.seqdb.contig_bounds(a.tindex)
            ws = max(0, a.tstart - flank)
            we = min(hi - lo, a.tend + flank)
            gs = gi.seqdb.chrom_to_genome(a.tindex, ws)
            ge = gi.seqdb.chrom_to_genome(a.tindex, we)
            name = f"w{len(windows)}|{zmw_key(recs[ti].name)}"
            windows.append(TargetWindow(zmw_key(recs[ti].name), a.tindex,
                                        ws, we, a.strand))
            win_recs.append(FastaRecord(name, gi.genome[gs:ge].copy()))
    if not windows:
        return out

    # 3) map all non-template subreads against the window mini-genome
    mini = _pad_mini_index(build_genome_index(win_recs, k=min(12, gi.k)))
    sub_params = params.make_sane()
    mini_mapper = Mapper(mini, sub_params, mapper.cfg)
    queries = []
    qidx = []
    for g, ti in zip(groups, templates):
        for i in g:
            if i != ti:
                queries.append(recs[i])
                qidx.append(i)
    if not queries:
        return out
    results = mini_mapper.map_reads(queries)

    # 4) translate coordinates back, keeping only own-ZMW windows
    for i, alns in zip(qidx, results):
        my_zmw = zmw_key(recs[i].name)
        kept = []
        for a in alns:
            w = windows[a.tindex]
            if w.zmw != my_zmw:
                continue
            a.tindex = w.contig
            a.tname = gi.seqdb.names[w.contig]
            a.tlen = int(gi.seqdb.lengths[w.contig])
            a.tstart = w.tstart + a.tstart
            a.tend = w.tstart + a.tend
            kept.append(a)
        out[i] = kept
    return out


def map_ccs(
    mapper: Mapper,
    recs: Sequence[FastaRecord],
    params: MappingParams,
) -> List[List[Alignment]]:
    """CCS modes.  With use_ccs_only (de novo), the CCS/consensus read's own
    alignments are reported; with use_ccs / use_all_subreads_in_ccs the
    subread passes are re-aligned to the CCS target windows — which is the
    concordant machinery with the CCS read as template."""
    if params.use_ccs_only:
        return mapper.map_reads(recs)
    return map_concordant(mapper, recs, params)


def map_ccs_groups(
    mapper: Mapper,
    groups: Sequence[Tuple[FastaRecord, Sequence[FastaRecord]]],
    params: MappingParams,
) -> Tuple[List[FastaRecord], List[List[Alignment]]]:
    """CCS mapping from explicit (consensus, passes) groups (ccs.h5 with a
    Passes table — the CCSIterator/FragmentCCSIterator inputs,
    Blasr.cpp:639-708).  The consensus read is the template; each pass is
    re-aligned to the selected template windows.  Returns the flattened
    record list ([ccs, pass...] per group) and per-record alignments."""
    recs: List[FastaRecord] = []
    idx_groups: List[List[int]] = []
    templates: List[int] = []
    for ccs_rec, passes in groups:
        g = [len(recs)]
        recs.append(ccs_rec)
        templates.append(g[0])
        for p in passes:
            g.append(len(recs))
            recs.append(p)
        idx_groups.append(g)
    alns = _map_to_template_windows(mapper, recs, idx_groups, templates,
                                    params)
    return recs, alns
