"""STR mapQV microscope (round-5 finding; CPU-friendly).

Structured-soak calibration showed P(wrong | mapQV>=30) = 4.6e-02 with
most wrong placements being intra-array phase shifts (100-400 bp) inside
STR microsatellites.  This tool shows WHY the mapQV stays 254: the
phase-shifted competitors that reach the alignment list are TRUNCATED
fragments scoring hundreds of points worse than the best, not full-span
phase alternatives, so the likelihood partition gives the best member a
crushing margin.  The reference (AlignIntervals) aligns each candidate
interval against the full read span, producing near-tie full-span
competitors at every phase -> honestly low mapQV.  Candidate fix for
round 6: for reads whose best placement sits in deep-repeat context,
run competitor DPs with full-span widening (cfg.full_widen — machinery
exists, rescue-only today) before store_map_qvs.

    JAX_PLATFORMS=cpu python tools/diag_str.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax
    if "cpu" in str(__import__("os").environ.get("JAX_PLATFORMS", "")):
        jax.config.update("jax_platforms", "cpu")
    from blasr_tpu.sim import structured_genome, mutate
    from blasr_tpu.io.fasta import FastaRecord
    from blasr_tpu.index import build_genome_index
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper
    from blasr_tpu.pipeline.select import store_map_qvs

    contigs, feats = structured_genome(400_000, seed=5, n_str=3,
                                       str_len=(1500, 2000))
    strs = [f for f in feats if f.kind == "str"]
    print("strs:", [(f.start, f.end, f.end - f.start) for f in strs])
    gi = build_genome_index(contigs, k=12)
    p = MappingParams().make_sane()
    m = Mapper(gi, p, ShapeConfig(buckets=(1024,), batch_size=8))
    rng = np.random.default_rng(9)
    g = contigs[0].seq
    recs, truths = [], []
    for f in strs:
        for _ in range(3):
            rl = 600
            ts = int(rng.integers(f.start, max(f.start + 1, f.end - rl)))
            seq = mutate(g[ts:ts + rl], rng, 0.03, 0.075, 0.045,
                         hp_ins_mult=3.0)
            recs.append(FastaRecord(f"str/{len(recs)}/0_{len(seq)}", seq))
            truths.append(ts)
    res = m.map_reads(recs)
    n_overconfident = 0
    for rec, alns, ts in zip(recs, res, truths):
        store_map_qvs(alns, p, gi)
        if not alns:
            print(rec.title, "UNMAPPED")
            continue
        best = min(alns, key=lambda a: a.score)
        pred = best.tstart - (best.qstart if best.strand == 0
                              else best.qlen - best.qend)
        err = pred - ts
        if abs(err) > 100 and best.map_qv >= 30:
            n_overconfident += 1
        print(f"{rec.title}: n_alns={len(alns)} best mapQV={best.map_qv} "
              f"score={best.score:.0f} span={best.qend-best.qstart} "
              f"nsig={best.n_significant_clusters} err={err} others="
              f"{[(a.tstart - best.tstart, round(a.score), a.qend - a.qstart) for a in alns if a is not best][:6]}")
    print(f"# {n_overconfident}/{len(recs)} overconfident "
          f"(|err|>100 at mapQV>=30)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
