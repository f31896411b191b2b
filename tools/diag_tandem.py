"""Diagnose tandem-array placement at copy-number scale.

Small genome + ONE alpha-satellite-like array; reads sampled inside the
array.  Reports per-read: truth offset, chosen placement (period shift),
mapQV, rescue trigger, and the candidate score spectrum — to localize
whether misplacement comes from anchor starvation, candidate capacity,
or band/DP scoring.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/diag_tandem.py \
        --copies 150 --div 0.015 --reads 24
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=4.0)
    ap.add_argument("--copies", type=int, default=150)
    ap.add_argument("--period", type=int, default=171)
    ap.add_argument("--div", type=float, default=0.015)
    ap.add_argument("--reads", type=int, default=24)
    ap.add_argument("--read-len", type=int, nargs=2, default=(800, 1900))
    ap.add_argument("--accuracy", type=float, default=0.85)
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--canddrift", type=float, default=0.0,
                    help="candidate-level chain drift penalty (experiment)")
    ap.add_argument("--scaleclusters", action="store_true",
                    help="-scaleMapQVByNClusters (the reference's guard "
                    "against confident placement in deep repeat families)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from blasr_tpu.index import build_genome_index
    from blasr_tpu.io.fasta import FastaRecord, revcomp
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper
    from blasr_tpu.sim import SimRead, mutate, structured_genome

    contigs, features = structured_genome(
        int(args.mbp * 1e6), seed=args.seed, n_tandem=1,
        tandem_copies=(args.copies, args.copies + 1),
        tandem_period=args.period, tandem_divergence=args.div)
    feat = [f for f in features if f.kind == "tandem"][0]
    print(f"# tandem array [{feat.start}, {feat.end}) "
          f"{args.copies}x{args.period} div {args.div}")

    rng = np.random.default_rng(args.seed + 1)
    g = contigs[0].seq
    err = 1.0 - args.accuracy
    sims = []
    for i in range(args.reads):
        rl = int(rng.integers(*args.read_len))
        lo = max(0, feat.start - rl // 4)
        hi = min(len(g) - rl, feat.end - 3 * rl // 4)
        ts = int(rng.integers(lo, hi))
        frag = g[ts:ts + rl]
        strand = int(rng.integers(0, 2))
        if strand:
            frag = revcomp(frag)
        seq = mutate(frag, rng, 0.2 * err, 0.5 * err, 0.3 * err)
        sims.append(SimRead(FastaRecord(f"sim/{i}/0_{len(seq)}", seq),
                            0, ts, ts + rl, strand))

    gi = build_genome_index(contigs, k=args.k)
    params = MappingParams(
        min_match_length=args.k,
        scale_mapqv_by_num_significant_clusters=args.scaleclusters,
        candidate_drift_penalty=args.canddrift,
    ).make_sane()
    cfg = ShapeConfig(buckets=(2048,), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, params, cfg)
    t0 = time.time()
    results = mapper.map_reads([s.rec for s in sims])
    dt = time.time() - t0
    from blasr_tpu.pipeline.select import store_map_qvs
    for alns in results:
        store_map_qvs(alns, params, gi)

    n_ok = 0
    shift_hist = {}
    for i, (s, alns) in enumerate(zip(sims, results)):
        if not alns:
            print(f"read {i:3d} truth {s.tstart:9d} UNMAPPED")
            continue
        a = alns[0]
        # project clipped head along the diagonal (soak criterion)
        if a.strand == 0:
            proj = a.tstart - a.qstart
        else:
            proj = a.tstart - (len(s.rec.seq) - a.qend)
        d = proj - s.tstart
        shift = round(d / args.period)
        ok = abs(d) <= 100
        n_ok += ok
        shift_hist[shift if not ok else 0] = \
            shift_hist.get(shift if not ok else 0, 0) + 1
        extra = ""
        if len(alns) > 1:
            extra = f" runnerup d={alns[1].tstart - s.tstart}"
        if not ok:
            cands = "; ".join(
                f"d={(a.tstart - (a.qstart if a.strand == 0 else len(s.rec.seq) - a.qend)) - s.tstart}"
                f" sc={a.score:.0f} q[{a.qstart},{a.qend}) "
                f"pct={a.pct_similarity:.1f} qv={a.map_qv}"
                for a in sorted(alns, key=lambda a: a.score)[:6])
            extra += f"\n          cands: {cands}"
        print(f"read {i:3d} truth {s.tstart:9d} got {proj:9d} "
              f"d={d:7d} (shift {shift:+4d}) mapQV {a.map_qv:3d} "
              f"score {a.score:7.0f} nsig {a.n_significant_clusters:4d} "
              f"nalns {len(alns):2d} {'OK ' if ok else 'MISS'}{extra}")
    print(f"# correct {n_ok}/{len(sims)}  "
          f"wrong@mapQV>=30: "
          f"{sum(1 for s2, r in zip(sims, results) if r and r[0].map_qv >= 30 and not (abs((r[0].tstart - (r[0].qstart if r[0].strand == 0 else len(s2.rec.seq) - r[0].qend)) - s2.tstart) <= 100))}"
          f"  shifts {dict(sorted(shift_hist.items()))}  {dt:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
