"""Genome-scale soak: placement accuracy + throughput at large reference
sizes (the BASELINE.md "genome-scale single chip" protocol; VERDICT
round-1 item 6: >= 99% correct placement at 200 Mbp).

    python tools/soak_genome.py --mbp 200 --reads 2000 --k 14 --rescue

Builds an N-Mbp random genome, simulates CLR-like reads with known truth,
maps them on the current backend, and reports reads/s + the fraction whose
best hit lands within 100 bp of the simulated locus.  --rescue adds the
k=12 sensitive-index rescue pass for weak reads (Mapper(rescue=...)).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=200.0)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--k", type=int, default=14,
                    help="fast-index seed size (direct LUT up to 14)")
    ap.add_argument("--rescue", action="store_true",
                    help="add the k=12 sensitive-index rescue pass")
    ap.add_argument("--read-len", type=int, nargs=2, default=(500, 1980))
    ap.add_argument("--accuracy", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--structured", action="store_true",
                    help="plant tandem arrays (171 bp period), segdup "
                    "pairs (95-99.5%% identity), short-period STR "
                    "microsatellites and N runs; sample half "
                    "the reads from the planted features and report "
                    "per-class placement + mapQV calibration")
    ap.add_argument("--hp-bias", type=float, default=1.0,
                    help="homopolymer insertion-bias multiplier for the "
                    "read error model (sim.mutate hp_ins_mult; real CLR "
                    "error concentrates insertions in hp runs)")
    args = ap.parse_args()

    from blasr_tpu.hostcache import enable_compile_cache
    enable_compile_cache()
    from blasr_tpu.index import build_genome_index
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper
    from blasr_tpu.sim import random_genome, simulate_reads

    n = int(args.mbp * 1e6)
    t0 = time.time()
    features = []
    if args.structured:
        from blasr_tpu.sim import structured_genome
        mb = max(args.mbp, 1.0)
        contigs, features = structured_genome(
            n, seed=args.seed,
            n_tandem=max(3, int(mb // 20)),
            n_segdup=max(2, int(mb // 40)),
            n_nrun=max(2, int(mb // 20)),
            n_str=max(4, int(mb // 10)))
        kinds = {}
        for f in features:
            kinds[f.kind] = kinds.get(f.kind, 0) + 1
        print(f"# structured genome: {kinds}", file=sys.stderr)
    else:
        contigs = random_genome(n, seed=args.seed)
    print(f"# genome {args.mbp:.0f} Mbp in {time.time()-t0:.0f}s",
          file=sys.stderr)
    t0 = time.time()
    gi = build_genome_index(contigs, k=args.k)
    print(f"# k={args.k} index in {time.time()-t0:.0f}s", file=sys.stderr)
    rescue = None
    if args.rescue and args.k > 12:
        t0 = time.time()
        gi12 = build_genome_index(contigs, k=12)
        print(f"# k=12 rescue index in {time.time()-t0:.0f}s",
              file=sys.stderr)

    t0 = time.time()
    sims = simulate_reads(contigs, args.reads, read_len=tuple(args.read_len),
                          accuracy=args.accuracy, seed=args.seed + 1,
                          hp_ins_mult=args.hp_bias)
    if args.structured and features:
        # re-aim half the reads at the planted features (uniform sampling
        # would barely touch them at genome scale)
        from blasr_tpu.io.fasta import FastaRecord, revcomp
        from blasr_tpu.sim import SimRead, mutate
        rng = np.random.default_rng(args.seed + 2)
        g = contigs[0].seq
        err = 1.0 - args.accuracy
        ins, dele, sub = 0.5 * err, 0.3 * err, 0.2 * err
        targets = [f for f in features if f.kind != "nrun"]
        for i in range(0, args.reads, 2):
            f = targets[int(rng.integers(len(targets)))]
            rl = int(rng.integers(*args.read_len))
            lo = max(0, f.start - rl // 2)
            hi = min(len(g) - rl, f.end - rl // 2)
            if hi <= lo:
                continue
            ts = int(rng.integers(lo, hi))
            frag = g[ts:ts + rl]
            strand = int(rng.integers(0, 2))
            if strand:
                frag = revcomp(frag)
            seq = mutate(frag, rng, sub, ins, dele,
                         hp_ins_mult=args.hp_bias)
            if not len(seq):
                continue
            sims[i] = SimRead(
                FastaRecord(f"sim/{i}/0_{len(seq)}", seq), 0, ts, ts + rl,
                strand)
    print(f"# {args.reads} reads in {time.time()-t0:.0f}s", file=sys.stderr)

    def read_class(sim):
        for f in features:
            if sim.tstart < f.end and sim.tend > f.start:
                return f.kind
        return "unique"

    params = MappingParams(min_match_length=args.k).make_sane()
    cfg = ShapeConfig(buckets=(2048,), batch_size=32, max_anchors=512)
    if args.rescue and args.k > 12:
        rescue = Mapper(gi12, MappingParams().make_sane(), cfg)
    mapper = Mapper(gi, params, cfg, rescue=rescue)

    recs = [s.rec for s in sims]
    t0 = time.time()
    warm = mapper.map_reads(recs[:32])
    if rescue is not None:
        rescue.map_reads(recs[:32])
    print(f"# warmup {time.time()-t0:.0f}s", file=sys.stderr)
    t0 = time.time()
    results = mapper.map_reads(recs)
    dt = time.time() - t0
    # real mapQVs, as the CLI assigns them (cli/blasr.py): without this
    # every alignment carries the constructor default 254 and the
    # calibration row below is meaningless (round-4 finding)
    from blasr_tpu.pipeline.select import store_map_qvs
    for alns in results:
        store_map_qvs(alns, params, gi)
    n_mapped = n_correct = 0
    cls_total, cls_correct = {}, {}
    hi_qv = hi_qv_wrong = 0  # mapQV calibration: P(wrong | mapQV >= 30)
    for ri, (sim, alns) in enumerate(zip(sims, results)):
        cls = read_class(sim)
        cls_total[cls] = cls_total.get(cls, 0) + 1
        if not alns:
            print(f"# MISS read {ri}: unmapped (truth contig {sim.contig} "
                  f"strand {sim.strand} t {sim.tstart}, class {cls}, "
                  f"len {len(sim.rec.seq)})", file=sys.stderr)
            continue
        n_mapped += 1
        best = min(alns, key=lambda a: a.score)
        # project a clipped head back along the diagonal: a local DP
        # rightly trims a noisy read start (the reference extends ends
        # only under --extend), which shifts tstart by ~qstart
        pred = best.tstart - (best.qstart if best.strand == 0
                              else best.qlen - best.qend)
        ok = (best.tindex == sim.contig and best.strand == sim.strand
              and abs(pred - sim.tstart) < 100)
        if best.map_qv >= 30:
            hi_qv += 1
            if not ok:
                hi_qv_wrong += 1
        if ok:
            n_correct += 1
            cls_correct[cls] = cls_correct.get(cls, 0) + 1
        else:
            def _pred(a):
                return a.tstart - (a.qstart if a.strand == 0
                                   else a.qlen - a.qend)
            truth_hit = [a for a in alns
                         if a.tindex == sim.contig and a.strand == sim.strand
                         and abs(_pred(a) - sim.tstart) < 100]
            t_sc = f"{min(a.score for a in truth_hit):.0f}" \
                if truth_hit else "absent"
            print(f"# MISS read {ri}: best score {best.score:.0f} "
                  f"pct {best.pct_similarity:.1f} qspan "
                  f"{best.qend - best.qstart}/{len(sim.rec.seq)} at "
                  f"({best.tindex},{best.strand},{best.tstart}); truth "
                  f"({sim.contig},{sim.strand},{sim.tstart}) scored {t_sc}",
                  file=sys.stderr)
    print(f"# mapped {n_mapped}/{args.reads}, "
          f"correct {n_correct} ({100.0*n_correct/args.reads:.2f}%), "
          f"{args.reads/dt:.0f} reads/s", file=sys.stderr)
    per_class = {}
    for cls in sorted(cls_total):
        per_class[cls] = (cls_correct.get(cls, 0), cls_total[cls])
        print(f"# class {cls}: {cls_correct.get(cls, 0)}/{cls_total[cls]} "
              "correct", file=sys.stderr)
    g_hi = g_wrong = 0
    if args.structured:
        rate = hi_qv_wrong / hi_qv if hi_qv else 0.0
        print(f"# mapQV calibration: {hi_qv_wrong}/{hi_qv} wrong at "
              f"mapQV>=30 (P = {rate:.2e})", file=sys.stderr)
        # second row: the reference's guard against confident placement
        # in deep repeat families (-scaleMapQVByNClusters) — re-assign
        # mapQVs with the flag on and re-measure
        import dataclasses as _dc
        params_g = _dc.replace(
            params, scale_mapqv_by_num_significant_clusters=True)
        for alns in results:
            store_map_qvs(alns, params_g, gi)
        for sim, alns in zip(sims, results):
            if not alns:
                continue
            best = min(alns, key=lambda a: a.score)
            pred = best.tstart - (best.qstart if best.strand == 0
                                  else best.qlen - best.qend)
            ok = (best.tindex == sim.contig and best.strand == sim.strand
                  and abs(pred - sim.tstart) < 100)
            if best.map_qv >= 30:
                g_hi += 1
                g_wrong += not ok
        g_rate = g_wrong / g_hi if g_hi else 0.0
        print(f"# mapQV calibration (scaleMapQVByNClusters): "
              f"{g_wrong}/{g_hi} wrong at mapQV>=30 (P = {g_rate:.2e})",
              file=sys.stderr)
    import json
    print(json.dumps({
        "mbp": args.mbp, "k": args.k, "rescue": bool(rescue),
        "structured": bool(args.structured), "hp_bias": args.hp_bias,
        "reads": args.reads, "mapped": n_mapped, "correct": n_correct,
        "pct_correct": round(100.0 * n_correct / args.reads, 2),
        "per_class": {k: list(v) for k, v in per_class.items()},
        "hi_mapqv": hi_qv, "hi_mapqv_wrong": hi_qv_wrong,
        "hi_mapqv_scaled": g_hi, "hi_mapqv_scaled_wrong": g_wrong,
        "reads_per_sec": round(args.reads / dt, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
