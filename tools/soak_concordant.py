"""Concordant-workload soak: throughput of the BAM-concordant path
(ctest/bamConcordant.t shape; VERDICT round-1 weak item 10: concordant
throughput was unmeasured).

    python tools/soak_concordant.py --zmws 200 --passes 4

Simulates multi-pass ZMWs (several noisy subreads of the same template
locus per hole), maps them with map_concordant on the current backend,
and reports ZMWs/s + subreads/s + the window-remap hit rate (fraction of
non-template subreads that realign inside their own ZMW's template
window — the concordant contract, BlasrAlignImpl.hpp:1371-1527).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=4.6)
    ap.add_argument("--zmws", type=int, default=200)
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--template-len", type=int, nargs=2, default=(600, 1500))
    ap.add_argument("--accuracy", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args()

    import jax
    from blasr_tpu.hostcache import enable_compile_cache
    enable_compile_cache()
    from blasr_tpu.index import build_genome_index
    from blasr_tpu.io.fasta import FastaRecord
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper
    from blasr_tpu.pipeline.zmw import map_concordant
    from blasr_tpu.sim import mutate, random_genome

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    contigs = random_genome(int(args.mbp * 1e6), seed=args.seed)
    gi = build_genome_index(contigs, k=12)
    print(f"# index built in {time.time()-t0:.1f}s "
          f"({jax.devices()[0].platform})", file=sys.stderr)

    # multi-pass ZMWs: one template locus, `passes` noisy reads of it
    recs = []
    truth = {}
    glen = len(contigs[0].seq)
    for hole in range(args.zmws):
        tl = int(rng.integers(*args.template_len))
        ts = int(rng.integers(0, glen - tl))
        tmpl = contigs[0].seq[ts:ts + tl]
        truth[hole] = (ts, ts + tl)
        err = (1.0 - args.accuracy) / 3.0
        for p in range(args.passes):
            sub = mutate(tmpl, rng, err, err, err)
            if p % 2 == 1:  # alternate pass direction like real ZMWs
                comp = np.array([3, 2, 1, 0, 4], np.int8)
                sub = comp[sub[::-1]]
            recs.append(FastaRecord(
                f"m/{hole}/{p * 2000}_{p * 2000 + len(sub)}", sub))

    params = MappingParams(concordant=True).make_sane()
    cfg = ShapeConfig(buckets=(2048,), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, params, cfg)

    # warmup pass (compiles the main index buckets + window tiers)
    n_warm = min(args.passes * 8, len(recs))
    t0 = time.time()
    map_concordant(mapper, recs[:n_warm], params)
    print(f"# warmup (compile) {time.time()-t0:.1f}s", file=sys.stderr)

    # two measured passes, best taken: the first full-size pass may still
    # compile the big window-mini-genome tier (the 8-ZMW warmup only
    # reaches a smaller power-of-two tier)
    dt = float("inf")
    for i in range(2):
        t0 = time.time()
        per_read = map_concordant(mapper, recs, params)
        d = time.time() - t0
        print(f"# pass {i}: {d:.1f}s", file=sys.stderr)
        dt = min(dt, d)

    n_sub = len(recs)
    n_zmw = args.zmws
    hit, tot, correct = 0, 0, 0
    for rec, alns in zip(recs, per_read):
        tot += 1
        if not alns:
            continue
        hit += 1
        hole = int(rec.name.split("/")[1])
        ts, te = truth[hole]
        a = min(alns, key=lambda x: x.score)
        if abs(a.tstart - ts) < 150 or abs(a.tend - te) < 150:
            correct += 1
    print(f"# {n_zmw} ZMWs x {args.passes} passes: {dt:.1f}s = "
          f"{n_zmw/dt:.1f} ZMWs/s, {n_sub/dt:.1f} subreads/s", file=sys.stderr)
    print(f"# aligned {hit}/{tot} subreads, {correct}/{tot} at the "
          f"template locus", file=sys.stderr)
    import json
    print(json.dumps({
        "metric": "concordant_subreads_per_sec",
        "value": round(n_sub / dt, 2),
        "zmws_per_sec": round(n_zmw / dt, 2),
        "aligned_frac": round(hit / max(tot, 1), 4),
        "locus_correct_frac": round(correct / max(tot, 1), 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
