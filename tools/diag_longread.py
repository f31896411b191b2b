"""Long-read microscope (round-5 VERDICT #3): simulate 10-30 kb CLR
reads (~85% accuracy, indel-heavy, optionally hp-biased), map through
segment+stitch, and report per-read span coverage, placement, stitch
piece counts and CIGAR invariants.  CPU-friendly at small genome sizes.

    JAX_PLATFORMS=cpu python tools/diag_longread.py --reads 8 --mbp 2
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=2.0)
    ap.add_argument("--reads", type=int, default=8)
    ap.add_argument("--read-len", type=int, nargs=2, default=(10_000, 30_000))
    ap.add_argument("--accuracy", type=float, default=0.85)
    ap.add_argument("--hp-bias", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--bucket", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--passes", type=int, default=1,
                    help="total mapping passes; pass 0 pays compile, "
                    "best time is reported (use >=3 for a warm number)")
    args = ap.parse_args()

    import jax
    from blasr_tpu.hostcache import enable_compile_cache
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache(0.5)

    from blasr_tpu.index import build_genome_index
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper
    from blasr_tpu.sim import random_genome, simulate_reads

    contigs = random_genome(int(args.mbp * 1e6), seed=args.seed)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, args.reads,
                          read_len=tuple(args.read_len),
                          accuracy=args.accuracy, seed=args.seed + 1,
                          hp_ins_mult=args.hp_bias)
    p = MappingParams().make_sane()
    m = Mapper(gi, p, ShapeConfig(buckets=(args.bucket,),
                                  batch_size=args.batch))
    recs = [s.rec for s in sims]
    t0 = time.time()
    res = m.map_reads(recs)
    dt = time.time() - t0
    for i in range(args.passes - 1):  # pass 0 above included compile
        t0 = time.time()
        res = m.map_reads(recs)
        d = time.time() - t0
        print(f"# pass {i + 1}: {d:.2f}s ({args.reads/d:.2f} reads/s)")
        dt = min(dt, d)
    n_ok = 0
    tot_bases = sum(len(r.seq) for r in recs)
    for s, alns in zip(sims, res):
        L = len(s.rec.seq)
        if not alns:
            print(f"read len={L} truth=({s.strand},{s.tstart}) UNMAPPED")
            continue
        best = min(alns, key=lambda a: a.score)
        span = best.qend - best.qstart
        proj = best.tstart - (best.qstart if best.strand == 0
                              else L - best.qend)
        ok = (best.strand == s.strand and abs(proj - s.tstart) < 300
              and span >= 0.9 * L)
        n_ok += ok
        qc = sum(n for op, n in (best.cigar or []) if op in "MI=X")
        tc = sum(n for op, n in (best.cigar or []) if op in "MD=XN")
        qa = best.qstart if best.strand == 0 else L - best.qend
        qb = best.qend if best.strand == 0 else L - best.qstart
        inv = "ok" if (qc == qb - qa and tc == best.tend - best.tstart) \
            else f"BROKEN qc={qc} want {qb-qa}, tc={tc} want {best.tend-best.tstart}"
        print(f"read len={L} strand={s.strand} truth={s.tstart} "
              f"pred={proj} span={span} ({100.0*span/L:.0f}%) "
              f"pieces={len(alns)} score={best.score:.0f} cigar_inv={inv} "
              f"{'OK' if ok else 'MISS'}")
    print(f"# {n_ok}/{args.reads} full-span correct, "
          f"{args.reads/dt:.2f} reads/s, "
          f"{tot_bases/dt/1e6:.3f} Mbase/s ({dt:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
