"""Attribute long-read (segment+stitch) time to stages (round-5: the
bench longread tier measured ~0.1 Mbase/s vs 0.63 headline — find the
×6).  Reuses the bench world + winning ShapeConfig so the persistent
cache hits.

    python tools/profile_longread.py [--reads 32]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=32)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()

    from blasr_tpu.hostcache import enable_compile_cache
    enable_compile_cache()
    from blasr_tpu.index import build_genome_index
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper
    from blasr_tpu.pipeline.longread import split_read, stitch_segments
    from blasr_tpu.pipeline.metrics import MappingMetrics
    from blasr_tpu.sim import random_genome, simulate_reads

    contigs = random_genome(4_600_000, seed=11)
    gi = build_genome_index(contigs, k=12)
    params = MappingParams().make_sane()
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=args.batch,
                      max_anchors=512)
    met = MappingMetrics()
    mapper = Mapper(gi, params, cfg, metrics=met)

    sims = simulate_reads(contigs, args.reads, read_len=(10_000, 30_000),
                          accuracy=0.85, seed=14)
    recs = [s.rec for s in sims]
    bases = sum(len(r.seq) for r in recs)

    # manual decomposition of map_long_reads
    seg_len = cfg.buckets[-1]
    flat = []
    index = []
    for rec in recs:
        segs = split_read(rec, seg_len)
        index.append([(off, len(flat) + i)
                      for i, (off, _) in enumerate(segs)])
        flat.extend(s for _, s in segs)
    print(f"# {args.reads} reads, {bases/1e6:.2f} Mbase -> {len(flat)} "
          f"segments ({sum(len(s.seq) for s in flat)/1e6:.2f} Mbase incl. "
          f"overlap)", file=sys.stderr)

    mapper.map_reads(flat[:args.batch])  # warm
    for trial in range(2):
        met.clocks.clear(); met.counters.clear()
        t0 = time.time()
        seg_results = mapper.map_reads(flat)
        t_map = time.time() - t0
        t0 = time.time()
        out = [stitch_segments(rec, [(off, seg_results[i]) for off, i in ix],
                               params)
               for rec, ix in zip(recs, index)]
        t_stitch = time.time() - t0
        n_unmapped = sum(1 for r in seg_results if not r)
        print(f"# trial {trial}: map {t_map:.2f}s stitch {t_stitch:.2f}s "
              f"({bases/(t_map+t_stitch)/1e6:.3f} Mbase/s); "
              f"{n_unmapped}/{len(flat)} segments unmapped; clocks: "
              + " ".join(f"{k}={v:.2f}" for k, v in
                         sorted(met.clocks.items())), file=sys.stderr)
    n_ok = sum(bool(a) for a in out)
    print(f"# stitched: {n_ok}/{args.reads} reads with alignments",
          file=sys.stderr)

    import cProfile
    import pstats
    pr = cProfile.Profile()
    pr.enable()
    for rec, ix in zip(recs, index):
        stitch_segments(rec, [(off, seg_results[i]) for off, i in ix],
                        params)
    pr.disable()
    pstats.Stats(pr, stream=sys.stderr).sort_stats("cumulative") \
        .print_stats(18)
    return 0


if __name__ == "__main__":
    sys.exit(main())
