"""Genome-scale ref-shard parity soak (VERDICT r2 item 3).

Runs the reference-sharded mapping path on the 8-device virtual CPU mesh
against a large genome (default 200 Mbp) and asserts placement parity
with the replicated single-device run — including reads placed near
shard boundaries and int64 coordinate globalization.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/soak_sharded.py --mbp 200 --reads 64
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=200.0)
    ap.add_argument("--reads", type=int, default=64)
    ap.add_argument("--boundary-reads", type=int, default=16)
    ap.add_argument("--L", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--accuracy", type=float, default=0.88,
                    help="read accuracy; 0.99 = CCS-quality reads "
                         "(BASELINE config 4, useccsallLargeGenome.t "
                         "shape: CCS reads over a sharded index)")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from blasr_tpu.dist.mesh import (
        globalize_sharded, make_mesh, map_batch_ref_sharded)
    from blasr_tpu.index import build_genome_index
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import (
        DeviceIndex, map_batch, unpack_batch)
    from blasr_tpu.sim import random_genome, simulate_reads

    n_ref = 8
    n = int(args.mbp * 1e6)
    t0 = time.time()
    contigs = random_genome(n, seed=args.seed)
    gi = build_genome_index(contigs, k=12)
    print(f"# {args.mbp:.0f} Mbp k=12 index in {time.time()-t0:.0f}s",
          file=sys.stderr)

    L = args.L
    rng = np.random.default_rng(args.seed + 1)
    sims = simulate_reads(contigs, args.reads, read_len=(500, L - 60),
                          accuracy=args.accuracy, seed=args.seed + 2)
    recs = [(s.rec.seq, s.tstart) for s in sims]
    # extra reads straddling every shard cut (clean copies, truth known)
    base = -(-n // n_ref)
    for j in range(args.boundary_reads):
        cut = base * (1 + j % (n_ref - 1))
        start = cut - 600 - int(rng.integers(0, 400))
        recs.append((gi.genome[start:start + 1200].copy(), start))
    B = len(recs)
    # pad B to the data axis (1 here: whole mesh on ref)
    reads = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for i, (seq, _) in enumerate(recs):
        m = min(len(seq), L)
        reads[i, :m] = seq[:m]
        lens[i] = m

    p = MappingParams().make_sane()
    submat = jnp.asarray(np.asarray(p.score_matrix, np.float32).reshape(25))
    gaps = jnp.asarray([4, 4, 5, 5], jnp.float32)
    cfg = ShapeConfig(buckets=(L,), band_width=128)
    static = dict(cfg_k=12, L=L, W=cfg.window_len(L), w_b=128, C=4, A=256,
                  O=3, E=20, T=L + cfg.window_len(L), max_chain=256,
                  min_match=12, max_anchors_per_pos=10000, max_lcp=0,
                  indel_rate=0.3)

    t0 = time.time()
    dev = DeviceIndex.from_host(gi)
    rep = unpack_batch(map_batch(dev, jnp.asarray(reads), jnp.asarray(lens),
                                 submat, gaps, **static))
    print(f"# replicated pass in {time.time()-t0:.0f}s", file=sys.stderr)

    mesh = make_mesh(1, n_ref)
    t0 = time.time()
    with mesh:
        out, offs, n_dp = map_batch_ref_sharded(
            mesh, gi, reads, lens, submat, gaps, **static)
    sh = unpack_batch(out)
    ts_g, te_g = globalize_sharded(sh, offs, n_dp)
    print(f"# sharded pass in {time.time()-t0:.0f}s "
          f"(offsets int64: {offs.dtype})", file=sys.stderr)

    # Parity contract: per READ, the sharded path must report the same
    # placement (strand-row + locus) with a score at least as good.
    # Exact per-row score equality is NOT expected: each shard spends the
    # full A-anchor budget on 1/8th of the genome, so the sharded path
    # explores more chains per locus (denser guide bands, better junk
    # candidates on the non-true strand row) — a capacity difference in
    # the sharded path's favor, deterministic either way.
    def read_best(valid, dp_slot, score, ts, te, i):
        """(row, score, ts, te) of the read's best placement over both
        strand rows, or None."""
        best = None
        for row in (i, i + B):
            ok = np.asarray(valid[row]) & (np.asarray(dp_slot[row]) >= 0)
            if not ok.any():
                continue
            c = int(np.argmin(np.where(ok, score[row], 1 << 30)))
            cand = (float(score[row][c]), row, int(ts[row][c]),
                    int(te[row][c]))
            if best is None or cand[0] < best[0]:
                best = cand
        return best

    same = better = total = truth_ok = 0
    for i in range(B):
        rb = read_best(rep.valid, rep.dp_slot, rep.score, rep.t_start,
                       rep.t_end, i)
        sb = read_best(sh.valid, sh.dp_slot, sh.score, ts_g, te_g, i)
        if rb is None:
            continue
        total += 1
        if sb is None:
            print(f"# read {i}: sharded found nothing (repl score "
                  f"{rb[0]:.0f} t {rb[2]})", file=sys.stderr)
            continue
        # same placement = same strand row + >50% target-interval overlap
        # (the sharded alignment may start earlier/later when its denser
        # anchor set yields a fuller band); the score may wiggle a few
        # points either way from band-interpolation differences (measured
        # worst case +9 at 200 Mbp), but must not be meaningfully worse
        ov = min(rb[3], sb[3]) - max(rb[2], sb[2])
        span = min(rb[3] - rb[2], sb[3] - sb[2])
        same_place = rb[1] == sb[1] and 2 * ov > span
        ok = same_place and sb[0] <= rb[0] + 16
        same += int(ok)
        better += int(ok and sb[0] < rb[0])
        if not ok:
            print(f"# read {i}: repl (row {rb[1]} score {rb[0]:.0f} "
                  f"t [{rb[2]},{rb[3]}]) != sharded (row {sb[1]} score "
                  f"{sb[0]:.0f} t [{sb[2]},{sb[3]}])", file=sys.stderr)
        # boundary reads: truth check on the sharded result
        if i >= len(sims):
            truth_ok += int(abs(sb[2] - recs[i][1]) < 100)

    nb = args.boundary_reads
    print(f"# read parity {same}/{total} (sharded strictly better on "
          f"{better}); boundary truth {truth_ok}/{nb}", file=sys.stderr)
    import json
    print(json.dumps({
        "mbp": args.mbp, "accuracy": args.accuracy,
        "n_ref": n_ref, "reads": total, "parity": same,
        "parity_pct": round(100.0 * same / max(total, 1), 2),
        "sharded_better": better,
        "boundary_reads": nb, "boundary_correct": truth_ok}))
    assert same >= 0.97 * total, f"parity {same}/{total}"
    assert truth_ok >= nb - 1, f"boundary {truth_ok}/{nb}"
    return 0


if __name__ == "__main__":
    sys.exit(main())
