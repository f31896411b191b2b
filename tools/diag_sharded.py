"""Small-scale diagnostic for sharded-vs-replicated candidate parity.

Dumps every candidate (row, score, coords, slot/shard) for both paths on
an 8 Mbp world with exact boundary reads, to explain score differences.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import numpy as np


def main() -> int:
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
    n = 8_000_000
    contigs = random_genome(n, seed=7)
    gi = build_genome_index(contigs, k=12)

    L = 2048
    rng = np.random.default_rng(8)
    sims = simulate_reads(contigs, 8, read_len=(500, L - 60),
                          accuracy=0.88, seed=9)
    recs = [(s.rec.seq, s.tstart, s.strand) for s in sims]
    base = -(-n // n_ref)
    for j in range(4):
        cut = base * (1 + j % (n_ref - 1))
        start = cut - 600 - int(rng.integers(0, 400))
        recs.append((gi.genome[start:start + 1200].copy(), start, 0))
    B = len(recs)
    reads = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for i, (seq, _, _) in enumerate(recs):
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

    dev = DeviceIndex.from_host(gi)
    rep = unpack_batch(map_batch(dev, jnp.asarray(reads), jnp.asarray(lens),
                                 submat, gaps, **static))
    mesh = make_mesh(1, n_ref)
    with mesh:
        out, offs, n_dp = map_batch_ref_sharded(
            mesh, gi, reads, lens, submat, gaps, **static)
    sh = unpack_batch(out)
    ts_g, te_g = globalize_sharded(sh, offs, n_dp)

    for row in range(2 * B):
        i = row % B
        kind = ("sim" if i < len(sims) else "boundary")
        print(f"row {row} read {i} ({kind}, truth t={recs[i][1]} "
              f"strand={recs[i][2]}, len={lens[i]}) "
              f"{'fwd' if row < B else 'rc'}")
        for c in range(4):
            rv = bool(rep.valid[row][c]) and rep.dp_slot[row][c] >= 0
            sv = bool(sh.valid[row][c]) and sh.dp_slot[row][c] >= 0
            rtxt = (f"repl score={rep.score[row][c]:.0f} "
                    f"t=[{rep.t_start[row][c]},{rep.t_end[row][c]}] "
                    f"q=[{rep.q_start[row][c]},{rep.q_end[row][c]}]"
                    if rv else "repl -")
            slot = int(sh.dp_slot[row][c])
            shard = slot // n_dp if slot >= 0 else -1
            stxt = (f"shard score={sh.score[row][c]:.0f} "
                    f"t=[{ts_g[row][c]},{te_g[row][c]}] "
                    f"q=[{sh.q_start[row][c]},{sh.q_end[row][c]}] "
                    f"(local_ts={sh.t_start[row][c]}, shard={shard})"
                    if sv else "shard -")
            print(f"  c{c}: {rtxt} | {stxt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
