"""Smoke test of the mapper on one NVIDIA GPU: the quickest proof that the
system still starts and maps correctly on the card.

    python chip_smoke.py           # one GPU: phases (a)-(d)
    python chip_smoke.py --four    # four GPUs: the multi-card path only

Phases, each printing its own lines:
  (a) device: JAX's devices and the card's name and power limit; exits
      non-zero when JAX finds no GPU (there is no CPU fallback);
  (b) kernels: the CUDA banded-DP kernel against the XLA kernel
      (``banded_align``) at the 2048-bucket widths (N = 640, L = 2048,
      w_b = 128, W = 3072) on random operands and on a real batch of the
      bench world, in the default, QV and affine-gap modes, bit for bit,
      with both times; and ``memory_analysis()`` of ``map_batch`` for the
      1024 and 2048 buckets;
  (c) goldens: every golden case whose world needs no h5py (all of them
      where h5py is installed) must be byte-identical to tests/golden/;
  (d) main path: the bench world (4.6 Mbp genome, k = 12, 512 CLR reads of
      500-1980 bp at 85% accuracy) through ``blasr_tpu.cli.blasr.run`` as
      ``-m 4``, ``--sam --clipping soft`` and FASTQ ``--useQuality``, with
      placements counted against the simulated truth.

With ``--four``: ``map_batch_ref_sharded`` on a (data=1, ref=4) mesh and
``map_batch_data_parallel`` on (data=4, ref=1), 64 reads of the bench world,
each compared with the single-card replicated run.

Any failure raises and exits non-zero.  The last line of a passing run is
one JSON object naming the device JAX ran on.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BUCKET = 2048
# placements of the bench world's 512 reads, as counted by the same seeded
# run on the CPU
EXPECTED_PLACED = {"m4": 512, "sam": 512, "fastq": 512}
# sha256 prefixes of the CPU run's outputs (SAM without its @PG line):
# equal digests mean byte-identical output on the card
CPU_DIGEST = {"m4": "e4aa7fee227f659e", "sam": "d0685d56361f946f",
              "fastq": "45d79f0cd2f60969"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def timed(fn, *args, reps: int = 3, **kw):
    """(result, median seconds over ``reps`` runs after one warm-up)."""
    import jax
    out = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


# ------------------------------------------------------------------ worlds
def bench_world():
    """The bench world: genome, its k=12 index and 512 simulated reads."""
    from blasr_tpu.index import build_genome_index
    from blasr_tpu.sim import random_genome, simulate_reads
    contigs = random_genome(4_600_000, seed=11)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 512, read_len=(500, 1980), accuracy=0.85,
                          seed=12)
    return contigs, gi, sims


def with_quals(recs):
    """The same reads with seeded synthetic FASTQ qualities."""
    from blasr_tpu.io.fasta import FastaRecord
    rng = np.random.default_rng(13)
    return [FastaRecord(r.title, r.seq,
                        rng.integers(5, 35, len(r.seq)).astype(np.uint8))
            for r in recs]


def batch_arrays(recs, L):
    reads = np.full((len(recs), L), 4, np.int8)
    lens = np.zeros(len(recs), np.int32)
    for i, r in enumerate(recs):
        n = min(len(r.seq), L)
        reads[i, :n] = r.seq[:n]
        lens[i] = n
    return reads, lens


# ------------------------------------------------------------- phase (b)
def phase_kernels(gi, sims) -> None:
    import jax
    import jax.numpy as jnp
    from test_banded_cuda import MODES, assert_same_alignments, random_case
    from test_banded_cuda import submat as default_submat

    from blasr_tpu.kernels.banded import banded_align
    from blasr_tpu.kernels.banded_cuda import cuda_banded_align
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper, map_batch

    t0 = time.perf_counter()
    from blasr_tpu.kernels.banded_cuda import load_library
    load_library()
    log(f"(b) CUDA kernel library built/loaded in "
        f"{time.perf_counter() - t0:.1f}s")

    def compare(label, args, sm, gaps, kw):
        W = args[1].shape[1]
        ref, t_xla = timed(banded_align, *args, sm, *gaps, w_b=128, **kw)
        out, t_cuda = timed(cuda_banded_align, *args, sm, *gaps, w_b=128,
                            **kw)
        assert_same_alignments(ref, out, args, t_max=args[0].shape[1] + W)
        n_valid = int(np.asarray(ref.valid).sum())
        log(f"(b) {label}: N={args[0].shape[0]} L={args[0].shape[1]} W={W} "
            f"valid={n_valid} bit-identical; xla {t_xla * 1e3:.3f} ms, "
            f"cuda {t_cuda * 1e3:.3f} ms ({t_xla / t_cuda:.1f}x)")

    # random operands at real widths: 2 strands x 32 reads x 10 candidates
    for name, gaps, qv in MODES:
        args, kw = random_case(2048, 640, BUCKET, 3072, qv=qv)
        compare(f"random/{name}", args, default_submat(), gaps, kw)

    # a real batch of the bench world (map_batch's DP operands)
    cfg = ShapeConfig(buckets=(BUCKET // 2, BUCKET), batch_size=32,
                      max_anchors=512)
    recs = [s.rec for s in sims
            if BUCKET // 2 < len(s.rec.seq) <= BUCKET][:32]
    dev = None
    for name, gaps, qv in MODES:
        params = MappingParams(ignore_qualities=not qv).make_sane()
        mapper = Mapper(gi, params, cfg, dev=dev)
        dev = mapper.dev
        group = with_quals(recs) if qv else recs
        reads, lens = batch_arrays(group, BUCKET)
        pos, kwargs = mapper._batch_call_args(BUCKET)
        qvkw = {}
        if qv:
            q1, q2 = mapper.pack_qv_rows(group, len(group), BUCKET)
            qvkw = dict(qv1=jnp.asarray(q1), qv2=jnp.asarray(q2),
                        qv_rescore=mapper.qv_rescore)
        (dp_args, dp_qv) = map_batch(
            mapper.dev, jnp.asarray(reads), jnp.asarray(lens), *pos,
            **qvkw, **dict(kwargs, profile_stop=4))
        compare(f"bench/{name}", dp_args[:7], dp_args[7], gaps, dp_qv)

    mapper = Mapper(gi, MappingParams().make_sane(), cfg, dev=dev)
    for L in cfg.buckets:
        B = mapper.batch_size_for(L)
        pos, kwargs = mapper._batch_call_args(L)
        compiled = map_batch.lower(
            mapper.dev, jnp.zeros((B, L), jnp.int8),
            jnp.full((B,), L, jnp.int32), *pos, **kwargs).compile()
        m = compiled.memory_analysis()
        log(f"(b) map_batch memory_analysis bucket {L} batch {B}: "
            f"argument {m.argument_size_in_bytes} B, output "
            f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
            f"generated code {m.generated_code_size_in_bytes} B")


# ------------------------------------------------------------- phase (c)
def phase_goldens() -> None:
    import test_golden as tg
    hdf_worlds = {"ccs", "bax", "multipart", "qvsteer"}
    try:
        import h5py  # noqa: F401
        skip = set()
    except ImportError:
        skip = hdf_worlds
    identical = differs = 0
    with tempfile.TemporaryDirectory() as d:
        cache = {}
        for name, world, flags in tg.CASES:
            if world in skip:
                continue
            got = tg.run_case(d, name, world, flags, cache)
            with open(os.path.join(tg.GOLDEN_DIR, f"golden.{name}")) as f:
                ok = got == f.read()
            log(f"(c) {name}: {'IDENTICAL' if ok else 'DIFFERS'}")
            identical += ok
            differs += not ok
    not_run = sorted(n for n, w, _ in tg.CASES if w in skip)
    if not_run:
        log(f"(c) not run (h5py is not installed): {' '.join(not_run)}")
    log(f"(c) goldens: {identical} IDENTICAL, {differs} DIFFER, "
        f"{len(not_run)} not run")
    if differs:
        raise AssertionError(f"{differs} golden case(s) differ from the CPU")


# ------------------------------------------------------------- phase (d)
def best_hits_m4(path):
    """qname -> (score, strand, forward tstart, qstart, qend, qlen)."""
    best = {}
    with open(path) as f:
        for line in f:
            v = line.split()
            score, strand = int(v[2]), int(v[8])
            qs, qe, ql = int(v[5]), int(v[6]), int(v[7])
            ts, te, tl = int(v[9]), int(v[10]), int(v[11])
            if strand:  # m4 gives reverse-strand hits in RC coordinates
                ts = tl - te
            if v[0] not in best or score < best[v[0]][0]:
                best[v[0]] = (score, strand, ts, qs, qe, ql)
    return best


def best_hits_sam(path):
    best = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            v = line.rstrip("\n").split("\t")
            flag = int(v[1])
            if flag & 4:
                continue
            strand = 1 if flag & 16 else 0
            score = next(int(t[5:]) for t in v[11:] if t.startswith("AS:i:"))
            ops, num, cig = [], "", v[5]
            for ch in cig:
                if ch.isdigit():
                    num += ch
                else:
                    ops.append((ch, int(num)))
                    num = ""
            lead = ops[0][1] if ops[0][0] in "SH" else 0
            trail = ops[-1][1] if ops[-1][0] in "SH" else 0
            ql = sum(n for op, n in ops if op in "MIS=XH")
            # strand-local query interval -> forward-read interval
            qs, qe = (lead, ql - trail) if not strand else (trail, ql - lead)
            if v[0] not in best or score < best[v[0]][0]:
                best[v[0]] = (score, strand, int(v[3]) - 1, qs, qe, ql)
    return best


def count_placed(best, sims) -> int:
    """bench.py's criterion: the best hit is on the true strand, projects
    the read start within 300 bp of the truth and spans >= 90% of it."""
    placed = 0
    for name, (_, strand, ts, qs, qe, ql) in best.items():
        s = sims[int(name.split("/")[1])]
        proj = ts - (qs if strand == 0 else ql - qe)
        if (strand == s.strand and abs(proj - s.tstart) < 300
                and qe - qs >= 0.9 * ql):
            placed += 1
    return placed


def phase_main_path(contigs, sims) -> dict:
    from blasr_tpu.cli.blasr import run
    from blasr_tpu.io.fasta import decode, write_fasta
    recs = [s.rec for s in sims]
    placed = {}
    with tempfile.TemporaryDirectory() as d:
        genome = os.path.join(d, "genome.fa")
        reads = os.path.join(d, "reads.fa")
        fastq = os.path.join(d, "reads.fastq")
        write_fasta(genome, contigs)
        write_fasta(reads, recs)
        with open(fastq, "w") as f:
            for r in with_quals(recs):
                f.write(f"@{r.title}\n{decode(r.seq)}\n+\n"
                        + "".join(chr(int(q) + 33) for q in r.qual) + "\n")
        runs = [("m4", [reads, genome, "-m", "4"], best_hits_m4),
                ("sam", [reads, genome, "--sam", "--clipping", "soft"],
                 best_hits_sam),
                ("fastq", [fastq, genome, "-m", "4", "--useQuality"],
                 best_hits_m4)]
        for name, argv, parse in runs:
            out = os.path.join(d, f"out.{name}")
            t0 = time.perf_counter()
            rc = run(argv + ["--out", out])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"blasr {' '.join(argv)} exited {rc}")
            best = parse(out)
            placed[name] = count_placed(best, sims)
            with open(out, "rb") as f:
                text = b"".join(line for line in f
                                if not line.startswith(b"@PG"))
            digest = hashlib.sha256(text).hexdigest()[:16]
            log(f"(d) {name}: mapped {len(best)}/{len(recs)} reads, placed "
                f"{placed[name]}, wall {wall:.1f}s (index build and compile "
                f"included), output sha256 {digest} (CPU run: "
                f"{CPU_DIGEST[name]})")
    return placed


def phase_main_path_checked(contigs, sims) -> None:
    import jax
    placed = phase_main_path(contigs, sims)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"(d) device peak_bytes_in_use {peak}")
    for name, n in placed.items():
        if n != EXPECTED_PLACED[name]:
            raise AssertionError(f"{name}: placed {n} reads, the CPU run "
                                 f"placed {EXPECTED_PLACED[name]}")


# ---------------------------------------------------------- phase --four
def phase_four() -> None:
    import jax
    import jax.numpy as jnp
    from blasr_tpu.dist.mesh import (
        globalize_sharded, make_mesh, map_batch_data_parallel,
        map_batch_ref_sharded, placement_parity)
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.pipeline.map_read import Mapper, map_batch, unpack_batch

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    contigs, gi, sims = bench_world()
    recs = [s.rec for s in sims[:64]]
    reads, lens = batch_arrays(recs, BUCKET)
    mapper = Mapper(gi, MappingParams().make_sane(),
                    ShapeConfig(buckets=(BUCKET,), max_anchors=512))
    submat, gaps = mapper.submat, mapper.gap_costs
    _, static = mapper._batch_call_args(BUCKET)

    t0 = time.perf_counter()
    rep = unpack_batch(map_batch(mapper.dev, jnp.asarray(reads),
                                 jnp.asarray(lens), submat, gaps, **static))
    log(f"(4) replicated on {jax.devices()[0]}: "
        f"{time.perf_counter() - t0:.1f}s")

    mesh = make_mesh(1, 4)
    t0 = time.perf_counter()
    with mesh:
        out, offs, n_dp = map_batch_ref_sharded(mesh, gi, reads, lens, submat,
                                                gaps, **static)
        res = unpack_batch(out)
    ts, te = globalize_sharded(res, offs, n_dp)
    agree, checked = placement_parity(rep, res, ts, te, n_data=1)
    log(f"(4) ref-sharded (data=1, ref=4): parity {agree}/{checked} reads, "
        f"{time.perf_counter() - t0:.1f}s")
    if agree != checked:
        raise AssertionError(f"ref-sharded parity {agree}/{checked}")

    mesh = make_mesh(4, 1)
    t0 = time.perf_counter()
    with mesh:
        res2 = unpack_batch(map_batch_data_parallel(
            mesh, mapper.dev, jnp.asarray(reads), jnp.asarray(lens), submat,
            gaps, **static))
    agree2, checked2 = placement_parity(rep, res2, res2.t_start, res2.t_end,
                                        n_data=1)
    same = all(np.array_equal(getattr(rep, f), getattr(res2, f))
               for f in rep._fields)
    log(f"(4) data-parallel (data=4, ref=1): parity {agree2}/{checked2} "
        f"reads, identical to replicated: {same}, "
        f"{time.perf_counter() - t0:.1f}s")
    if agree2 != checked2:
        raise AssertionError(f"data-parallel parity {agree2}/{checked2}")


def main(argv) -> int:
    four = "--four" in argv
    if not os.path.isdir(os.path.join(REPO, "blasr_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from blasr_tpu.hostcache import enable_compile_cache
    cache = enable_compile_cache()

    log(f"(a) devices: {devices}")
    log(f"(a) device_kind: {dev.device_kind}; compile cache {cache}")
    log(f"(a) nvidia-smi: {card_line()}")
    if four:
        phase_four()
    else:
        t0 = time.perf_counter()
        contigs, gi, sims = bench_world()
        log(f"(b) bench world built in {time.perf_counter() - t0:.1f}s")
        phase_kernels(gi, sims)
        phase_goldens()
        phase_main_path_checked(contigs, sims)
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
