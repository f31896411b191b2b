"""Multi-host orchestration: input sharding, deterministic merge.

Multi-process replacement for the reference's cross-node story (SURVEY.md
§2.9): ``--start/--stride`` independent processes
(RegisterBlasrOptions.h:93-94) become per-host read shards over a
``jax.distributed`` world, and the semaphore-serialized single output
stream (BlasrUtilsImpl.hpp:1020-1026) becomes per-host output files plus a
deterministic merge keyed by input order — byte-identical regardless of
host count, the property the reference's determinism tests check
(ctest/hitpolicy.t, ctest/deterministic.t).

Works in three modes:
  * single process (world = 1): passthrough;
  * multi-host clusters: ``init_distributed()`` wires jax.distributed from
    standard cluster env vars (one process per GPU: give each its card
    with ``CUDA_VISIBLE_DEVICES``, or every process reserves memory on
    every card of its host);
  * any launcher that sets BLASR_TPU_NUM_HOSTS / BLASR_TPU_HOST_ID
    (including plain multi-process CPU runs, used by the tests).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def init_distributed() -> Tuple[int, int]:
    """(host_id, n_hosts).  Initializes jax.distributed when cluster env
    vars are present; falls back to BLASR_TPU_* overrides, then (0, 1)."""
    if "BLASR_TPU_NUM_HOSTS" in os.environ:
        return (int(os.environ.get("BLASR_TPU_HOST_ID", "0")),
                int(os.environ["BLASR_TPU_NUM_HOSTS"]))
    if any(v in os.environ for v in
           ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")):
        import jax
        jax.distributed.initialize()
        return jax.process_index(), jax.process_count()
    import jax
    try:
        if jax.process_count() > 1:
            return jax.process_index(), jax.process_count()
    except RuntimeError:
        pass
    return 0, 1


def shard_reads(n_reads: int, host_id: int, n_hosts: int,
                start: int = 0, stride: int = 1) -> List[int]:
    """Read indices this host maps: the --start/--stride slice composed
    with round-robin host sharding (deterministic, balanced for the
    length-sorted streams PacBio movies produce)."""
    mine = range(start, n_reads, max(1, stride))
    return [i for k, i in enumerate(mine) if k % n_hosts == host_id]


def shard_path(out_path: str, host_id: int, n_hosts: int) -> str:
    """Per-host output file name (reference --outputByThread analog,
    Blasr.cpp:1476-1483)."""
    if n_hosts == 1:
        return out_path
    return f"{out_path}.host{host_id:04d}"


def merge_outputs(out_path: str, n_hosts: int,
                  keys_per_host: Sequence[Sequence[int]],
                  remove_parts: bool = True) -> None:
    """Merge per-host outputs into out_path, ordered by original read
    index.  Each host's file must contain one *record group* per mapped
    read, prefixed by '#@<read_index>' marker lines written by
    emit_with_markers (stripped on merge)."""
    groups = {}
    header = ""
    for h in range(n_hosts):
        part = shard_path(out_path, h, n_hosts)
        cur: Optional[int] = None
        buf: List[str] = []
        pre: List[str] = []
        with open(part) as f:
            for line in f:
                if line.startswith("#@"):
                    if cur is not None:
                        groups[cur] = "".join(buf)
                    cur = int(line[2:].strip())
                    buf = []
                elif cur is None:
                    pre.append(line)     # header lines before any marker
                else:
                    buf.append(line)
            if cur is not None:
                groups[cur] = "".join(buf)
        if h == 0:
            header = "".join(pre)
        if remove_parts:
            os.remove(part)
    with open(out_path, "w") as out:
        out.write(header)
        for idx in sorted(groups):
            out.write(groups[idx])


def _out_path_of(argv: Sequence[str]) -> Optional[str]:
    for i, a in enumerate(argv):
        if a in ("--out", "-o") and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--out="):
            return a.split("=", 1)[1]
    return None


def run_sharded(argv: List[str], barrier_timeout: float = 3600.0) -> int:
    """Entry point used by each host of a multi-host launch: run the
    standard CLI on this host's read shard; after all hosts finish
    (sentinel-file barrier, which works under jax.distributed and plain
    multi-process launches alike), host 0 merges the part files into the
    final output."""
    import time

    host_id, n_hosts = init_distributed()
    os.environ["BLASR_TPU_HOST_ID"] = str(host_id)
    os.environ["BLASR_TPU_NUM_HOSTS"] = str(n_hosts)
    from blasr_tpu.cli.blasr import run
    rc = run(argv)
    out_path = _out_path_of(argv)
    if n_hosts <= 1 or out_path in (None, "-"):
        return rc
    if any(f in argv for f in ("--bam",)):
        return rc  # BAM parts are left per-host (binary merge is external)
    done = shard_path(out_path, host_id, n_hosts) + ".done"
    with open(done, "w") as f:
        f.write(str(rc))
    if host_id != 0:
        return rc
    # host 0: wait for every host's sentinel, then merge + clean up
    deadline = time.time() + barrier_timeout
    sentinels = [shard_path(out_path, h, n_hosts) + ".done"
                 for h in range(n_hosts)]
    while not all(os.path.exists(s) for s in sentinels):
        if time.time() > deadline:
            raise TimeoutError(
                f"run_sharded: hosts not finished after {barrier_timeout}s")
        time.sleep(0.2)
    merge_outputs(out_path, n_hosts, [])
    for s in sentinels:
        os.remove(s)
    return rc
