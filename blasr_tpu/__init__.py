"""blasr_tpu — a batched JAX long-read mapper with the capabilities of BLASR.

A from-scratch JAX/XLA re-design of the BLASR method
(reference: pb-vr/blasr; see SURVEY.md):

  * suffix-array / sorted-k-mer anchor finding  -> batched device searchsorted
  * maximal-interval clustering (windowed LIS)  -> O(A^2) vector chain DP
  * SDP sparse chaining                         -> anchor-chain guide path
  * banded affine guided alignment              -> banded DP (CUDA on GPUs)
  * mapQV, filter criteria, hit policies        -> log-sum-exp Phred, per-ZMW RNG

The compute path is pure-functional and jit-compiled over fixed-shape,
length-bucketed read batches; parallelism is expressed with
`jax.sharding.Mesh` + `shard_map` (data axis over reads, optional ref axis
over genome shards), not threads/semaphores.
"""

__version__ = "0.1.0"

from blasr_tpu.params import MappingParams  # noqa: F401
