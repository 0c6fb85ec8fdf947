"""muscato_tpu — an exhaustive multi-mapping engine in JAX.

A from-scratch rebuild of the capabilities of Muscato (kshedden/muscato):
matching large collections of sequencing reads against large collections of
target sequences with exhaustive multi-mapping, using a windowed
seed-and-verify algorithm.

Where the reference is a Unix process pipeline (Go stage binaries + GNU
sort/join over snappy-compressed text files), this package is a single
Python driver around a device-resident, batched compute core:

- reads and targets are 5-letter-coded integer arrays (A,C,G,T,X),
- the per-window "screen" is an exact device-side hashed-key membership
  probe (replacing the reference's Bloom filters),
- the "confirm" step is a vectorized full-read Hamming verification kernel,
- sort/join/dedup stages are device sorts and gathers over integer keys,
- multi-chip scaling shards the target index by gene range over a
  jax.sharding.Mesh, with hit lists merged by collectives.

Layering (see SURVEY.md section 7):
  io/        host parsing/formatting: fastq, fasta, .sz (snappy) streams
  ops/       device building blocks: packing, hashing, probing, verify
  engine/    single-driver end-to-end pipeline + report emission
  parallel/  mesh construction and sharded probe/verify
  utils/     logging, run-dir management
  bench/     synthetic data generation and benchmark harness
"""

__version__ = "0.1.0"
