"""Multi-process ("multi-host") proving.

The reference's only parallelism is a shared-memory rayon pool over its 32
packed repetition groups (proof/mod.rs:127-128).  Across many devices the two
analogous axes, both embarrassingly parallel, are:

* ``global_mesh()`` -- ONE proof with the repetition axis sharded over every
  process's devices.  Each process executes its slice of the repetitions;
  the only cross-process traffic is the per-rep commitment hashes (32 B/rep,
  all-gathered into the Fiat-Shamir barrier) and the replicated extraction
  buffers at proof assembly.  XLA inserts the collectives (NCCL between
  GPUs); TpuKKW detects a process-spanning mesh and emits
  replicated output shardings for everything the host must read.

* ``prove_batch_distributed`` -- N independent proofs with the proof axis
  split across processes (BASELINE.json config 5: a 1024-proof batch over a
  cluster).  Zero cross-process communication during proving: each process
  proves its contiguous slice on its local devices, then the serialized
  proofs are all-gathered so every process returns the identical full list.

Tested with multi-process CPU meshes (SURVEY.md section 4's recipe) in
tests/test_distributed.py; the same code drives multi-host GPU clusters, where
``initialize`` is called once per host before any backend use.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .mesh import REP_AXIS


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               **kw) -> None:
    """Join the multi-process runtime (wraps jax.distributed.initialize).

    Must run before any JAX backend use.  On CPU test rigs, set
    ``XLA_FLAGS=--xla_force_host_platform_device_count=K`` per process first
    so each process contributes K virtual devices to the global mesh.
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def mesh_is_multiprocess(mesh) -> bool:
    """True if the mesh spans devices owned by more than one process."""
    if mesh is None:
        return False
    return len({d.process_index for d in mesh.devices.flat}) > 1


def global_mesh(axis: str = REP_AXIS):
    """A 1-D mesh over every device of every process (rep-axis sharding of a
    single proof).  total_reps (256) must divide by the global device count;
    the verifier's 40/216-rep re-executions pad to the mesh multiple
    (TpuKKW._rep_pad), so a single proof scales to any power-of-two mesh up
    to 256 devices."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def local_mesh(axis: str = REP_AXIS):
    """A mesh over this process's own devices only (independent per-process
    compute inside a multi-process runtime)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.local_devices()), (axis,))


def batch_slices(n: int) -> List[np.ndarray]:
    """Contiguous per-process index slices of an n-proof batch."""
    import jax

    return np.array_split(np.arange(n), jax.process_count())


def _allgather_rows(mat: np.ndarray) -> np.ndarray:
    """All-gather equal-shape row blocks from every process ->
    (num_processes * rows, cols), in process order."""
    from jax.experimental import multihost_utils as mhu

    return np.asarray(mhu.process_allgather(mat, tiled=True))


def allgather_blobs(blobs: Sequence[bytes], max_rows: int) -> List[List[bytes]]:
    """All-gather variable-length byte strings: every process contributes up
    to ``max_rows`` blobs and receives every process's list (process order).
    """
    import jax

    nproc = jax.process_count()
    # int32 explicitly: x64 is disabled, so an int64 matrix would silently
    # downcast inside process_allgather -- make the wire dtype the real one
    # and assert the blobs fit (2 GiB per blob is far beyond any proof)
    assert all(len(b) <= np.iinfo(np.int32).max for b in blobs)
    lens = np.zeros(max_rows, np.int32)
    lens[: len(blobs)] = [len(b) for b in blobs]
    all_lens = _allgather_rows(lens.reshape(max_rows, 1)).reshape(nproc, max_rows)
    maxlen = max(1, int(all_lens.max()))
    mat = np.zeros((max_rows, maxlen), np.uint8)
    for i, b in enumerate(blobs):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
    gathered = _allgather_rows(mat).reshape(nproc, max_rows, maxlen)
    # padded rows come back as b""; callers index by their known slice sizes
    return [
        [gathered[p, i, : all_lens[p, i]].tobytes() for i in range(max_rows)]
        for p in range(nproc)
    ]


def prove_batch_distributed(kkw, witnesses, seeds: np.ndarray,
                            pipelined: bool = True):
    """Prove an N-statement batch with the proof axis split across processes.

    ``kkw``: a TpuKKW built per-process (mesh=None or a local_mesh()).
    ``seeds``: (N, total_reps, 16) -- identical on every process, so proof i
    is byte-identical no matter which process proves it.  Returns the full
    list of N proofs on every process (serialized bytes all-gathered).
    """
    import jax

    from ..proof.container import Proof

    n = len(witnesses)
    if n == 0:
        return []
    seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(n, -1, 16)
    slices = batch_slices(n)
    mine = slices[jax.process_index()]
    jobs = [witnesses[i] for i in mine]
    if pipelined and len(jobs) > 1:
        local = kkw.prove_many(jobs, seeds=seeds[mine])
    else:
        local = [kkw.prove(w2, wz, seeds=seeds[i])
                 for (w2, wz), i in zip(jobs, mine)]
    max_rows = max(len(s) for s in slices)
    per_proc = allgather_blobs([p.to_bytes() for p in local], max_rows)
    out: List[Optional[Proof]] = [None] * n
    for p, idx in enumerate(slices):
        for j, i in enumerate(idx):
            out[i] = Proof.from_bytes(per_proc[p][j])
    return out
