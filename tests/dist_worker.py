"""Multi-process mesh worker (launched by tests/test_distributed.py).

Each worker process joins a jax.distributed runtime over loopback, then
checks, against goldens it computes locally on its own devices:

1. rep-axis global-mesh proving (GF2) is byte-identical to unsharded,
2. the same for a mixed z64+B2A circuit, and distributed verify accepts,
3. proof-axis `prove_batch_distributed` returns the full byte-identical
   batch on every process.

This is the multi-process shape of the reference's rayon parallelism
(proof/mod.rs:127-128) -- SURVEY.md section 4's multi-process CPU mesh
recipe.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # the launcher normally pins this; 4 devices/process keeps 40- and
    # 216-rep verifier batches divisible on a 2-process mesh
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

from reverie_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()


def main() -> None:
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    from reverie_tpu.parallel import distributed as dist

    dist.initialize(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc

    import numpy as np

    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.builders import (
        mixed_b2a_circuit,
        mul_bench_circuit,
    )

    rng = np.random.RandomState(42)
    seeds = rng.randint(0, 256, size=(256, 16), dtype=np.uint8)
    gm = dist.global_mesh()
    assert dist.mesh_is_multiprocess(gm)

    # 1. rep-axis sharded single proof, GF2 ---------------------------------
    prog, wit2, witz = mul_bench_circuit(24)
    golden = TpuKKW(prog).prove(wit2, witz, seeds=seeds).to_bytes()
    sys_ = TpuKKW(prog, mesh=gm)
    p = sys_.prove(wit2, witz, seeds=seeds)
    assert p.to_bytes() == golden, "distributed gf2 proof bytes mismatch"
    assert sys_.verify(p), "distributed verify rejected an honest proof"

    # 2. mixed z64 + B2A circuit --------------------------------------------
    prog2, w2b, wzb = mixed_b2a_circuit()
    golden2 = TpuKKW(prog2).prove(w2b, wzb, seeds=seeds).to_bytes()
    sys2 = TpuKKW(prog2, mesh=gm)
    p2 = sys2.prove(w2b, wzb, seeds=seeds)
    assert p2.to_bytes() == golden2, "distributed b2a proof bytes mismatch"
    assert sys2.verify(p2), "distributed b2a verify failed"

    # 3. proof-axis distributed batch ---------------------------------------
    n = 4
    seeds_n = rng.randint(0, 256, size=(n, 256, 16), dtype=np.uint8)
    wits = [(wit2, witz)] * n
    proofs = dist.prove_batch_distributed(TpuKKW(prog), wits, seeds_n)
    for i in range(n):
        g = TpuKKW(prog).prove(wit2, witz, seeds=seeds_n[i]).to_bytes()
        assert proofs[i].to_bytes() == g, f"batch proof {i} mismatch"

    with open(os.path.join(outdir, f"ok_{pid}"), "w") as f:
        f.write("OK")
    print(f"proc {pid}: all distributed checks OK", flush=True)


if __name__ == "__main__":
    main()
