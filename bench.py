"""Headline benchmark: AND gates/s proving (GF2, all 256 repetitions) on one
GPU.

`value` is the sustained (pipelined) proving throughput over a stream of
independent statements (TpuKKW.prove_many); `single_prove_s` reports
one-proof latency and `verify_s` one verification.  Every timed call ends
with the proof bytes (or the verdict) on the host, so the device work is
complete inside the timed window.  The first prove and verify compile and
are reported as set-up time.

Prints ONE JSON line with the device (platform, kind, count) and the card's
name and power limit.  Exits nonzero without a result when JAX finds no GPU
or when verification fails.

Circuit: the reference's prover-bench shape (proof/mod.rs:322-335) scaled to
BENCH_GATES AND gates (default 1M).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_GATES = int(os.environ.get("BENCH_GATES", 1_000_000))
PIPELINE = 4


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from reverie_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        log(f"bench.py needs a GPU; JAX backend is {jax.default_backend()!r}")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")

    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.builders import mul_bench_circuit

    prog, wit2, witz = mul_bench_circuit(N_GATES)
    t0 = time.perf_counter()
    sys_ = TpuKKW(prog)
    setup_levelize = time.perf_counter() - t0
    seeds = np.random.RandomState(0).randint(0, 256, size=(PIPELINE, 256, 16),
                                             dtype=np.uint8)

    t0 = time.perf_counter()
    proof = sys_.prove(wit2, witz, seeds=seeds[0])
    setup_prove = time.perf_counter() - t0
    dt_single = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        proof = sys_.prove(wit2, witz, seeds=seeds[0])
        dt_single = min(dt_single, time.perf_counter() - t0)

    jobs = [(wit2, witz)] * PIPELINE
    dt_pipe = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        proofs = sys_.prove_many(jobs, seeds=seeds)
        dt_pipe = min(dt_pipe, (time.perf_counter() - t0) / PIPELINE)
    if proofs[0].to_bytes() != proof.to_bytes():
        log("prove_many and prove disagree on the same seed")
        return 1

    t0 = time.perf_counter()
    ok = sys_.verify(proof)
    setup_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = sys_.verify(proof) and ok
    dt_verify = time.perf_counter() - t0
    if not ok:
        log("verification failed")
        return 1

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "AND_gates_per_sec_proving_z2_256reps",
        "value": round(N_GATES / dt_pipe),
        "unit": "gates/s",
        "single_prove_s": round(dt_single, 4),
        "verify_s": round(dt_verify, 4),
        "setup_s": {"levelize": round(setup_levelize, 2),
                    "first_prove": round(setup_prove, 2),
                    "first_verify": round(setup_verify, 2)},
        "peak_bytes_in_use": (dev.memory_stats() or {}).get("peak_bytes_in_use"),
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
