"""Full benchmark battery (BASELINE.json configs).

Usage: python bench_suite.py [config ...]
Configs: and1m sha256 z64 batch verify   (default: all)

Each config prints a JSON line to stdout; phase breakdowns go to stderr.
(The driver's headline bench stays in bench.py.)
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _setup_jax():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from reverie_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()


def _time2(fn):
    """warmup (compile) + steady-state timing"""
    t0 = time.time()
    fn()
    warm = time.time() - t0
    t0 = time.time()
    out = fn()
    return out, time.time() - t0, warm


def bench_and1m():
    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.builders import mul_bench_circuit

    n = int(os.environ.get("BENCH_GATES", 1_000_000))
    prog, wit2, witz = mul_bench_circuit(n)
    sys_ = TpuKKW(prog)
    seeds = np.random.RandomState(0).randint(0, 256, size=(256, 16), dtype=np.uint8)
    _, dt, warm = _time2(lambda: sys_.prove(wit2, witz, seeds=seeds))
    log(f"and1m: prove {dt:.2f}s (warm {warm:.1f}s)")
    print(json.dumps({"metric": "and_gates_per_sec_1m", "value": round(n / dt),
                      "unit": "gates/s"}))
    return sys_, prog


def bench_sha256():
    import hashlib

    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.sha256 import (
        block_to_witness_bits,
        sha256_pad_one_block,
        sha256_preimage_statement,
    )

    msg = b"benchmark preimage"
    prog, _ = sha256_preimage_statement(hashlib.sha256(msg).digest())
    wit = block_to_witness_bits(sha256_pad_one_block(msg))
    sys_ = TpuKKW(prog)
    seeds = np.random.RandomState(1).randint(0, 256, size=(256, 16), dtype=np.uint8)
    proof, dt, warm = _time2(lambda: sys_.prove(wit, [], seeds=seeds))
    log(f"sha256: prove {dt:.3f}s (warm {warm:.1f}s), proof {len(proof.to_bytes())}B")
    t0 = time.time()
    ok = sys_.verify(proof)
    vt = time.time() - t0
    t0 = time.time()
    ok = sys_.verify(proof) and ok
    vt = time.time() - t0
    log(f"sha256: verify {vt:.3f}s ok={ok}")
    assert ok
    print(json.dumps({"metric": "sha256_prove_latency", "value": round(dt, 4),
                      "unit": "s"}))


def bench_z64():
    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.builders import z64_mul_bench_circuit

    n = int(os.environ.get("BENCH_Z64_GATES", 5_000))
    prog, wit2, witz = z64_mul_bench_circuit(n)
    sys_ = TpuKKW(prog)
    seeds = np.random.RandomState(2).randint(0, 256, size=(256, 16), dtype=np.uint8)
    _, dt, warm = _time2(lambda: sys_.prove(wit2, witz, seeds=seeds))
    log(f"z64: {n} mul gates prove {dt:.2f}s (warm {warm:.1f}s)")
    print(json.dumps({"metric": "z64_mul_gates_per_sec", "value": round(n / dt),
                      "unit": "gates/s"}))


def bench_batch():
    import hashlib

    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.sha256 import (
        block_to_witness_bits,
        sha256_pad_one_block,
        sha256_preimage_statement,
    )

    N = int(os.environ.get("BENCH_BATCH", 16))
    msg = b"batched preimage"
    prog, _ = sha256_preimage_statement(hashlib.sha256(msg).digest())
    wit = block_to_witness_bits(sha256_pad_one_block(msg))
    sys_ = TpuKKW(prog)
    wits = [(wit, [])] * N
    seeds = np.random.RandomState(3).randint(0, 256, size=(N, 256, 16), dtype=np.uint8)
    proofs, dt, warm = _time2(lambda: sys_.prove_batch(wits, seeds=seeds))
    log(f"batch: {N} sha256 proofs in {dt:.2f}s (warm {warm:.1f}s) "
        f"-> {N/dt:.2f} proofs/s")
    print(json.dumps({"metric": "sha256_proofs_per_sec_batch", "value": round(N / dt, 3),
                      "unit": "proofs/s", "batch": N}))


def bench_verify():
    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit.builders import mul_bench_circuit

    n = int(os.environ.get("BENCH_GATES", 1_000_000))
    prog, wit2, witz = mul_bench_circuit(n)
    sys_ = TpuKKW(prog)
    seeds = np.random.RandomState(4).randint(0, 256, size=(256, 16), dtype=np.uint8)
    proof = sys_.prove(wit2, witz, seeds=seeds)
    ok, dt, warm = _time2(lambda: sys_.verify(proof))
    assert ok
    log(f"verify(1m): {dt:.2f}s (warm {warm:.1f}s)")
    print(json.dumps({"metric": "and_gates_per_sec_verify_1m", "value": round(n / dt),
                      "unit": "gates/s"}))


def bench_streaming():
    """Segmented streaming prove (backend/streaming.py) at 4M gates."""
    from reverie_tpu.backend.streaming import StreamingKKW
    from reverie_tpu.circuit.builders import mul_bench_circuit

    n = int(os.environ.get("BENCH_STREAM_GATES", 4_000_000))
    prog, wit2, witz = mul_bench_circuit(n)
    sk = StreamingKKW(prog, 1 << 20)
    seeds = np.random.RandomState(5).randint(0, 256, size=(256, 16), dtype=np.uint8)
    proof, dt, warm = _time2(lambda: sk.prove(wit2, witz, seeds=seeds))
    log(f"streaming: {n} gates / {len(sk.segments)} segments prove {dt:.2f}s "
        f"(warm {warm:.1f}s)")
    print(json.dumps({"metric": "and_gates_per_sec_streamed", "value": round(n / dt),
                      "unit": "gates/s", "segments": len(sk.segments)}))
    ok, dt, warm = _time2(lambda: sk.verify(proof))
    assert ok
    log(f"streaming: verify {dt:.2f}s (warm {warm:.1f}s)")
    print(json.dumps({"metric": "and_gates_per_sec_streamed_verify",
                      "value": round(n / dt), "unit": "gates/s"}))


def bench_z64_deep():
    """Deep serial z64 mul chain through the scan executor (round-2c: the
    z64/B2A scan body)."""
    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.circuit import CombineOp, Gate, Op

    n = int(os.environ.get("BENCH_Z64_DEEP", 2_000))
    prog = [
        CombineOp.z64(Gate(Op.INPUT, dst=0)),
        CombineOp.z64(Gate(Op.INPUT, dst=1)),
    ]
    prog.extend(
        CombineOp.z64(Gate(Op.MUL, dst=1, src1=0, src2=1)) for _ in range(n)
    )
    sys_ = TpuKKW(prog)
    seeds = np.random.RandomState(8).randint(0, 256, size=(256, 16), dtype=np.uint8)
    _, dt, warm = _time2(lambda: sys_.prove([], [3, 5], seeds=seeds))
    log(f"z64_deep: {n} serial muls prove {dt:.2f}s (warm {warm:.1f}s)")
    print(json.dumps({"metric": "z64_deep_mul_gates_per_sec", "value": round(n / dt),
                      "unit": "gates/s"}))


def bench_sha256_long():
    """Multi-block SHA-256 (deep+wide flagship) streamed through scan-mode
    segments."""
    import hashlib

    from reverie_tpu.backend.streaming import StreamingKKW
    from reverie_tpu.circuit.sha256 import (
        block_to_witness_bits,
        count_and_gates,
        sha256_long_preimage_statement,
        sha256_pad_message,
    )

    blocks = int(os.environ.get("BENCH_SHA_BLOCKS", 8))
    msg = bytes(range(256)) * ((blocks * 64 - 9) // 256 + 1)
    msg = msg[: blocks * 64 - 9]
    padded = sha256_pad_message(msg)
    assert len(padded) == blocks * 64
    prog, _ = sha256_long_preimage_statement(hashlib.sha256(msg).digest(), blocks)
    wit = []
    for i in range(0, len(padded), 64):
        wit.extend(block_to_witness_bits(padded[i : i + 64]))
    n_and = count_and_gates(prog)
    sk = StreamingKKW(prog, 60_000)
    seeds = np.random.RandomState(9).randint(0, 256, size=(256, 16), dtype=np.uint8)
    proof, dt, warm = _time2(lambda: sk.prove(wit, [], seeds=seeds))
    log(f"sha256_long: {blocks} blocks ({n_and} ANDs, {len(sk.segments)} "
        f"segments) prove {dt:.2f}s (warm {warm:.1f}s)")
    print(json.dumps({"metric": "sha256_long_and_gates_per_sec",
                      "value": round(n_and / dt), "unit": "gates/s",
                      "blocks": blocks}))
    ok, dt, _ = _time2(lambda: sk.verify(proof))
    assert ok
    print(json.dumps({"metric": "sha256_long_verify_s", "value": round(dt, 2),
                      "unit": "s"}))


ALL = {"and1m": bench_and1m, "sha256": bench_sha256, "z64": bench_z64,
       "batch": bench_batch, "verify": bench_verify, "streaming": bench_streaming,
       "z64_deep": bench_z64_deep, "sha256_long": bench_sha256_long}


if __name__ == "__main__":
    _setup_jax()
    which = sys.argv[1:] or list(ALL)
    for name in which:
        log(f"=== {name} ===")
        try:
            ALL[name]()
        except Exception as e:  # keep the battery running past one failure
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            print(json.dumps({"metric": name, "value": None, "error": str(e)[:200]}))
