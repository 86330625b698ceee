"""Smoke run of the prover and verifier on one GPU, through the entry points
a user calls (`make_system`, `TpuKKW`, `StreamingKKW`, the CLI), at the sizes
of the five BASELINE.json configurations.

    python chip_smoke.py           # every phase, one GPU
    python chip_smoke.py --four    # the 4-GPU mesh path and its 1-GPU twin

Every proof is compared byte for byte with the NumPy golden backend
(`reverie_tpu.proof.prove`, run in worker processes that stay off the GPU
while the device phases run) or, for batches and the mesh, with a single
`prove` on one GPU.  Any failure raises and the script exits nonzero
without printing a result.  The last line of a passing run is
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
Times are printed as set-up (levelizing and the first call, which
compiles) and warm wall time, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SHA_MESSAGE = b"reverie chip smoke"
FUZZ_SEED = 11
BATCH_N = 1024
BATCH_CHUNK = 64
SAMPLES = 8
FOUR_BATCH_N = 64
#: repetition-seed stream of each golden-checked circuit
SEEDS = {"and1m": 3, "sha256": 5, "z64": 6, "b2a": 7, "fuzz": 8}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def seeds_for(seed: int, n: int = 0) -> np.ndarray:
    """(256, 16) per-repetition seeds, or (n, 256, 16) for n proofs."""
    shape = (n, 256, 16) if n else (256, 16)
    return np.random.RandomState(seed).randint(0, 256, size=shape,
                                               dtype=np.uint8)


def circuit(name: str):
    """(program, gf2 witness, z64 witness) of a named smoke circuit."""
    from reverie_tpu.circuit import builders

    if name == "and1m":
        return builders.mul_bench_circuit(1_000_000)
    if name == "sha256":
        from reverie_tpu.circuit.sha256 import (
            block_to_witness_bits, sha256_pad_one_block,
            sha256_preimage_statement)

        prog, _ = sha256_preimage_statement(hashlib.sha256(SHA_MESSAGE).digest())
        return prog, block_to_witness_bits(sha256_pad_one_block(SHA_MESSAGE)), []
    if name == "z64":
        return builders.z64_mul_bench_circuit(50_000)
    if name == "b2a":
        return builders.mixed_b2a_circuit()
    if name == "fuzz":
        return builders.random_mixed_circuit(FUZZ_SEED)
    raise ValueError(name)


def golden_proof(name: str, seed: int) -> bytes:
    """Golden-backend proof bytes (runs in a worker process, off the GPU)."""
    from reverie_tpu.proof import prove

    prog, w2, wz = circuit(name)
    return prove(prog, w2, wz, seeds=seeds_for(seed).reshape(32, 8, 16)).to_bytes()


def _worker_init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def tamper(blob: bytes) -> bytes:
    """Flip byte 40 of a proof: the first online repetition's `omit`."""
    bad = bytearray(blob)
    bad[40] ^= 0xFF
    return bytes(bad)


class Smoke:
    def __init__(self, pool):
        self.pool = pool
        self.goldens = {}
        self.times = {}
        self.proofs = {}

    def golden(self, name: str):
        self.goldens[name] = self.pool.submit(golden_proof, name, SEEDS[name])

    def expect_golden(self, name: str, blob: bytes) -> None:
        want = self.goldens.pop(name).result()
        check(blob == want, f"{name}: proof bytes differ from the golden backend")
        log(f"  {name}: {len(blob)} proof bytes equal the golden backend")

    def record(self, name: str, **kw) -> None:
        self.times[name] = kw
        log(f"  {name}: " + ", ".join(f"{k}={v:.3f}s" if isinstance(v, float)
                                       else f"{k}={v}" for k, v in kw.items()))

    # -- phases -------------------------------------------------------------
    def cli(self) -> None:
        from reverie_tpu import cli
        from reverie_tpu.circuit import CombineOp, Gate, Op, dumps_program
        from reverie_tpu.circuit.witness import format_witness_bits

        prog = [
            CombineOp.gf2(Gate(Op.INPUT, dst=0)),
            CombineOp.gf2(Gate(Op.INPUT, dst=1)),
            CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1)),
            CombineOp.gf2(Gate(Op.ADDC, dst=3, src1=2, const=1)),
            CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=3)),
        ]
        with tempfile.TemporaryDirectory() as d:
            pp, wp, proof = (os.path.join(d, f) for f in
                             ("prog.bin", "wit.txt", "proof.bin"))
            with open(pp, "wb") as f:
                f.write(dumps_program(prog))
            with open(wp, "wb") as f:
                f.write(format_witness_bits([True, True]))

            def run(*argv):
                out = io.StringIO()
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = cli.main(list(argv))
                return rc, out.getvalue()

            (rc, _), t_prove = timed(lambda: run(
                "--operation", "prove", "--program-path", pp,
                "--witness-path", wp, "--proof-path", proof,
                "--backend", "tpu"))
            check(rc == 0, f"cli prove rc={rc}")
            (rc, out), t_verify = timed(lambda: run(
                "--operation", "verify", "--program-path", pp,
                "--proof-path", proof, "--backend", "tpu"))
            check(rc == 0 and "Ok(())" in out, f"cli verify rc={rc}: {out!r}")
            with open(proof, "rb") as f:
                blob = f.read()
            with open(proof, "wb") as f:
                f.write(tamper(blob))
            rc, _ = run("--operation", "verify", "--program-path", pp,
                        "--proof-path", proof, "--backend", "tpu")
            check(rc == 1, f"cli verify of a tampered proof rc={rc}")
        self.record("cli", first_prove=t_prove, first_verify=t_verify)

    def and1m(self, dev) -> None:
        from reverie_tpu import make_system
        from reverie_tpu.backend.tpu_host import TpuKKW
        from reverie_tpu.proof import Proof

        prog, w2, wz = circuit("and1m")
        sys_, t_lev = timed(lambda: make_system(prog))
        check(isinstance(sys_, TpuKKW), f"make_system chose {type(sys_)}")
        s = seeds_for(SEEDS["and1m"])
        proof, t_first = timed(lambda: sys_.prove(w2, wz, seeds=s))
        blob = proof.to_bytes()
        self.expect_golden("and1m", blob)
        t_prove = min(timed(lambda: sys_.prove(w2, wz, seeds=s))[1]
                      for _ in range(3))
        ok, t_vfirst = timed(lambda: sys_.verify(proof))
        check(ok, "and1m: verify rejected an honest proof")
        ok, t_verify = timed(lambda: sys_.verify(proof))
        check(ok, "and1m: warm verify rejected an honest proof")
        check(not sys_.verify(Proof.from_bytes(tamper(blob))),
              "and1m: verify accepted a tampered proof")
        many_seeds = seeds_for(4, 4)
        proofs, t_many = timed(lambda: sys_.prove_many([(w2, wz)] * 4,
                                                       seeds=many_seeds))
        for i in range(4):
            one = sys_.prove(w2, wz, seeds=many_seeds[i]).to_bytes()
            check(proofs[i].to_bytes() == one,
                  f"and1m: prove_many proof {i} differs from prove")
        self.proofs["and1m"] = (blob, s)
        self.record("and1m", setup_levelize=t_lev, setup_first_prove=t_first,
                    setup_first_verify=t_vfirst, prove=t_prove,
                    verify=t_verify, prove_many_per_proof=t_many / 4,
                    and_gates_per_s_single=int(1_000_000 / t_prove),
                    peak_bytes=peak_bytes(dev))

    def sha256(self, dev):
        from reverie_tpu import make_system

        prog, w2, wz = circuit("sha256")
        sys_, t_lev = timed(lambda: make_system(prog))
        s = seeds_for(SEEDS["sha256"])
        proof, t_first = timed(lambda: sys_.prove(w2, wz, seeds=s))
        self.expect_golden("sha256", proof.to_bytes())
        t_prove = min(timed(lambda: sys_.prove(w2, wz, seeds=s))[1]
                      for _ in range(3))
        ok, t_vfirst = timed(lambda: sys_.verify(proof))
        check(ok, "sha256: verify rejected an honest proof")
        ok, t_verify = timed(lambda: sys_.verify(proof))
        check(ok, "sha256: warm verify rejected an honest proof")
        self.record("sha256", depth=sys_.cc.depth,
                    setup_levelize=t_lev, setup_first_prove=t_first,
                    setup_first_verify=t_vfirst, prove=t_prove,
                    verify=t_verify, peak_bytes=peak_bytes(dev))
        return sys_, w2

    def z64_and_bridges(self, dev) -> None:
        from reverie_tpu import make_system

        for name in ("z64", "b2a", "fuzz"):
            prog, w2, wz = circuit(name)
            sys_, t_lev = timed(lambda: make_system(prog))
            s = seeds_for(SEEDS[name])
            proof, t_first = timed(lambda: sys_.prove(w2, wz, seeds=s))
            self.expect_golden(name, proof.to_bytes())
            t_prove = min(timed(lambda: sys_.prove(w2, wz, seeds=s))[1]
                          for _ in range(2))
            self.record(name, setup_levelize=t_lev, setup_first_prove=t_first,
                        prove=t_prove, peak_bytes=peak_bytes(dev))

    def batch(self, sys_, w2) -> list:
        """BATCH_N proofs of the SHA-256 statement.  A preimage statement
        has exactly one witness, so the proofs differ in their randomness:
        every proof draws its own repetition seeds from one seed."""
        seeds = seeds_for(9, BATCH_N)
        wits = [(w2, [])] * BATCH_N
        _, t_first = timed(lambda: sys_.prove_batch_chunked(
            wits[:BATCH_CHUNK], seeds=seeds[:BATCH_CHUNK], chunk=BATCH_CHUNK))
        proofs, t_all = timed(lambda: sys_.prove_batch_chunked(
            wits, seeds=seeds, chunk=BATCH_CHUNK))
        check(len(proofs) == BATCH_N, "batch: wrong proof count")
        sample = np.random.RandomState(10).choice(BATCH_N, SAMPLES, replace=False)
        picked = []
        for i in sample:
            one = sys_.prove(w2, [], seeds=seeds[i])
            check(proofs[i].to_bytes() == one.to_bytes(),
                  f"batch: proof {i} differs from a single prove")
            check(sys_.verify(proofs[i]), f"batch: proof {i} rejected")
            picked.append(proofs[i])
        self.record("batch", n=BATCH_N, chunk=BATCH_CHUNK,
                    setup_first_chunk=t_first, total=t_all,
                    proofs_per_s=f"{BATCH_N / t_all:.2f}")
        return picked

    def verify_many(self, sys_, proofs) -> None:
        from reverie_tpu.proof import Proof

        stream = list(proofs)
        for i in (2, 5):
            stream[i] = Proof.from_bytes(tamper(stream[i].to_bytes()))
        want = [sys_.verify(p) for p in stream]
        check(want == [i not in (2, 5) for i in range(len(stream))],
              f"verify_many: verify() verdicts {want}")
        got, t = timed(lambda: sys_.verify_many(stream))
        check(got == want, f"verify_many: {got} != verify() {want}")
        self.record("verify_many", n=len(stream), rejected=2, total=t)

    def stream(self) -> None:
        from reverie_tpu import make_system
        from reverie_tpu.backend.streaming import StreamingKKW
        from reverie_tpu.backend.tpu_host import device_footprint

        prog, w2, wz = circuit("and1m")
        blob, s = self.proofs["and1m"]
        # a budget just under the exact footprint: make_system must segment
        fp = device_footprint(make_system(prog).cc, 256)
        sk, t_lev = timed(lambda: make_system(prog, hbm_budget_bytes=fp * 9 // 10))
        check(isinstance(sk, StreamingKKW), f"make_system chose {type(sk)}")
        proof, t_first = timed(lambda: sk.prove(w2, wz, seeds=s))
        check(proof.to_bytes() == blob,
              "stream: proof differs from the unsegmented and1m proof")
        check("aes" in sk._bitx,
              "stream: no segment built its gf2 tape on the device")
        t_prove = timed(lambda: sk.prove(w2, wz, seeds=s))[1]
        self.record("stream", segments=len(sk.segments), setup_levelize=t_lev,
                    setup_first_prove=t_first, prove=t_prove)


def run_one_card(smoke: Smoke, dev) -> None:
    for name in SEEDS:
        smoke.golden(name)
    log("[cli]")
    smoke.cli()
    log("[and1m]")
    smoke.and1m(dev)
    log("[sha256]")
    sha_sys, sha_w2 = smoke.sha256(dev)
    log("[z64, b2a, fuzz]")
    smoke.z64_and_bridges(dev)
    log("[batch]")
    sample = smoke.batch(sha_sys, sha_w2)
    log("[verify_many]")
    smoke.verify_many(sha_sys, sample)
    log("[stream]")
    smoke.stream()


def run_four_cards(smoke: Smoke) -> None:
    import jax

    from reverie_tpu.backend.tpu_host import TpuKKW
    from reverie_tpu.parallel import make_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(4)
    log("[four: and1m sharded]")
    prog, w2, wz = circuit("and1m")
    s = seeds_for(SEEDS["and1m"])
    one = TpuKKW(prog)
    blob, t_one = timed(lambda: one.prove(w2, wz, seeds=s).to_bytes())
    sharded = TpuKKW(prog, mesh=mesh, cc=one.cc)
    proof, t_first = timed(lambda: sharded.prove(w2, wz, seeds=s))
    check(proof.to_bytes() == blob, "four: sharded 1M proof differs from 1 GPU")
    t_prove = min(timed(lambda: sharded.prove(w2, wz, seeds=s))[1]
                  for _ in range(3))
    t_single = min(timed(lambda: one.prove(w2, wz, seeds=s))[1]
                   for _ in range(3))
    check(sharded.verify(proof), "four: sharded verify rejected the proof")
    peaks = [peak_bytes(d) for d in devs]
    log(f"  per-GPU peak bytes after the 1M phase: {peaks}")
    check(min(peaks[1:]) > 0, "four: a GPU of the mesh held no arrays")
    smoke.record("four_and1m", setup_first_prove_1gpu=t_one,
                 setup_first_prove_4gpu=t_first, prove_1gpu=t_single,
                 prove_4gpu=t_prove)
    log(f"[four: sha256 batch of {FOUR_BATCH_N}]")
    prog, w2, _ = circuit("sha256")
    seeds = seeds_for(9, FOUR_BATCH_N)
    wits = [(w2, [])] * FOUR_BATCH_N
    one = TpuKKW(prog)
    want, t_b1 = timed(lambda: [p.to_bytes()
                                for p in one.prove_batch(wits, seeds=seeds)])
    sharded = TpuKKW(prog, mesh=mesh, cc=one.cc)
    got, t_b4 = timed(lambda: [p.to_bytes()
                               for p in sharded.prove_batch(wits, seeds=seeds)])
    check(got == want, "four: sharded batch differs from 1 GPU")
    t_b4w = timed(lambda: sharded.prove_batch(wits, seeds=seeds))[1]
    t_b1w = timed(lambda: one.prove_batch(wits, seeds=seeds))[1]
    smoke.record("four_batch", setup_first_1gpu=t_b1, setup_first_4gpu=t_b4,
                 batch_1gpu=t_b1w, batch_4gpu=t_b4w,
                 peak_bytes=[peak_bytes(d) for d in devs])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-GPU mesh path and its 1-GPU twin")
    args = p.parse_args(argv)

    import jax

    from reverie_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    log(f"[env] jax {jax.__version__}; devices {jax.devices()}")
    check(jax.default_backend() == "gpu",
          f"no GPU: JAX backend is {jax.default_backend()!r}")
    name_power = card()
    log(f"  card: {name_power}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache_dir}")
    dev = jax.devices()[0]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=ctx, initializer=_worker_init) as pool:
        smoke = Smoke(pool)
        if args.four:
            run_four_cards(smoke)
        else:
            run_one_card(smoke, dev)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s "
        f"on {name_power}")
    log(json.dumps({"card": name_power, "phases": smoke.times}))
    log(name_power)
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
