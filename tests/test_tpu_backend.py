"""Differential tests: the levelized JAX executor (device backend) must
produce byte-identical proofs to the CPU golden backend, and its verifier
must accept them.  These run on the CPU platform (conftest); the same code
path runs on the GPU in chip_smoke.py."""

import numpy as np
import pytest

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit import CombineOp, Gate, Op
from reverie_tpu.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    wide_and_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu.proof import prove as cpu_prove
from reverie_tpu.proof import verify as cpu_verify


def seeds256():
    rng = np.random.RandomState(42)
    return rng.randint(0, 256, size=(256, 16), dtype=np.uint8)


CIRCUITS = {
    "mul20": lambda: mul_bench_circuit(20),
    "wide_and": lambda: wide_and_circuit(80, width=32, seed=7),
    "z64": lambda: z64_mul_bench_circuit(10),
    "b2a": lambda: mixed_b2a_circuit(),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_tpu_matches_cpu_proof_bytes(name):
    prog, wit2, witz = CIRCUITS[name]()
    s = seeds256()
    cpu_proof = cpu_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16))
    sys_ = TpuKKW(prog)
    tpu_proof = sys_.prove(wit2, witz, seeds=s)
    assert tpu_proof.to_bytes() == cpu_proof.to_bytes()
    # cross-verification both ways
    assert sys_.verify(tpu_proof)
    assert cpu_verify(tpu_proof, prog)
    assert sys_.verify(cpu_proof)


def test_tpu_rejects_tampered():
    prog, wit2, witz = mul_bench_circuit(20)
    sys_ = TpuKKW(prog)
    proof = sys_.prove(wit2, witz, seeds=seeds256())
    from reverie_tpu.proof import Proof

    blob = bytearray(proof.to_bytes())
    blob[5] ^= 1
    assert not sys_.verify(Proof.from_bytes(bytes(blob)))
    blob = bytearray(proof.to_bytes())
    blob[-1] ^= 1
    assert not sys_.verify(Proof.from_bytes(bytes(blob)))


def test_tpu_invalid_witness():
    prog = [
        CombineOp.gf2(Gate(Op.INPUT, dst=0)),
        CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=0)),
    ]
    sys_ = TpuKKW(prog)
    with pytest.raises(AssertionError):
        sys_.prove([True], [], seeds=seeds256())
    # valid witness passes
    proof = sys_.prove([False], [], seeds=seeds256())
    assert sys_.verify(proof)


def test_device_aes_tape_path():
    """m2 > 4096 routes tape generation through the bitsliced device AES
    kernel; the device tape must be byte-identical to the host-AES golden
    builder (the actual device-AES contract -- a full golden-prove diff at
    this size costs ~60 s of pure-Python golden execution and pins nothing
    extra), and the proof must round-trip."""
    from reverie_tpu.backend.tpu_host import build_tapes
    from reverie_tpu.crypto import expand_seeds

    prog, wit2, witz = mul_bench_circuit(2500)  # m2 = 5002 > 4096
    s = seeds256()
    sys_ = TpuKKW(prog)
    pk = expand_seeds(s).reshape(256, 8, 16)
    golden_tape, _, _ = build_tapes(pk, None, sys_.cc.m2, 0)
    dev_tape = np.asarray(sys_._gf2_tape(pk, None))[: sys_.cc.m2]
    np.testing.assert_array_equal(dev_tape, golden_tape)
    # prove integrates the device tape into the transcript; the verify leg
    # (two more executor compiles at R=40/216) adds ~30 s of cold XLA:CPU
    # compile; at this m2 class it is covered on the GPU by chip_smoke.py
    # and here by the slow-tier test_device_aes_tape_verify_roundtrip
    tpu_proof = sys_.prove(wit2, witz, seeds=s)
    assert len(tpu_proof.to_bytes()) > 0


def test_scan_executor_deep_circuit():
    """Deep GF2 circuits route through the lax.scan executor; proof bytes
    must match the golden backend (exercises wave packing + unified body)."""
    prog, wit2, witz = wide_and_circuit(700, width=8, seed=11)
    s = seeds256()
    sys_ = TpuKKW(prog)
    assert sys_.cc.depth > TpuKKW.SCAN_DEPTH_THRESHOLD
    from reverie_tpu.backend.tpu_scan import ScanExecutor

    assert isinstance(sys_._executor(0, 256), ScanExecutor)
    cpu_proof = cpu_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16))
    tpu_proof = sys_.prove(wit2, witz, seeds=s)
    assert tpu_proof.to_bytes() == cpu_proof.to_bytes()
    assert sys_.verify(tpu_proof)


def test_prove_batch_matches_single():
    """Batched proving must produce the same proofs as proving one by one
    with the same seeds (bench config 5 semantics)."""
    prog, wit2, witz = mul_bench_circuit(8)
    rng = np.random.RandomState(9)
    seeds = rng.randint(0, 256, size=(3, 256, 16), dtype=np.uint8)
    sys_ = TpuKKW(prog)
    wits = [(wit2, witz)] * 3
    batch = sys_.prove_batch(wits, seeds=seeds)
    for i in range(3):
        single = sys_.prove(wit2, witz, seeds=seeds[i])
        assert batch[i].to_bytes() == single.to_bytes(), i
        assert sys_.verify(batch[i])


def test_prove_batch_chunked_matches_batch():
    """Chunked pipelined batch proving (chunk i+1's device compute overlaps
    chunk i's challenge/pull/assembly) is byte-identical to prove_batch,
    including a ragged tail chunk."""
    prog, wit2, witz = mul_bench_circuit(8)
    rng = np.random.RandomState(17)
    n = 5
    seeds = rng.randint(0, 256, size=(n, 256, 16), dtype=np.uint8)
    sys_ = TpuKKW(prog)
    wits = [(wit2, witz)] * n
    chunked = sys_.prove_batch_chunked(wits, seeds=seeds, chunk=2)
    base = sys_.prove_batch(wits, seeds=seeds)
    for i in range(n):
        assert chunked[i].to_bytes() == base[i].to_bytes(), i
    assert sys_.verify(chunked[-1])


def test_prove_many_matches_single():
    """Pipelined proving (prove_many) must produce byte-identical proofs to
    prove() for the same seeds -- the pipeline only reorders host/device
    synchronization, never protocol messages."""
    prog, wit2, witz = mul_bench_circuit(8)
    rng = np.random.RandomState(11)
    seeds = rng.randint(0, 256, size=(3, 256, 16), dtype=np.uint8)
    sys_ = TpuKKW(prog)
    jobs = [(wit2, witz)] * 3
    proofs = sys_.prove_many(jobs, seeds=seeds)
    for i in range(3):
        single = sys_.prove(wit2, witz, seeds=seeds[i])
        assert proofs[i].to_bytes() == single.to_bytes(), i
        assert sys_.verify(proofs[i])


def test_prove_many_mixed_b2a_matches_single():
    """prove_many on a mixed GF2+Z64+B2A circuit (exercises the z64
    extraction buffers through the pipeline stages)."""
    prog, wit2, witz = mixed_b2a_circuit()
    rng = np.random.RandomState(12)
    seeds = rng.randint(0, 256, size=(2, 256, 16), dtype=np.uint8)
    sys_ = TpuKKW(prog)
    proofs = sys_.prove_many([(wit2, witz)] * 2, seeds=seeds)
    for i in range(2):
        single = sys_.prove(wit2, witz, seeds=seeds[i])
        assert proofs[i].to_bytes() == single.to_bytes(), i
        assert sys_.verify(proofs[i])


def test_device_aes_z64_tape_path():
    """mz > 512 routes z64 tape generation through the device AES kernel;
    the device tape must equal the host-AES golden builder (player-major
    (mz, 8, R) layout) and the proof must round-trip."""
    from reverie_tpu.backend.tpu_host import build_tapes
    from reverie_tpu.crypto import expand_seeds

    prog, wit2, witz = z64_mul_bench_circuit(300)  # mz = 602 > 512
    s = seeds256()
    sys_ = TpuKKW(prog)
    pk = expand_seeds(s).reshape(256, 8, 16)
    _, glo, ghi = build_tapes(pk, None, 0, sys_.cc.mz)
    dlo, dhi = sys_._z64_tape(pk, None)
    np.testing.assert_array_equal(np.asarray(dlo)[: sys_.cc.mz], glo)
    np.testing.assert_array_equal(np.asarray(dhi)[: sys_.cc.mz], ghi)
    # prove/verify integration at z64 shapes is covered by
    # test_tpu_matches_cpu_proof_bytes[z64]; recompiling the full 300-mul
    # z64 executor stack here added ~80 s for no new coverage


def test_mesh_sharded_prove_matches():
    """Proving with the repetition axis sharded over an 8-device mesh must
    produce byte-identical proofs (multi-chip path, virtual CPU mesh)."""
    from reverie_tpu.parallel import make_mesh

    prog, wit2, witz = mul_bench_circuit(20)
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    mesh = make_mesh(8)
    sharded_sys = TpuKKW(prog, mesh=mesh)
    sharded = sharded_sys.prove(wit2, witz, seeds=s)
    assert sharded.to_bytes() == base.to_bytes()
    assert sharded_sys.verify(sharded)


def test_mesh_sharded_scan_prove_matches():
    """The deep-circuit lax.scan executor composes with mesh sharding: the
    rep axis of the scan carry is sharded, wave tables replicate."""
    from reverie_tpu.backend.tpu_scan import ScanExecutor
    from reverie_tpu.parallel import make_mesh

    prog, wit2, witz = wide_and_circuit(700, width=8, seed=11)
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    sharded_sys = TpuKKW(prog, mesh=make_mesh(8))
    assert isinstance(sharded_sys._executor(0, 256), ScanExecutor)
    sharded = sharded_sys.prove(wit2, witz, seeds=s)
    assert sharded.to_bytes() == base.to_bytes()
    assert sharded_sys.verify(sharded)


def test_mesh_sharded_prove_batch_matches():
    """prove_batch shards the proof-lane axis (N*256) over the mesh and
    stays byte-identical to unsharded batch proving."""
    from reverie_tpu.parallel import make_mesh

    prog, wit2, witz = mul_bench_circuit(8)
    rng = np.random.RandomState(13)
    seeds = rng.randint(0, 256, size=(2, 256, 16), dtype=np.uint8)
    wits = [(wit2, witz)] * 2
    base = TpuKKW(prog).prove_batch(wits, seeds=seeds)
    sharded_sys = TpuKKW(prog, mesh=make_mesh(8))
    sharded = sharded_sys.prove_batch(wits, seeds=seeds)
    for b, sh in zip(base, sharded):
        assert sh.to_bytes() == b.to_bytes()
        assert sharded_sys.verify(sh)


def _deep_b2a_mixed_circuit(chain: int = 200):
    """mixed_b2a_circuit plus a deep GF2 MUL chain: forces the scan executor
    onto a circuit with z64 + B2A + gf2 ops in all three roles."""
    prog, wit2, witz = mixed_b2a_circuit()
    prog = list(prog[:-1])  # drop trailing deep-mul tail position independent
    for _ in range(chain):
        prog.append(CombineOp.gf2(Gate(Op.MUL, dst=2, src1=2, src2=3)))
    return prog, wit2, witz


def test_scan_executor_deep_z64_circuit():
    """Deep z64 circuits route through the scan executor (round-2c: the scan
    body computes every z64 gate family + opcode-select); proof bytes must
    match the golden backend and verification must accept."""
    from reverie_tpu.backend.tpu_scan import ScanExecutor

    # serial chain: every MUL reads the previous result -> depth ~n
    prog = [
        CombineOp.z64(Gate(Op.INPUT, dst=0)),
        CombineOp.z64(Gate(Op.INPUT, dst=1)),
    ]
    for _ in range(150):
        prog.append(CombineOp.z64(Gate(Op.MUL, dst=1, src1=0, src2=1)))
    prog.extend([
        CombineOp.z64(Gate(Op.ADDC, dst=2, src1=1, const=5)),
        CombineOp.z64(Gate(Op.SUB, dst=3, src1=2, src2=2)),
        CombineOp.z64(Gate(Op.ASSERT_ZERO, src1=3)),
    ])
    wit2, witz = [], [3, 5]
    s = seeds256()
    sys_ = TpuKKW(prog)
    assert sys_.cc.depth > TpuKKW.SCAN_DEPTH_THRESHOLD
    assert isinstance(sys_._executor(0, 256), ScanExecutor)
    cpu_proof = cpu_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16))
    tpu_proof = sys_.prove(wit2, witz, seeds=s)
    assert tpu_proof.to_bytes() == cpu_proof.to_bytes()
    assert sys_.verify(tpu_proof)


@pytest.mark.slow
def test_scan_executor_deep_b2a_circuit():
    """Deep mixed GF2+Z64+B2A circuit through the scan executor: B2A slots
    bridge the domains inside the scan body (bit gathers from the GF2 arena,
    64 bit-recon events into the GF2 online stream)."""
    from reverie_tpu.backend.tpu_scan import ScanExecutor

    prog, wit2, witz = _deep_b2a_mixed_circuit(200)
    s = seeds256()
    sys_ = TpuKKW(prog)
    assert sys_.cc.depth > TpuKKW.SCAN_DEPTH_THRESHOLD
    assert isinstance(sys_._executor(0, 256), ScanExecutor)
    cpu_proof = cpu_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16))
    tpu_proof = sys_.prove(wit2, witz, seeds=s)
    assert tpu_proof.to_bytes() == cpu_proof.to_bytes()
    assert sys_.verify(tpu_proof)


@pytest.mark.slow
def test_mesh_sharded_scan_z64_prove_matches():
    """Deep z64+B2A circuit through the scan executor under an 8-device
    mesh: rep-axis sharding must not change proof bytes (the z64 event
    scatters and B2A cross-domain gathers ride the sharded lane axis)."""
    from reverie_tpu.parallel import make_mesh

    prog, wit2, witz = _deep_b2a_mixed_circuit(150)
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    sharded = TpuKKW(prog, mesh=make_mesh(8))
    proof = sharded.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == base.to_bytes()
    assert sharded.verify(proof)


def test_prove_batch_deep_circuit_scan():
    """prove_batch on a deep circuit: the scan executor runs with the
    batched lane count (R = N*256) and stays byte-identical."""
    prog, wit2, witz = wide_and_circuit(700, width=8, seed=3)
    rng = np.random.RandomState(21)
    seeds = rng.randint(0, 256, size=(2, 256, 16), dtype=np.uint8)
    sys_ = TpuKKW(prog)
    assert sys_.cc.depth > TpuKKW.SCAN_DEPTH_THRESHOLD
    batch = sys_.prove_batch([(wit2, witz)] * 2, seeds=seeds)
    for i in range(2):
        single = sys_.prove(wit2, witz, seeds=seeds[i])
        assert batch[i].to_bytes() == single.to_bytes(), i


@pytest.mark.slow
def test_scan_executor_z64_all_ops_wide():
    """All z64 gate kinds (INPUT/ADD/SUB/ADDC/SUBC/MULC/MUL/CONST/RANDOM/
    ASSERT) in a deep circuit wide enough to saturate z64 wave slots
    (several z64 slots per level), byte-identical through the scan
    executor."""
    import random as _random

    from reverie_tpu.backend.tpu_scan import ScanExecutor

    rng = _random.Random(5)
    prog = []
    width = 6
    for w in range(width):
        prog.append(CombineOp.z64(Gate(Op.INPUT, dst=w)))
    prog.append(CombineOp.z64(Gate(Op.RANDOM, dst=width)))
    prog.append(CombineOp.z64(Gate(Op.CONST, dst=width + 1, const=0xDEADBEEFCAFEF00D)))
    kinds = [Op.ADD, Op.SUB, Op.ADDC, Op.SUBC, Op.MULC, Op.MUL]
    acc = 0  # serial accumulator wire: forces depth ~= iterations
    for i in range(200):
        k = kinds[i % len(kinds)]
        b2 = rng.randrange(width + 2)
        if k in (Op.ADDC, Op.SUBC, Op.MULC):
            prog.append(CombineOp.z64(Gate(k, dst=acc, src1=acc, const=rng.getrandbits(64))))
        else:
            prog.append(CombineOp.z64(Gate(k, dst=acc, src1=acc, src2=b2)))
        # plus parallel ops at the same level to widen the z64 waves
        for _ in range(3):
            k2 = kinds[rng.randrange(len(kinds))]
            a = rng.randrange(1, width + 2)
            c = rng.randrange(1, width + 2)
            d = rng.randrange(1, width)
            if k2 in (Op.ADDC, Op.SUBC, Op.MULC):
                prog.append(CombineOp.z64(Gate(k2, dst=d, src1=a, const=rng.getrandbits(64))))
            else:
                prog.append(CombineOp.z64(Gate(k2, dst=d, src1=a, src2=c)))
    # a satisfiable assert: x - x == 0
    prog.append(CombineOp.z64(Gate(Op.SUB, dst=width, src1=0, src2=0)))
    prog.append(CombineOp.z64(Gate(Op.ASSERT_ZERO, src1=width)))
    witz = [rng.getrandbits(64) for _ in range(width)]
    s = seeds256()
    sys_ = TpuKKW(prog)
    assert sys_.cc.depth > TpuKKW.SCAN_DEPTH_THRESHOLD
    from reverie_tpu.backend.tpu_scan import ScanExecutor as _SE

    assert isinstance(sys_._executor(0, 256), _SE)
    cpu_proof = cpu_prove(prog, [], witz, seeds=s.reshape(32, 8, 16))
    tpu_proof = sys_.prove([], witz, seeds=s)
    assert tpu_proof.to_bytes() == cpu_proof.to_bytes()
    assert sys_.verify(tpu_proof)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_scan_vs_unrolled_randomized(seed, monkeypatch):
    """Randomized differential sweep: force the scan executor onto small
    random mixed GF2+Z64+B2A circuits (threshold 0) and require byte-identity
    with the golden backend -- a structural fuzz of wave packing."""
    import random as _random

    monkeypatch.setattr(TpuKKW, "SCAN_DEPTH_THRESHOLD", 0)
    rng = _random.Random(seed)
    prog = []
    for w in range(64):
        prog.append(CombineOp.gf2(Gate(Op.INPUT, dst=w)))
    for w in range(3):
        prog.append(CombineOp.z64(Gate(Op.INPUT, dst=w)))
    g_kinds = [Op.ADD, Op.MUL, Op.ADDC, Op.MULC]
    z_kinds = [Op.ADD, Op.SUB, Op.MUL, Op.ADDC, Op.MULC]
    for _ in range(rng.randrange(30, 80)):
        r = rng.random()
        if r < 0.55:
            k = g_kinds[rng.randrange(len(g_kinds))]
            a, b2, d = (rng.randrange(64) for _ in range(3))
            if k in (Op.ADDC, Op.MULC):
                prog.append(CombineOp.gf2(Gate(k, dst=d, src1=a, const=rng.getrandbits(1))))
            else:
                prog.append(CombineOp.gf2(Gate(k, dst=d, src1=a, src2=b2)))
        elif r < 0.9:
            k = z_kinds[rng.randrange(len(z_kinds))]
            a, b2 = rng.randrange(3), rng.randrange(3)
            d = rng.randrange(3)
            if k in (Op.ADDC, Op.MULC):
                prog.append(CombineOp.z64(Gate(k, dst=d, src1=a, const=rng.getrandbits(64))))
            else:
                prog.append(CombineOp.z64(Gate(k, dst=d, src1=a, src2=b2)))
        else:
            prog.append(CombineOp.b2a(rng.randrange(3), 0))
    wit2 = [bool(rng.getrandbits(1)) for _ in range(64)]
    witz = [rng.getrandbits(64) for _ in range(3)]
    s = seeds256()
    from reverie_tpu.backend.tpu_scan import ScanExecutor

    sys_ = TpuKKW(prog)
    assert isinstance(sys_._executor(0, 256), ScanExecutor)
    cpu_proof = cpu_prove(prog, wit2, witz, seeds=s.reshape(32, 8, 16))
    tpu_proof = sys_.prove(wit2, witz, seeds=s)
    assert tpu_proof.to_bytes() == cpu_proof.to_bytes()
    assert sys_.verify(tpu_proof)


@pytest.mark.parametrize("name,mk", [
    ("empty", lambda: []),
    ("const_only", lambda: [CombineOp.gf2(Gate(Op.CONST, dst=0, const=1))]),
    ("zconst_only", lambda: [CombineOp.z64(Gate(Op.CONST, dst=0, const=7))]),
])
def test_degenerate_programs(name, mk):
    """Empty / constant-only programs produce valid (trivial) proofs that
    both verifiers accept, byte-identical across backends."""
    prog = mk()
    s = seeds256()
    cpu_proof = cpu_prove(prog, [], [], seeds=s.reshape(32, 8, 16))
    sys_ = TpuKKW(prog)
    proof = sys_.prove([], [], seeds=s)
    assert proof.to_bytes() == cpu_proof.to_bytes()
    assert sys_.verify(proof)
    assert cpu_verify(proof, prog)


def test_odd_m2_tape_split_roundtrip():
    """Regression (round-5): odd m2 with the split-plane tape crashed at
    trace time -- take_tape's mixed-parity window read one row past the odd
    plane on host-split tapes (ADVICE r4 high).  The host split now pads to
    an even slot count; proof bytes must still match the golden backend."""
    prog = [
        CombineOp.gf2(Gate(Op.INPUT, dst=0)),
        CombineOp.gf2(Gate(Op.INPUT, dst=1)),
        CombineOp.gf2(Gate(Op.INPUT, dst=2)),
        CombineOp.gf2(Gate(Op.ADD, dst=3, src1=0, src2=1)),
        CombineOp.gf2(Gate(Op.ADD, dst=4, src1=3, src2=2)),
        CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=4)),
    ]
    s = seeds256()
    sys_ = TpuKKW(prog)
    assert sys_.cc.m2 % 2 == 1 and sys_._use_tape_split
    proof = sys_.prove([True, True, False], [], seeds=s)
    gold = cpu_prove(prog, [True, True, False], [], seeds=s.reshape(32, 8, 16))
    assert proof.to_bytes() == gold.to_bytes()
    assert sys_.verify(proof)
    assert cpu_verify(proof, prog)


@pytest.mark.slow
def test_device_aes_tape_verify_roundtrip():
    """Slow-tier integration: a proof built from the device-AES tape path
    (m2 > 4096) must verify -- covers the device-tape -> verify integration
    on the CPU (the default-tier variant stops at prove)."""
    prog, wit2, witz = mul_bench_circuit(2500)
    sys_ = TpuKKW(prog)
    proof = sys_.prove(wit2, witz, seeds=seeds256())
    assert sys_.verify(proof)


def test_verify_many_matches_individual():
    """Pipelined verification returns the same verdicts as verify() --
    including malformed and tampered proofs mid-stream."""
    from reverie_tpu.proof.container import Proof

    prog, wit2, witz = mul_bench_circuit(30)
    rng = np.random.RandomState(17)
    seeds = rng.randint(0, 256, size=(3, 256, 16), dtype=np.uint8)
    sys_ = TpuKKW(prog)
    proofs = [sys_.prove(wit2, witz, seeds=s) for s in seeds]
    bad = bytearray(proofs[1].to_bytes())
    bad[40] ^= 0xFF  # corrupt the first online omit byte
    proofs[1] = Proof.from_bytes(bytes(bad))
    want = [sys_.verify(p) for p in proofs]
    assert want[0] and want[2] and not want[1]
    got = sys_.verify_many(proofs)
    assert got == want
