"""Streaming segmented prover (backend/streaming.py): proofs must be
byte-identical to the unsegmented device prover and accepted by the reference-
compatible verifiers, for every segmentation granularity (SURVEY §7
hard-part 5)."""

import numpy as np
import pytest

from reverie_tpu.backend.streaming import StreamingKKW
from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit import CombineOp, Gate, Op
from reverie_tpu.circuit.builders import (
    mixed_b2a_circuit,
    mul_bench_circuit,
    wide_and_circuit,
    z64_mul_bench_circuit,
)
from reverie_tpu.circuit.compile import compile_segments
from reverie_tpu.proof import verify as cpu_verify


def seeds256():
    rng = np.random.RandomState(42)
    return rng.randint(0, 256, size=(256, 16), dtype=np.uint8)


def deep_chain_circuit(n: int):
    """Serial MUL chain: every gate depends on the previous one, so every
    segment boundary carries exactly one live wire (worst-case latency,
    best-case carry width)."""
    prog = [
        CombineOp.gf2(Gate(Op.INPUT, dst=0)),
        CombineOp.gf2(Gate(Op.INPUT, dst=1)),
    ]
    for _ in range(n):
        prog.append(CombineOp.gf2(Gate(Op.MUL, dst=1, src1=0, src2=1)))
    prog.append(CombineOp.gf2(Gate(Op.ADD, dst=2, src1=1, src2=1)))
    prog.append(CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=2)))
    return prog, [True, True], []


CASES = {
    "mul60": lambda: mul_bench_circuit(60),
    "wide_and": lambda: wide_and_circuit(80, width=32, seed=7),
    "deep_chain": lambda: deep_chain_circuit(70),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seg_ops", [
    # tiny segments multiply per-segment executor compiles; one fine-grained
    # case stays default (mul60), the rest run in the slow tier
    pytest.param(7, marks=pytest.mark.slow),
    23,
    pytest.param(10_000, marks=pytest.mark.slow),
])
def test_streamed_proof_matches_unsegmented(name, seg_ops):
    prog, wit2, witz = CASES[name]()
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    streamed = StreamingKKW(prog, seg_ops).prove(wit2, witz, seeds=s)
    assert streamed.to_bytes() == base.to_bytes()


def test_streamed_proof_verifies():
    prog, wit2, witz = CASES["wide_and"]()
    s = seeds256()
    proof = StreamingKKW(prog, 17).prove(wit2, witz, seeds=s)
    assert cpu_verify(proof, prog)
    assert TpuKKW(prog).verify(proof)


def test_segment_stream_bases_are_consistent():
    prog, _, _ = CASES["wide_and"]()
    segs = compile_segments(prog, 13)
    whole = TpuKKW(prog).cc
    assert sum(s.cc.m2 for s in segs) == whole.m2
    assert sum(s.cc.onl2 for s in segs) == whole.onl2
    assert sum(s.cc.pre2 for s in segs) == whole.pre2
    assert sum(s.cc.n_recons2 for s in segs) == whole.n_recons2
    # global record slot offsets: segment-local slots + byte base must equal
    # the unsegmented slot assignment
    rec = np.concatenate([s.cc.recon_slots2 + s.onl0 for s in segs])
    assert (rec == whole.recon_slots2).all()
    cor = np.concatenate([s.cc.corr_slots2 + s.pre0 for s in segs])
    assert (cor == whole.corr_slots2).all()


@pytest.mark.parametrize("seg_ops", [
    pytest.param(9, marks=pytest.mark.slow),  # 15+ segments: compile-heavy
    29,
    10_000,
])
def test_streamed_verify_accepts(seg_ops):
    prog, wit2, witz = CASES["wide_and"]()
    s = seeds256()
    sk = StreamingKKW(prog, seg_ops)
    proof = sk.prove(wit2, witz, seeds=s)
    assert sk.verify(proof)
    # the streamed verifier also accepts unsegmented proofs (same bytes)
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    assert sk.verify(base)


def test_streamed_verify_rejects_tampered():
    prog, wit2, witz = CASES["mul60"]()
    s = seeds256()
    sk = StreamingKKW(prog, 13)
    proof = sk.prove(wit2, witz, seeds=s)
    from reverie_tpu.proof.container import Proof

    raw = bytearray(proof.to_bytes())
    raw[len(raw) // 2] ^= 0x40
    assert not sk.verify(Proof.from_bytes(bytes(raw)))
    # flipped commitment byte
    raw2 = bytearray(proof.to_bytes())
    raw2[10] ^= 1
    assert not sk.verify(Proof.from_bytes(bytes(raw2)))


def test_streamed_verify_matches_unsegmented_verifier():
    """Accept/reject decisions agree with TpuKKW.verify case by case."""
    prog, wit2, witz = CASES["deep_chain"]()
    s = seeds256()
    sk = StreamingKKW(prog, 11)
    base = TpuKKW(prog)
    proof = sk.prove(wit2, witz, seeds=s)
    assert base.verify(proof) and sk.verify(proof)
    from reverie_tpu.proof.container import Proof

    raw = bytearray(proof.to_bytes())
    raw[-3] ^= 0x80
    bad = Proof.from_bytes(bytes(raw))
    assert base.verify(bad) == sk.verify(bad) == False  # noqa: E712


Z64_CASES = {
    "z64_mul": lambda: z64_mul_bench_circuit(24),
    "b2a": lambda: mixed_b2a_circuit(),
}


@pytest.mark.parametrize("name", list(Z64_CASES))
@pytest.mark.parametrize("seg_ops", [
    pytest.param(5, marks=pytest.mark.slow),  # many segments: compile-heavy
    31,
    pytest.param(10_000, marks=pytest.mark.slow),
])
def test_streamed_z64_proof_matches_unsegmented(name, seg_ops):
    """z64/B2A segments: carried u64-pair arena rows + windowed z64 tapes +
    byte-aligned z64 stream stitching must reproduce the unsegmented proof
    bytes exactly (B2A ops are atomic within a segment)."""
    prog, wit2, witz = Z64_CASES[name]()
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    streamed = StreamingKKW(prog, seg_ops).prove(wit2, witz, seeds=s)
    assert streamed.to_bytes() == base.to_bytes()


def test_streamed_z64_verify():
    prog, wit2, witz = Z64_CASES["b2a"]()
    s = seeds256()
    sk = StreamingKKW(prog, 7)
    proof = sk.prove(wit2, witz, seeds=s)
    assert cpu_verify(proof, prog)
    assert TpuKKW(prog).verify(proof)
    assert sk.verify(proof)
    raw = bytearray(proof.to_bytes())
    raw[len(raw) // 3] ^= 0x20
    from reverie_tpu.proof.container import Proof

    assert not sk.verify(Proof.from_bytes(bytes(raw)))


def test_mesh_sharded_streamed_prove_matches():
    """StreamingKKW under an 8-device mesh (rep axis sharded per segment)
    produces byte-identical proofs and its verifier accepts them: multi-chip
    streaming of beyond-HBM circuits composes with segmentation."""
    from reverie_tpu.parallel import make_mesh

    prog, wit2, witz = mixed_b2a_circuit()
    s = seeds256()
    base = StreamingKKW(prog, 24).prove(wit2, witz, seeds=s)
    sk = StreamingKKW(prog, 24, mesh=make_mesh(8))
    proof = sk.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == base.to_bytes()
    assert sk.verify(proof)


def test_streamed_deep_segments_use_scan_executor():
    """Beyond-HBM DEEP circuits: segments whose depth exceeds the scan
    threshold run the carry-capable lax.scan executor (one shared compile
    across uniform segments) and stay byte-identical to unsegmented
    proving."""
    from reverie_tpu.backend.tpu_scan import ScanExecutor

    prog, wit2, witz = deep_chain_circuit(420)
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    sk = StreamingKKW(prog, 140)
    assert len(sk.segments) >= 3
    proof = sk.prove(wit2, witz, seeds=s)
    assert isinstance(sk._executor(1, 0, 256), ScanExecutor)
    assert sk.segments[1].cc.depth > StreamingKKW.SCAN_DEPTH_THRESHOLD
    assert proof.to_bytes() == base.to_bytes()
    assert sk.verify(proof)


@pytest.mark.slow
def test_streamed_deep_z64_segments():
    """Deep z64 chain streamed through scan-mode segments with z64 carry
    rows crossing every boundary."""
    prog = [
        CombineOp.z64(Gate(Op.INPUT, dst=0)),
        CombineOp.z64(Gate(Op.INPUT, dst=1)),
    ]
    for _ in range(330):
        prog.append(CombineOp.z64(Gate(Op.MUL, dst=1, src1=0, src2=1)))
    wit2, witz = [], [3, 5]
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    sk = StreamingKKW(prog, 140)
    assert sk.segments[0].cc.depth > StreamingKKW.SCAN_DEPTH_THRESHOLD
    proof = sk.prove(wit2, witz, seeds=s)
    assert proof.to_bytes() == base.to_bytes()
    assert sk.verify(proof)


@pytest.mark.slow
def test_streamed_multiblock_sha256():
    """Flagship deep+wide workload: 2-block SHA-256 preimage (45k ANDs,
    ~10.4k levels) proved through streamed scan-mode segments, byte-identical
    to the unsegmented prover, and verified streamed."""
    import hashlib

    from reverie_tpu.circuit.sha256 import (
        block_to_witness_bits,
        sha256_long_preimage_statement,
        sha256_pad_message,
    )

    msg = bytes(range(77))
    padded = sha256_pad_message(msg)
    prog, _ = sha256_long_preimage_statement(hashlib.sha256(msg).digest(), 2)
    wit = []
    for i in range(0, len(padded), 64):
        wit.extend(block_to_witness_bits(padded[i : i + 64]))
    s = seeds256()
    base = TpuKKW(prog).prove(wit, [], seeds=s)
    sk = StreamingKKW(prog, 40_000)
    assert len(sk.segments) >= 2
    proof = sk.prove(wit, [], seeds=s)
    assert proof.to_bytes() == base.to_bytes()
    assert sk.verify(proof)


def test_streamed_verify_rejects_malformed():
    """StreamingKKW.verify must cleanly reject (not crash on) tampered and
    truncated proofs, like the unsegmented verifiers."""
    from reverie_tpu.proof import Proof

    prog, wit2, witz = CASES["mul60"]()
    s = seeds256()
    sk = StreamingKKW(prog, 13)
    proof = sk.prove(wit2, witz, seeds=s)
    raw = bytearray(proof.to_bytes())
    raw[7] ^= 1
    assert not sk.verify(Proof.from_bytes(bytes(raw)))
    bad = Proof.from_bytes(proof.to_bytes())
    bad.gf2.online[0].omit = 9
    assert not sk.verify(bad)


@pytest.mark.slow
def test_streamed_deep_mesh_composition():
    """Everything composes: deep circuit, streamed segments, scan executors,
    8-device mesh sharding -- proof bytes unchanged."""
    from reverie_tpu.backend.tpu_scan import ScanExecutor
    from reverie_tpu.parallel import make_mesh

    prog, wit2, witz = deep_chain_circuit(300)
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    sk = StreamingKKW(prog, 150, mesh=make_mesh(8))
    proof = sk.prove(wit2, witz, seeds=s)
    assert isinstance(sk._executor(0, 0, 256), ScanExecutor)
    assert proof.to_bytes() == base.to_bytes()
    assert sk.verify(proof)


@pytest.mark.parametrize("name,mk,seg_ops", [
    # every segment window >= 4096 gf2 / 512 z64 tape slots: the device AES
    # route (tpu_host.device_tape_eligible), one compile per window shape
    ("gf2", lambda: mul_bench_circuit(4200), 2101),
    ("z64", lambda: z64_mul_bench_circuit(600), 301),
])
def test_streamed_device_tape_matches_unsegmented(name, mk, seg_ops):
    """Segments build their tape windows with the device AES (CTR start
    block per window) and prove byte-identically to unsegmented proving."""
    prog, wit2, witz = mk()
    s = seeds256()
    base = TpuKKW(prog).prove(wit2, witz, seeds=s)
    sk = StreamingKKW(prog, seg_ops)
    assert len(sk.segments) == 2
    proof = sk.prove(wit2, witz, seeds=s)
    assert ("aes" if name == "gf2" else "aesz") in sk._bitx
    assert proof.to_bytes() == base.to_bytes()
