"""Synthetic circuit builders for tests and benchmarks."""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from .ir import CombineOp, Gate, Kind, Op


def mul_bench_circuit(n_mul: int = 100_000) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """The reference prover-bench circuit: 2 inputs + n GF2 Mul gates all on
    the same wires (reference src/proof/mod.rs:322-335)."""
    prog = [
        CombineOp.gf2(Gate(Op.INPUT, dst=0)),
        CombineOp.gf2(Gate(Op.INPUT, dst=1)),
    ]
    prog.extend(CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(n_mul))
    return prog, [True, True], [0]


def wide_and_circuit(
    n_and: int, width: int = 1024, seed: int = 0
) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """A synthetic Z2 circuit with `n_and` AND gates over `width` live wires.

    Structured like realistic circuits: each AND reads two pseudo-random live
    wires and overwrites a pseudo-random destination, interleaved with XORs.
    """
    rng = random.Random(seed)
    prog: List[CombineOp] = [CombineOp.size_hint(1, width)]
    wit = [bool(rng.getrandbits(1)) for _ in range(width)]
    for w in range(width):
        prog.append(CombineOp.gf2(Gate(Op.INPUT, dst=w)))
    for _ in range(n_and):
        a = rng.randrange(width)
        b = rng.randrange(width)
        d = rng.randrange(width)
        prog.append(CombineOp.gf2(Gate(Op.MUL, dst=d, src1=a, src2=b)))
    return prog, wit, [0]


def z64_mul_bench_circuit(n_mul: int = 10_000) -> Tuple[List[CombineOp], List[bool], List[int]]:
    """Arithmetic ring bench: n Z64 mul gates."""
    prog = [
        CombineOp.z64(Gate(Op.INPUT, dst=0)),
        CombineOp.z64(Gate(Op.INPUT, dst=1)),
    ]
    prog.extend(CombineOp.z64(Gate(Op.MUL, dst=2, src1=0, src2=1)) for _ in range(n_mul))
    return prog, [], [3, 5]


def mixed_b2a_circuit() -> Tuple[List[CombineOp], List[bool], List[int]]:
    """The reference round-trip test circuit (proof/mod.rs:397-427)."""
    prog: List[CombineOp] = []
    for _ in range(2, 66):
        prog.append(CombineOp.gf2(Gate(Op.INPUT, dst=1)))
    prog.append(CombineOp.b2a(0, 2))
    prog.extend(
        [
            CombineOp.gf2(Gate(Op.INPUT, dst=0)),
            CombineOp.gf2(Gate(Op.INPUT, dst=1)),
            CombineOp.gf2(Gate(Op.MUL, dst=2, src1=0, src2=1)),
            CombineOp.gf2(Gate(Op.ADD, dst=3, src1=0, src2=1)),
            CombineOp.gf2(Gate(Op.MUL, dst=2, src1=2, src2=3)),
        ]
    )
    return prog, [True] * 128, [0]


def random_mixed_circuit(seed: int, n_gates: int = 60):
    """A random well-formed combine program over every gate kind in both
    domains plus B2A bridges, with a satisfying witness: every src wire is
    already written in its domain; ASSERT_ZERO targets are made satisfiable
    by asserting (x - x) style constructions."""
    rng = np.random.RandomState(seed)
    ops = []
    g2 = []  # gf2 wires written
    gz = []  # z64 wires written
    wit2 = []
    witz = []
    n2 = nz = 0

    def w2():
        return int(g2[rng.randint(len(g2))])

    def wz():
        return int(gz[rng.randint(len(gz))])

    # seed each domain with an input + a const + a random
    for _ in range(2):
        ops.append(CombineOp.gf2(Gate(Op.INPUT, dst=n2)))
        wit2.append(bool(rng.randint(2)))
        g2.append(n2)
        n2 += 1
        ops.append(CombineOp.z64(Gate(Op.INPUT, dst=nz)))
        witz.append(int(rng.randint(0, 2**63)))
        gz.append(nz)
        nz += 1
    ops.append(CombineOp.gf2(Gate(Op.CONST, dst=n2, const=1)))
    g2.append(n2)
    n2 += 1
    ops.append(CombineOp.z64(Gate(Op.CONST, dst=nz,
                                  const=int(rng.randint(0, 2**62)))))
    gz.append(nz)
    nz += 1
    ops.append(CombineOp.gf2(Gate(Op.RANDOM, dst=n2)))
    g2.append(n2)
    n2 += 1
    ops.append(CombineOp.z64(Gate(Op.RANDOM, dst=nz)))
    gz.append(nz)
    nz += 1

    kinds = [Op.ADD, Op.ADDC, Op.SUB, Op.SUBC, Op.MUL, Op.MULC, Op.CONST,
             Op.INPUT, Op.RANDOM, "B2A", "ASSERT2", "ASSERTZ"]
    for _ in range(n_gates):
        k = kinds[rng.randint(len(kinds))]
        dom = rng.randint(2)  # 0 = gf2, 1 = z64
        if k == "B2A":
            ops.append(CombineOp.b2a(nz, w2()))
            gz.append(nz)
            nz += 1
            continue
        if k == "ASSERT2":
            # (x ^ x) == 0 -- always satisfiable
            x = w2()
            ops.append(CombineOp.gf2(Gate(Op.ADD, dst=n2, src1=x, src2=x)))
            ops.append(CombineOp.gf2(Gate(Op.ASSERT_ZERO, src1=n2)))
            g2.append(n2)
            n2 += 1
            continue
        if k == "ASSERTZ":
            x = wz()
            ops.append(CombineOp.z64(Gate(Op.SUB, dst=nz, src1=x, src2=x)))
            ops.append(CombineOp.z64(Gate(Op.ASSERT_ZERO, src1=nz)))
            gz.append(nz)
            nz += 1
            continue
        if dom == 0:
            c = int(rng.randint(2))
            if k == Op.INPUT:
                wit2.append(bool(rng.randint(2)))
                ops.append(CombineOp.gf2(Gate(Op.INPUT, dst=n2)))
            elif k in (Op.CONST, Op.RANDOM):
                ops.append(CombineOp.gf2(Gate(k, dst=n2, const=c)))
            elif k in (Op.ADDC, Op.SUBC, Op.MULC):
                ops.append(CombineOp.gf2(Gate(k, dst=n2, src1=w2(), const=c)))
            else:
                ops.append(CombineOp.gf2(
                    Gate(k, dst=n2, src1=w2(), src2=w2())))
            g2.append(n2)
            n2 += 1
        else:
            c = int(rng.randint(0, 2**63))
            if k == Op.INPUT:
                witz.append(int(rng.randint(0, 2**63)))
                ops.append(CombineOp.z64(Gate(Op.INPUT, dst=nz)))
            elif k in (Op.CONST, Op.RANDOM):
                ops.append(CombineOp.z64(Gate(k, dst=nz, const=c)))
            elif k in (Op.ADDC, Op.SUBC, Op.MULC):
                ops.append(CombineOp.z64(Gate(k, dst=nz, src1=wz(), const=c)))
            else:
                ops.append(CombineOp.z64(
                    Gate(k, dst=nz, src1=wz(), src2=wz())))
            gz.append(nz)
            nz += 1
    return ops, wit2, witz
