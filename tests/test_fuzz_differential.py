"""Random-op-mix differential fuzz: arbitrary valid programs over every
gate kind in both domains (plus B2A bridges) must prove byte-identically
on the device backend vs the CPU golden backend, and verify.

The structured differential tests cover each op family in isolation;
this covers arbitrary interleavings (wire reuse across domains, consts
feeding muls, asserts mid-stream, random gates as mul operands, ...).
Reference semantics: interpreter/single.rs + combine.rs."""

import numpy as np
import pytest

from reverie_tpu.backend.tpu_host import TpuKKW
from reverie_tpu.circuit.builders import random_mixed_circuit
from reverie_tpu.circuit.eval import evaluate_composite_program
from reverie_tpu.proof import prove as cpu_prove


def _roundtrip(seed, n_gates=60):
    prog, wit2, witz = random_mixed_circuit(seed, n_gates)
    # sanity: cleartext evaluation must not raise (witness satisfies asserts)
    evaluate_composite_program(prog, wit2, witz)
    seeds = np.random.RandomState(seed + 1).randint(
        0, 256, size=(32, 8, 16), dtype=np.uint8)
    golden = cpu_prove(prog, wit2, witz, seeds=seeds)
    sys_ = TpuKKW(prog)
    proof = sys_.prove(wit2, witz, seeds=seeds.reshape(256, 16))
    assert proof.to_bytes() == golden.to_bytes(), f"seed {seed}"
    assert sys_.verify(proof), f"seed {seed}"


@pytest.mark.parametrize("seed", [11, 23])
def test_random_mixed_program_roundtrip(seed):
    _roundtrip(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(40, 52)))
def test_random_mixed_program_roundtrip_sweep(seed):
    _roundtrip(seed, n_gates=90)
