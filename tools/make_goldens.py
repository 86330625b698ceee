"""Regenerate the committed golden vectors in tests/golden/ with the NumPy
golden backend: the reference's mixed B2A round-trip program, its
repetition seeds and the proof they produce (tests/test_golden.py).

    python tools/make_goldens.py [out_dir]      # default: tests/golden

Existing seeds in out_dir are reused, so an unchanged protocol rewrites
byte-identical files; run it only after a deliberate format change.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from reverie_tpu.circuit import dumps_program  # noqa: E402
from reverie_tpu.circuit.builders import mixed_b2a_circuit  # noqa: E402
from reverie_tpu.proof import prove  # noqa: E402


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    seeds_path = os.path.join(out_dir, "b2a_seeds.bin")
    if os.path.exists(seeds_path):
        with open(seeds_path, "rb") as f:
            seeds = np.frombuffer(f.read(), dtype=np.uint8).reshape(32, 8, 16)
    else:
        seeds = np.random.RandomState(42).randint(0, 256, size=(32, 8, 16),
                                                  dtype=np.uint8)
    prog, wit2, witz = mixed_b2a_circuit()
    files = {
        "b2a_program.bin": dumps_program(prog),
        "b2a_seeds.bin": seeds.tobytes(),
        "b2a_proof.bin": prove(prog, wit2, witz, seeds=seeds).to_bytes(),
    }
    for name, blob in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(blob)
    print("wrote", ", ".join(files), "to", out_dir)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "tests", "golden"))
