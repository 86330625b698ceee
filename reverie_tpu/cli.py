"""Command-line interface (reference src/main.rs:167-275).

Operations:
  prove       -- program + witness -> proof file
  verify      -- program + proof -> accept/reject
  oneshot     -- cleartext evaluation of the program on the witness
  oneshot-zk  -- prove then immediately verify in-process
  version_info

Program files are bincode-serialized instruction lists (same format the
reference consumes, main.rs:66); `--format bristol` accepts Bristol-fashion
text instead.  Witness files are ASCII '0'/'1' streams (witness.rs).
Proof files are bincode, byte-compatible with the reference.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _program_cache_key(data: bytes, fmt: str, bristol_output: str) -> bytes:
    """Levelizer disk-cache key: the raw program file bytes uniquely
    determine the compiled circuit (plus format/output-assertion args)."""
    import hashlib

    h = hashlib.sha256()
    h.update(fmt.encode())
    h.update(bristol_output.encode())
    h.update(data)
    return h.digest()


def _load_program(path: str, fmt: str, bristol_output: str = ""):
    from .circuit import bristol_to_program, load_program, parse_bristol

    with open(path, "rb") as f:
        data = f.read()
    _load_program.last_cache_key = _program_cache_key(data, fmt,
                                                      bristol_output)
    if fmt == "bristol":
        circ = parse_bristol(data.decode())
        if bristol_output:
            from .circuit.bristol import bristol_with_output_assertion

            txt = bristol_output.strip()
            if set(txt) - {"0", "1"}:
                raise SystemExit(
                    f"--bristol-output must be '0'/'1' bits, got {txt!r}"
                )
            bits = [c == "1" for c in txt]
            if len(bits) != circ.n_output_bits:
                raise SystemExit(
                    f"--bristol-output has {len(bits)} bits, circuit outputs "
                    f"{circ.n_output_bits}"
                )
            return bristol_with_output_assertion(circ, bits)
        return bristol_to_program(circ)
    return load_program(data)


def _load_witness(path: str):
    from .circuit import parse_witness_file

    return parse_witness_file(path)


def _backend_system(program, backend: str, segment_ops: int = 0,
                    cache_key=None):
    """The jitted prover/verifier for `backend`.  `--backend cpu` with
    `--segment-ops` keeps the streamed JAX work on the host CPU; jax is
    pinned there before any device is touched."""
    import jax

    from .utils.compile_cache import enable_compile_cache

    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    if segment_ops:
        from .backend.streaming import StreamingKKW

        return StreamingKKW(program, segment_ops)
    if backend == "tpu":
        # auto-selects streaming segmentation when the circuit's device
        # footprint exceeds the device memory budget (make_system)
        from . import make_system

        return make_system(program, cache_key=cache_key)
    return None  # cpu golden backend uses module functions


def cmd_prove(args) -> int:
    from .circuit import largest_wires
    from .proof import prove

    program = _load_program(args.program_path, args.format, args.bristol_output)
    witness = _load_witness(args.witness_path)
    print("Evaluating program in ~zero knowledge~")
    t0 = time.time()
    if args.backend == "tpu" or args.segment_ops:
        sys_ = _backend_system(program, args.backend, args.segment_ops,
                               cache_key=_load_program.last_cache_key)
        proof = sys_.prove(witness, [])
    else:
        proof = prove(program, witness, [], largest_wires(program))
    blob = proof.to_bytes()
    with open(args.proof_path, "wb") as f:
        f.write(blob)
    print(f"proof written: {len(blob)} bytes in {time.time() - t0:.2f}s")
    return 0


def cmd_verify(args) -> int:
    from .circuit import largest_wires
    from .proof import Proof, verify

    program = _load_program(args.program_path, args.format, args.bristol_output)
    with open(args.proof_path, "rb") as f:
        proof = Proof.from_bytes(f.read())
    print("Verifying Proof")
    t0 = time.time()
    if args.backend == "tpu" or args.segment_ops:
        ok = _backend_system(
            program, args.backend, args.segment_ops,
            cache_key=_load_program.last_cache_key).verify(proof)
    else:
        ok = verify(proof, program, largest_wires(program))
    print(f"verified in {time.time() - t0:.2f}s")
    if not ok:
        print("Unverifiable Proof", file=sys.stderr)
        return 1
    print("Ok(())")
    return 0


def cmd_oneshot(args) -> int:
    from .circuit import evaluate_composite_program

    program = _load_program(args.program_path, args.format, args.bristol_output)
    witness = _load_witness(args.witness_path)
    print("Evaluating program in cleartext")
    evaluate_composite_program(program, witness, [])
    print("Ok(())")
    return 0


def cmd_oneshot_zk(args) -> int:
    from .circuit import largest_wires
    from .proof import prove, verify

    program = _load_program(args.program_path, args.format, args.bristol_output)
    witness = _load_witness(args.witness_path)
    print("Evaluating program in ~zero knowledge~")
    if args.backend == "tpu" or args.segment_ops:
        sys_ = _backend_system(program, args.backend, args.segment_ops,
                               cache_key=_load_program.last_cache_key)
        proof = sys_.prove(witness, [])
        ok = sys_.verify(proof)
    else:
        wc = largest_wires(program)
        proof = prove(program, witness, [], wc)
        ok = verify(proof, program, wc)
    if not ok:
        print("Unverifiable Proof", file=sys.stderr)
        return 1
    print("Ok(())")
    return 0


def cmd_version(args) -> int:
    """Version + build metadata (main.rs:277-286: `built` crate embeds the
    git SHA and dirty flag at build time; here they are resolved at run time
    from the enclosing git checkout when one exists)."""
    from . import __version__
    from .utils.buildinfo import git_commit_info

    print(f"reverie_tpu_version: {__version__}")
    sha, dirty = git_commit_info()
    if sha is not None:
        print(f"reverie_tpu_commit_sha: {sha}")
        print(f"reverie_tpu_uncommitted_changes: {'TRUE' if dirty else 'FALSE'}")
    return 0


def app() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="reverie-tpu", description="Gotta go fast")
    p.add_argument(
        "--operation",
        required=True,
        choices=["prove", "verify", "oneshot", "oneshot-zk", "version_info"],
    )
    p.add_argument("--program-path")
    p.add_argument("--witness-path")
    p.add_argument("--proof-path")
    p.add_argument("--format", default="bincode", choices=["bincode", "bristol"])
    p.add_argument(
        "--bristol-output", default="",
        help="expected output bits (e.g. '01') for --format bristol: the"
             " circuit outputs are asserted equal to this public value",
    )
    p.add_argument("--backend", default="tpu", choices=["tpu", "cpu"])
    p.add_argument(
        "--segment-ops", type=int, default=0, metavar="N",
        help="stream the proof in segments of N ops (O(segment) device "
             "memory for beyond-HBM circuits, all op kinds; deep segments "
             "use the scan executor; proof bytes identical to unsegmented "
             "proving)",
    )
    return p


def main(argv=None) -> int:
    args = app().parse_args(argv)
    op = args.operation
    need = {
        "prove": ["program_path", "witness_path", "proof_path"],
        "verify": ["program_path", "proof_path"],
        "oneshot": ["program_path", "witness_path"],
        "oneshot-zk": ["program_path", "witness_path"],
        "version_info": [],
    }[op]
    for field in need:
        if getattr(args, field) is None:
            print(f"--{field.replace('_', '-')} is required for {op}", file=sys.stderr)
            return 2
    return {
        "prove": cmd_prove,
        "verify": cmd_verify,
        "oneshot": cmd_oneshot,
        "oneshot-zk": cmd_oneshot_zk,
        "version_info": cmd_version,
    }[op](args)


if __name__ == "__main__":
    sys.exit(main())
