"""reverie_tpu -- a KKW MPC-in-the-head proof system on JAX accelerators.

A from-scratch JAX/XLA implementation of the NIZKPoK from KKW 2018
("Improved Non-Interactive Zero Knowledge with Applications to Post-Quantum
Signatures"), with the capabilities of trailofbits/reverie: prover + verifier
for circuits over GF(2) and Z_2^64 including mixed circuits with B2A
conversion gates, 8-player / 256-repetition / 40-online parameters at 128-bit
classical security, and byte-compatible proof and program formats.
"""

from .params import (
    BATCH_SIZE,
    DEFAULT_PARAMS,
    HASH_SIZE,
    KEY_SIZE,
    ONLINE_REPS,
    PACKED,
    PACKED_REPS,
    PLAYERS,
    PREPROCESSING_REPS,
    TOTAL_REPS,
    ProtocolParams,
)

__version__ = "0.1.0"


#: fraction of a device's usable memory (`memory_stats()["bytes_limit"]`,
#: which already reflects JAX's preallocation) that make_system plans a
#: proof's exact device footprint into; the rest is left to XLA's own
#: temporaries and to the next proof in a pipeline
DEVICE_BUDGET_FRACTION = 0.5
#: budget for backends that report no memory statistics (the host CPU)
HOST_BUDGET_BYTES = 12 * 1024**3


def default_budget_bytes(devices) -> int:
    """Device memory a proof may plan for across `devices`: each device's
    share is DEVICE_BUDGET_FRACTION of its `bytes_limit`; a device that
    reports no statistics gets HOST_BUDGET_BYTES."""
    total = 0
    for d in devices:
        stats = d.memory_stats() or {}
        limit = stats.get("bytes_limit")
        total += (int(DEVICE_BUDGET_FRACTION * limit) if limit
                  else HOST_BUDGET_BYTES)
    return total


def make_system(program, params=DEFAULT_PARAMS, mesh=None,
                hbm_budget_bytes=None, cache_key=None):
    """Build the right prover/verifier for a circuit's size: the in-memory
    `TpuKKW` when its device footprint fits the budget, the O(segment)
    streaming `StreamingKKW` otherwise (segment size chosen to fit).  Both
    produce identical proof bytes; this is the "any circuit size just works"
    entry point.

    hbm_budget_bytes: device memory to plan for; default
    `default_budget_bytes` over the mesh's devices (or the first device)."""
    if hbm_budget_bytes is None:
        import jax

        devices = (list(mesh.devices.flat) if mesh is not None
                   else jax.devices()[:1])
        hbm_budget_bytes = default_budget_bytes(devices)
    R = params.total_reps

    # cheap lower bound (bytes/op/rep) to skip the host compile pass for
    # circuits that are obviously beyond any budget.  Derived from the same
    # per-term accounting as device_footprint (NOT guesses): the cheapest op
    # of each kind contributes at least
    #   GF2  : one new arena value = mask+corr u8              ->  2 B/rep
    #   Z64  : one new arena value = (8-player u32-pair mask)
    #          + u32-pair corr     = 2*8*4 + 2*4               -> 72 B/rep
    #   B2A  : 64 gf2 randoms (tape row + value, 3 each) + 63 gf2 muls
    #          (tape 2 + arena 2 + streams 2x2 = 8 each) + ~190 gf2 adds
    #          (2 each) + z64 value 72 + 64 onl events x2      -> ~1400 B/rep
    #          (1200 keeps it a strict lower bound)
    from .circuit.ir import Kind

    _Z64_MIN = 2 * 8 * 4 + 2 * 4  # 72
    lower = 0
    for op in program:
        if op.kind == Kind.GF2:
            lower += 2 * R
        elif op.kind == Kind.Z64:
            lower += _Z64_MIN * R
        elif op.kind == Kind.B2A:
            lower += 1200 * R
    if lower > 4 * hbm_budget_bytes:
        from .backend.streaming import StreamingKKW

        frac = max(1, int(len(program) * (hbm_budget_bytes / 8) / lower))
        return StreamingKKW(program, frac, params=params, mesh=mesh)

    # exact footprint from the compiled circuit's actual array shapes; the
    # compile pass is shared with the TpuKKW that is usually returned
    from .backend.tpu_host import TpuKKW, device_footprint
    from .circuit.compile import compile_program

    cc = compile_program(program, cache_key=cache_key)
    total = device_footprint(cc, R)
    if total <= hbm_budget_bytes:
        return TpuKKW(program, params=params, mesh=mesh, cc=cc)
    from .backend.streaming import StreamingKKW

    # pick a segment size so one segment's footprint is ~1/8 of budget
    frac = max(1, int(len(program) * (hbm_budget_bytes / 8) / max(total, 1)))
    return StreamingKKW(program, frac, params=params, mesh=mesh)
