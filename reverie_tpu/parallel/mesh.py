"""Multi-chip sharding of KKW execution over a device mesh.

The repetition axis is embarrassingly parallel (the reference's only
parallelism is rayon threads over packed groups, proof/mod.rs:127-128); here
it is sharded over the mesh with `jax.sharding` -- each device executes its
slice of repetitions, and only the per-rep commitment hashes (32 B/rep) ever
cross the interconnect.  Batch-of-proofs workloads additionally shard the
proof axis across hosts (see bench configs in BASELINE.json).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REP_AXIS = "rep"


def make_mesh(n_devices: Optional[int] = None, axis: str = REP_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


# Which positional axis of each executor input/output is the repetition axis.
_REP_AXIS_OF = {
    "tape2": 1,
    # split-plane gf2 tape (even/odd slot planes, backend/tpu.take_tape)
    "tape2_e": 1,
    "tape2_o": 1,
    # z64 tapes/recons are player-major (rows, 8, R): rep axis = 2
    "tapez_lo": 2,
    "tapez_hi": 2,
    # witnesses are laid out (n_wit, R): broadcast columns in single prove,
    # per-proof-lane columns in prove_batch -- shard the lane axis either way
    "wit2": 1,
    "witz_lo": 1,
    "witz_hi": 1,
    "in2": 1,
    "co2": 1,
    "re2": 1,
    "inz_lo": 1,
    "inz_hi": 1,
    "coz_lo": 1,
    "coz_hi": 1,
    "rez_lo": 2,
    "rez_hi": 2,
    # outputs
    "onl2": 1,
    "pre2": 1,
    "onlz": 1,
    "prez": 1,
    "fail": 0,
}


def _spec(name: str, ndim: int, axis: str) -> P:
    rep_dim = _REP_AXIS_OF.get(name)
    if rep_dim is None or rep_dim >= ndim:
        return P()
    parts = [None] * ndim
    parts[rep_dim] = axis
    return P(*parts)


def input_shardings(mesh: Mesh, inputs: Dict[str, np.ndarray], axis: str = REP_AXIS):
    return {
        k: NamedSharding(mesh, _spec(k, np.ndim(v), axis)) for k, v in inputs.items()
    }


def output_shardings(mesh: Mesh, names, ndims: Dict[str, int], axis: str = REP_AXIS):
    return {k: NamedSharding(mesh, _spec(k, ndims[k], axis)) for k in names}


def shard_inputs(mesh: Mesh, inputs: Dict[str, np.ndarray], axis: str = REP_AXIS):
    """Device-put inputs with the repetition axis sharded over the mesh."""
    sh = input_shardings(mesh, inputs, axis)
    return {k: jax.device_put(v, sh[k]) for k, v in inputs.items()}
