"""The device routes of the tape and hash layers, the ones the GPU runs,
against the host goldens: the bitsliced AES-CTR tapes (crypto/kernels/
aes_jax.py) vs the native host AES builder (tpu_host.build_tapes), and the
BLAKE3 bulk chunk CVs (crypto/kernels/blake3_jax.py) vs the independent
pure-Python BLAKE3.  Reference: crypto/prg.rs:13-38, crypto/hash.rs:28-104.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reverie_tpu.backend.tpu_host import TpuKKW, build_tapes
from reverie_tpu.crypto import expand_seeds
from reverie_tpu.crypto.kernels import aes_jax as aj


def _keys(R: int) -> np.ndarray:
    rng = np.random.RandomState(7)
    seeds = rng.randint(0, 256, size=(R, 16), dtype=np.uint8)
    return expand_seeds(seeds).reshape(R, 8, 16)


_gf2_tape = jax.jit(
    lambda keys, nb, start, mask: aj.aes_ctr_tape_gf2(
        aj.round_key_planes_device(keys), aj.counter_planes_device(nb, start),
        mask),
    static_argnums=(1,))


def _device_gf2(pk, n_blocks, start=0, mask=None):
    R = pk.shape[0]
    if mask is None:
        mask = np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32)
    return np.asarray(_gf2_tape(jnp.asarray(pk.reshape(-1, 16)), n_blocks,
                                np.int32(start), jnp.asarray(mask)))


@pytest.mark.parametrize("R", [40, 216, 256, 2048])
def test_gf2_tape_matches_host_golden(R):
    """The verifier's online (40) and preprocessing (216) rep counts, the
    prover's 256, and a batch lane count (8 proofs)."""
    pk = _keys(R)
    n_blocks = 4
    golden, _, _ = build_tapes(pk, None, n_blocks * 128, 0)
    np.testing.assert_array_equal(_device_gf2(pk, n_blocks), golden)


def test_gf2_split_planes_match_host_golden():
    """TpuKKW._gf2_tape(split=True) on the device route emits the even/odd
    slot planes (slot s -> plane s & 1, row s >> 1) of the interleaved
    tape."""
    from reverie_tpu.circuit.builders import mul_bench_circuit

    prog, _, _ = mul_bench_circuit(2100)  # m2 = 4202: device route
    sys_ = TpuKKW(prog)
    m2 = sys_.cc.m2
    pk = _keys(32)
    golden, _, _ = build_tapes(pk, None, m2, 0)
    e, o = sys_._gf2_tape(pk, None, split=True)
    np.testing.assert_array_equal(np.asarray(e)[: (m2 + 1) // 2],
                                  golden[0::2])
    np.testing.assert_array_equal(np.asarray(o)[: m2 // 2], golden[1::2])


@pytest.mark.parametrize("b0,nb", [(16, 16), (24, 24)])
def test_gf2_tape_start_block_windows(b0, nb):
    """counter_planes_device(nb, start) windows the CTR: rows [0, nb*128)
    at start block b0 equal the whole tape's rows from b0*128 on (the
    streaming segment windows, backend/streaming.py)."""
    pk = _keys(32)
    golden, _, _ = build_tapes(pk, None, 48 * 128, 0)
    np.testing.assert_array_equal(_device_gf2(pk, nb, start=b0),
                                  golden[b0 * 128 : (b0 + nb) * 128])


def test_gf2_tape_lane_mask_omits_players():
    R = 32
    pk = _keys(R)
    omit = np.arange(R) % 9  # player 0..7 plus "none" (8)
    golden, _, _ = build_tapes(pk, omit, 4 * 128, 0)
    got = _device_gf2(pk, 4, mask=aj.lane_mask_from_omit(omit, R))
    np.testing.assert_array_equal(got, golden)


def test_z64_chunked_tape_matches_unchunked():
    """aes_ctr_tape_z64_chunked (lax.scan over block chunks) must be
    bit-identical to the unchunked form and the host golden."""
    R = 32
    pk = _keys(R)
    # player-major key order: the z64 tape contract (aes_ctr_tape_z64)
    rkp = jnp.asarray(aj.round_key_planes(
        np.ascontiguousarray(pk.transpose(1, 0, 2)).reshape(-1, 16)))
    mask = jnp.asarray(np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32))
    mz = 600  # -> B = 320 blocks; chunk_b=64 exercises padding + multi-chunk
    nbytes = ((mz + 127) // 128) * 1024
    B = nbytes // 16
    ctrp = jnp.asarray(aj.counter_planes(B))
    lo_u, hi_u = aj.aes_ctr_tape_z64(rkp, ctrp, mask)
    lo_c, hi_c = aj.aes_ctr_tape_z64_chunked(rkp, ctrp, mask, chunk_b=64)
    np.testing.assert_array_equal(np.asarray(lo_c), np.asarray(lo_u))
    np.testing.assert_array_equal(np.asarray(hi_c), np.asarray(hi_u))
    _, glo, ghi = build_tapes(pk, None, 0, mz)
    np.testing.assert_array_equal(np.asarray(lo_c)[:mz], glo)
    np.testing.assert_array_equal(np.asarray(hi_c)[:mz], ghi)


@pytest.mark.parametrize(
    "n,R,base",
    [
        (8, 128, 0),
        (5, 128, 3),
        (9, 256, 123456),   # large global counter base (streaming absorb)
        (3, 40, 1),         # verifier online rep count
    ],
)
def test_blake3_bulk_chunk_cvs_match_python(n, R, base):
    """The bulk path of hash_columns and ColumnHasher.absorb: chunk CVs of
    n full chunks read straight from (T, R) transcript bytes, with chunk
    counters starting at `base`."""
    from reverie_tpu.crypto.blake3_py import _chunk_cv
    from reverie_tpu.crypto.kernels.blake3_jax import _bulk_cvs_bytes

    rng = np.random.RandomState(3)
    buf = rng.randint(0, 256, size=(n * 1024 + 37, R), dtype=np.uint8)
    r0, r1 = jax.jit(_bulk_cvs_bytes, static_argnums=(1,))(
        jnp.asarray(buf), n, base)
    got = np.concatenate([np.asarray(r0), np.asarray(r1)], axis=0)  # (8,n,R)
    for i in range(n):
        for c in range(R):
            want = _chunk_cv(buf[i * 1024 : (i + 1) * 1024, c].tobytes(),
                             base + i)
            assert list(got[:, i, c]) == want, (i, c)


def test_compile_program_disk_cache(tmp_path, monkeypatch):
    """The levelizer disk cache must round-trip CompiledCircuit exactly:
    proofs built from a cache-loaded circuit are byte-identical."""
    monkeypatch.setenv("REVERIE_COMPILE_CACHE", str(tmp_path))
    from reverie_tpu.circuit.builders import mul_bench_circuit
    from reverie_tpu.circuit.compile import compile_program

    prog, w2, wz = mul_bench_circuit(40)
    seeds = (np.arange(256 * 16, dtype=np.uint8).reshape(256, 16) % 251)
    cc_cold = compile_program(prog, cache_key=b"test:mul40")
    assert any(p.suffix == ".pkl" for p in tmp_path.iterdir())
    cc_warm = compile_program(prog, cache_key=b"test:mul40")
    p1 = TpuKKW(prog, cc=cc_cold).prove(w2, wz, seeds=seeds)
    p2 = TpuKKW(prog, cc=cc_warm).prove(w2, wz, seeds=seeds)
    assert p1.to_bytes() == p2.to_bytes()
    assert TpuKKW(prog, cc=cc_warm).verify(p2)
