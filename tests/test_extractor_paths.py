"""Device extractors (tpu_host.make_gf2_extractor / make_z64_extractor)
against direct NumPy models of the opened-stream wire layout, at a
single-proof lane count (R = 256) and a batch lane count (R = 768).

The extractors take the K opened repetition columns with a gather: on the
H100 it beat the int8 one-hot matmul form at every measured shape (see
PERF.md), so it is the only form."""

import numpy as np
import pytest


def _mk(cc, R, seed=3):
    rng = np.random.RandomState(seed)
    onl2 = rng.randint(0, 256, size=(cc.onl2, R), dtype=np.uint8)
    pre2 = rng.randint(0, 256, size=(cc.pre2, R), dtype=np.uint8)
    return onl2, pre2


def _pack(bits):
    """(N,) 0/1 -> the reference's MSB-first bytes with the always-emitted
    remainder byte (tpu_host._pack_bits_stream)."""
    from reverie_tpu.backend.tpu_host import _pack_bits_stream

    return np.frombuffer(_pack_bits_stream(bits), np.uint8)


@pytest.mark.parametrize("R", [256, 768])
def test_gf2_extractor_paths_agree(R):
    import jax.numpy as jnp

    from reverie_tpu.backend.tpu_host import TpuKKW, make_gf2_extractor
    from reverie_tpu.circuit.builders import mul_bench_circuit

    prog, _, _ = mul_bench_circuit(50)
    cc = TpuKKW(prog).cc
    onl2, pre2 = _mk(cc, R)
    K = 40 if R == 256 else 120
    rng = np.random.RandomState(7)
    cols = np.sort(rng.choice(R, size=K, replace=False)).astype(np.int32)
    shifts = rng.randint(0, 8, size=K).astype(np.uint8)

    got = np.asarray(make_gf2_extractor(cc)(
        jnp.asarray(onl2), jnp.asarray(pre2), jnp.asarray(shifts),
        jnp.asarray(cols)))
    rec = [_pack((onl2[cc.recon_slots2, c] >> s) & 1)
           for c, s in zip(cols, shifts)]
    cor = [_pack(pre2[cc.corr_slots2, c] & 1) for c in cols]
    inp = [_pack(onl2[cc.input_slots2, c] & 1) for c in cols]
    want = np.concatenate([np.concatenate(x) for x in (rec, cor, inp)])
    np.testing.assert_array_equal(got, want)


def test_z64_extractor_matches_numpy():
    """The z64 extractor vs a direct numpy model of the opened-stream
    layout (z64/share.rs: 8 players x 8 bytes per event; the proof opens
    the omitted player's 8 bytes)."""
    import jax.numpy as jnp

    from reverie_tpu.backend.tpu_host import TpuKKW, make_z64_extractor
    from reverie_tpu.circuit.builders import z64_mul_bench_circuit

    prog, _, _ = z64_mul_bench_circuit(20)
    cc = TpuKKW(prog).cc
    R = 256
    rng = np.random.RandomState(11)
    onlz_rows = cc.onlz
    prez_rows = cc.prez
    onlz = rng.randint(0, 256, size=(onlz_rows, R), dtype=np.uint8)
    prez = rng.randint(0, 256, size=(prez_rows, R), dtype=np.uint8)
    K = 40
    cols = np.sort(rng.choice(R, size=K, replace=False)).astype(np.int32)
    omit = rng.randint(0, 8, size=K).astype(np.int32)

    fn = make_z64_extractor(cc)
    got = np.asarray(fn(jnp.asarray(onlz), jnp.asarray(prez),
                        jnp.asarray(omit), jnp.asarray(cols)))

    nr, nc, ni = (len(cc.recon_slotsz), len(cc.corr_slotsz),
                  len(cc.input_slotsz))
    want = []
    rec = np.stack([
        np.stack([onlz[cc.recon_slotsz[e] + omit[j] * 8:
                       cc.recon_slotsz[e] + omit[j] * 8 + 8, cols[j]]
                  for e in range(nr)])
        for j in range(K)])
    want.append(rec.reshape(-1))
    cor = np.stack([
        np.stack([prez[cc.corr_slotsz[e]:cc.corr_slotsz[e] + 8, cols[j]]
                  for e in range(nc)])
        for j in range(K)])
    want.append(cor.reshape(-1))
    if ni:
        inp = np.stack([
            np.stack([onlz[cc.input_slotsz[e]:cc.input_slotsz[e] + 8,
                           cols[j]] for e in range(ni)])
            for j in range(K)])
        want.append(inp.reshape(-1))
    np.testing.assert_array_equal(got, np.concatenate(want))
