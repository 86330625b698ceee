"""Host orchestration for the device backend: tape preparation, transcript
hashing, proof extraction/injection, and the public prove/verify entry
points.  The device executes the circuit (backend/tpu.py); this module owns
everything around it (reference proof/mod.rs:118-308 orchestration).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..algebra import u64pair as up
from ..circuit.compile import CompiledCircuit, compile_program
from ..circuit.ir import CombineOp
from ..crypto import blake3, blake3_many, expand_seeds, keystream_batch
from ..params import DEFAULT_PARAMS, KEY_SIZE, ProtocolParams
from ..proof.challenge import challenge_to_opening, opening_to_packed
from ..proof.container import OpenOnline, OpenPreprocessing, Proof, ProofSingle
from .tpu import PROVER, VERIFY_ONL, VERIFY_PRE, Executor

U64 = np.uint64

GF2_BATCH_BYTES = 16
Z64_BATCH_BYTES = 1024
BATCH = 128

#: smallest gf2 / z64 tape (in mask slots) built by the device AES; smaller
#: tapes are built by host AES, where the device compile and launch would
#: outweigh the tape itself
GF2_DEVICE_MIN = 4096
Z64_DEVICE_MIN = 512


def device_tape_eligible(n_slots: int, R: int, min_slots: int) -> bool:
    """Whether a tape of `n_slots` masks at R repetitions is built by the
    bitsliced device AES: it must be large enough to pay for the launch,
    and the R*8 player keys must fill whole u32 lane words (32 keys each).
    The same rule serves TpuKKW and every StreamingKKW segment window."""
    return n_slots >= min_slots and (R * 8) % 32 == 0


# ---------------------------------------------------------------------------
# Tape preparation (host AES; the device AES is in crypto/kernels/aes_jax.py)
# ---------------------------------------------------------------------------


def build_tapes(player_keys: np.ndarray, omit: Optional[np.ndarray], m2: int, mz: int):
    """player_keys: (R, 8, 16) uint8; omit: (R,) int or None.

    Returns tape2 (m2, R) uint8 player-bit bytes, tapez_lo/hi (mz, 8, R) u32
    (player-major: reps on the minor axis so they land on vector lanes).
    """
    R = player_keys.shape[0]
    flat = player_keys.reshape(R * 8, KEY_SIZE)

    tape2 = np.zeros((max(m2, 1), R), dtype=np.uint8)[: m2 or 1]
    if m2:
        n2 = ((m2 + BATCH - 1) // BATCH) * GF2_BATCH_BYTES
        ks = keystream_batch(flat, n2).reshape(R, 8, n2)
        if omit is not None:
            idx = np.nonzero(omit < 8)[0]
            ks[idx, omit[idx].astype(np.int64)] = 0
        bits = np.unpackbits(ks, axis=-1)[:, :, :m2]  # (R, 8, m2)
        tape2 = np.packbits(bits.transpose(2, 0, 1), axis=-1)[..., 0]  # (m2, R)
    else:
        tape2 = np.zeros((0, R), dtype=np.uint8)

    if mz:
        nz = ((mz + BATCH - 1) // BATCH) * Z64_BATCH_BYTES
        ks = keystream_batch(flat, nz).reshape(R, 8, nz)
        if omit is not None:
            idx = np.nonzero(omit < 8)[0]
            ks[idx, omit[idx].astype(np.int64)] = 0
        words = np.ascontiguousarray(ks).view("<u8")[:, :, :mz]  # (R, 8, mz)
        words = np.transpose(words, (2, 1, 0))  # (mz, 8, R)
        lo, hi = up.from_u64(words)
    else:
        lo = np.zeros((0, 8, R), dtype=np.uint32)
        hi = np.zeros((0, 8, R), dtype=np.uint32)
    return tape2, lo, hi


#: depth beyond which GF2-only circuits use the lax.scan executor
SCAN_DEPTH_THRESHOLD = 128


def device_footprint(cc, R: int) -> int:
    """Exact peak device bytes of a TpuKKW prove at R reps, from the compiled
    circuit's actual array shapes.

    Terms (see Executor._trace and the tape builders for the shapes):
      tape2    (ceil(m2/128)*128, R) u8     -- GF2 mask tape rows
      tapez    (ceil(mz/128)*128, 8, R) u32 x2 (lo, hi)
      arenas   mask2+corr2 (n_vals2, R) u8; mzlo/mzhi (n_valsz, 8, R) u32;
               czlo/czhi (n_valsz, R) u32
      streams  onl2+pre2+onlz+prez (rows, R) u8, counted twice: the hash
               stage materializes the same bytes again as u32 words
      tables   gate index columns committed to device (int32)
    """
    # tape rows: the device AES (device_tape_eligible) emits whole
    # 128-value refills; below its thresholds the host builders are exact
    m2_rows = (((cc.m2 + BATCH - 1) // BATCH) * BATCH
               if device_tape_eligible(cc.m2, R, GF2_DEVICE_MIN) else cc.m2)
    mz_rows = (((cc.mz + BATCH - 1) // BATCH) * BATCH
               if device_tape_eligible(cc.mz, R, Z64_DEVICE_MIN) else cc.mz)
    t2 = m2_rows * R
    tz = mz_rows * R * 8 * 4 * 2
    arena2 = 2 * cc.n_vals2 * R
    arenaz = cc.n_valsz * R * (2 * 8 * 4 + 2 * 4)
    streams = (cc.onl2 + cc.pre2 + cc.onlz + cc.prez) * R
    if cc.depth > SCAN_DEPTH_THRESHOLD:
        # deep circuits run the scan executor: its NOP-padded uniform wave
        # tables (and, pure-GF2, a wave-contiguous renumbered arena) are the
        # real table cost -- build the same waves it would
        import dataclasses as _dc

        from ..circuit.compile import build_waves
        from .tpu_scan import default_wave_width

        wv = build_waves(cc, default_wave_width(cc))
        # int64 host columns land on device as int32 (x64 disabled)
        tables = sum(
            np.asarray(f).size * min(np.asarray(f).dtype.itemsize, 4)
            for f in _dc.asdict(wv).values()
            if f is not None and not np.isscalar(f)
        )
        if not wv.has_z64:
            arena2 = 2 * (1 + wv.op.size) * R
    else:
        tables = 0
        for table in cc.levels:
            for cols in table.values():
                for name, arr in cols.items():
                    tables += np.asarray(arr).size * 4
    return t2 + tz + arena2 + arenaz + 2 * streams + tables


# ---------------------------------------------------------------------------
# Transcript hashing
# ---------------------------------------------------------------------------


def _stream_hash(buf: np.ndarray, length: int) -> np.ndarray:
    """(T_padded, R) byte buffer -> (R, 32) per-rep blake3 over the first
    `length` rows (columns are the per-rep streams)."""
    R = buf.shape[1]
    rows = np.ascontiguousarray(buf[:length].T)  # (R, length)
    return blake3_many(rows if length else np.zeros((R, 0), np.uint8))


def domain_rep_hashes(onl: np.ndarray, pre: np.ndarray, onl_len: int, pre_len: int,
                      comm_online: Optional[np.ndarray] = None):
    """Per-rep H(preprocess || online) (transcript/mod.rs:77-96).  In the
    preprocess-verify role the online hash is the committed value."""
    hp = _stream_hash(pre, pre_len)
    ho = comm_online if comm_online is not None else _stream_hash(onl, onl_len)
    return blake3_many(np.concatenate([hp, ho], axis=1)), ho


def combined_rep_hashes(h2: np.ndarray, hz: np.ndarray) -> np.ndarray:
    """H(gf2_i || z64_i) per rep (combine.rs:104-118)."""
    return blake3_many(np.concatenate([h2, hz], axis=1))


# ---------------------------------------------------------------------------
# Stream packing (prover extraction) -- byte-exact wire formats
# ---------------------------------------------------------------------------


def _pack_bits_stream(bits: np.ndarray) -> bytes:
    """(N,) 0/1 -> packed bytes, 8 bits per byte MSB-first, with the
    reference's always-emitted zero-padded remainder byte
    (gf2/recon.rs:218-237, gf2/share.rs:120-135)."""
    n = len(bits)
    n_chunks = n // 8 + 1
    padded = np.zeros(n_chunks * 8, dtype=np.uint8)
    padded[:n] = bits
    return np.packbits(padded).tobytes()


def extract_gf2_openings(cc: CompiledCircuit, onl2_sel: np.ndarray, pre2_sel: np.ndarray,
                         omit_sel: np.ndarray):
    """Column-sliced buffers for the opened reps -> per-rep (recons, corrs,
    inputs) byte streams (prover extract, prover.rs:57-175)."""
    K = onl2_sel.shape[1]
    rec_rows = onl2_sel[cc.recon_slots2] if cc.n_recons2 else np.zeros((0, K), np.uint8)
    cor_rows = pre2_sel[cc.corr_slots2] if cc.n_corrs2 else np.zeros((0, K), np.uint8)
    inp_rows = onl2_sel[cc.input_slots2] if cc.n_inputs2 else np.zeros((0, K), np.uint8)
    out = []
    for j in range(K):
        p = int(omit_sel[j])
        recons = _pack_bits_stream((rec_rows[:, j] >> (7 - p)) & 1)
        corrs = _pack_bits_stream(cor_rows[:, j] & 1)
        inputs = _pack_bits_stream(inp_rows[:, j] & 1)
        out.append((recons, corrs, inputs))
    return out


def extract_z64_openings(cc: CompiledCircuit, onlz_sel: np.ndarray, prez_sel: np.ndarray,
                         omit_sel: np.ndarray):
    K = onlz_sel.shape[1]
    out = []
    for j in range(K):
        p = int(omit_sel[j])
        if len(cc.recon_slotsz):
            rows = (cc.recon_slotsz[:, None] + 8 * p + np.arange(8)[None, :]).reshape(-1)
            recons = onlz_sel[rows, j].tobytes()
        else:
            recons = b""
        if len(cc.corr_slotsz):
            rows = (cc.corr_slotsz[:, None] + np.arange(8)[None, :]).reshape(-1)
            corrs = prez_sel[rows, j].tobytes()
        else:
            corrs = b""
        if len(cc.input_slotsz):
            rows = (cc.input_slotsz[:, None] + np.arange(8)[None, :]).reshape(-1)
            inputs = onlz_sel[rows, j].tobytes()
        else:
            inputs = b""
        out.append((recons, corrs, inputs))
    return out


# ---------------------------------------------------------------------------
# Device-side extraction (prover): opened-column gather + bit packing
# ---------------------------------------------------------------------------


def _pack_rows_device(bits):
    """(N, K) 0/1 uint8 -> (N//8+1, K) packed bytes, MSB-first, with the
    reference's always-emitted remainder byte (see _pack_bits_stream)."""
    import jax.numpy as jnp

    N, K = bits.shape
    n_chunks = N // 8 + 1
    pad = n_chunks * 8 - N
    bits = jnp.concatenate([bits, jnp.zeros((pad, K), jnp.uint8)], axis=0)
    bits = bits.reshape(n_chunks, 8, K)
    w = jnp.asarray((128 >> np.arange(8)).astype(np.uint8))
    return jnp.sum(bits * w[None, :, None], axis=1, dtype=jnp.uint8)


def make_gf2_extractor(cc: CompiledCircuit, out_sharding=None):
    """Jitted device fn: (onl2, pre2, shifts_sel(K,) u8, cols(K,) i32) ->
    flat packed [recons | corrs | inputs], each (K, n//8+1) row-major.
    `out_sharding`: replicated NamedSharding on multi-process meshes so the
    host can read the extraction buffer on every process."""
    import jax
    import jax.numpy as jnp

    from .tpu import _classify

    def row_taker(slots: np.ndarray):
        """Slot rows are usually contiguous/strided runs -- use slices."""
        slots = slots.astype(np.int32)
        kind, *rest = _classify(slots)
        if kind == "const" and len(slots):
            v = rest[0]

            def take(buf):
                row = jax.lax.slice_in_dim(buf, v, v + 1, axis=0)
                return jnp.broadcast_to(row, (len(slots),) + buf.shape[1:])

            return take
        if kind == "arith":
            start, step = rest
            k = len(slots)

            def take(buf):
                return jax.lax.slice_in_dim(
                    buf, start, start + (k - 1) * step + 1, stride=step, axis=0
                )

            return take
        arr = jnp.asarray(slots)
        return lambda buf: jnp.take(buf, arr, axis=0)

    take_rec = row_taker(cc.recon_slots2)
    take_cor = row_taker(cc.corr_slots2)
    take_inp = row_taker(cc.input_slots2)

    def fn(onl2, pre2, shifts_sel, cols):
        # Select the K opened rep columns FIRST (K=40 online reps for a
        # prover at reference params, vs R=256 total): every downstream op
        # (shift, bit-pack, transpose) then runs on a 6.4x smaller array.
        onl_sel = jnp.take(onl2, cols, axis=1)  # (n_onl, K)
        pre_sel = jnp.take(pre2, cols, axis=1)  # (n_pre, K)
        rec_bits = (take_rec(onl_sel) >> shifts_sel[None, :]) & jnp.uint8(1)
        cor_bits = take_cor(pre_sel) & jnp.uint8(1)
        inp_bits = take_inp(onl_sel) & jnp.uint8(1)

        def packsel(bits):
            return _pack_rows_device(bits).T  # (K, n//8+1)

        # one flat buffer -> a single device->host pull in the caller
        return jnp.concatenate(
            [packsel(b).reshape(-1) for b in (rec_bits, cor_bits, inp_bits)]
        )

    if out_sharding is not None:
        return jax.jit(fn, out_shardings=out_sharding)
    return jax.jit(fn)


def make_z64_extractor(cc: CompiledCircuit, out_sharding=None):
    """Jitted device fn: (onlz, prez, omit(K,) i32, cols(K,) i32) -> flat u8
    [recons (K, n_rec*8) | corrs (K, n_cor*8) | inputs (K, n_inp*8)].

    The z64 share events are 64 bytes/rep on the wire (8 players x 8 bytes,
    z64/share.rs); the proof opens only the omitted player's 8 bytes.
    Selecting on device shrinks the device-to-host pull 8x."""
    import jax
    import jax.numpy as jnp

    nr, nc, ni = len(cc.recon_slotsz), len(cc.corr_slotsz), len(cc.input_slotsz)

    def _dense(slots, w):
        """start row if the slot list is a dense arithmetic run of stride w
        (every event's w rows contiguous -- true for all compiler-emitted
        z64 layouts); None -> gather fallback."""
        if len(slots) == 0:
            return None
        if len(slots) == 1 or (np.diff(slots) == w).all():
            return int(slots[0])
        return None

    r0 = _dense(cc.recon_slotsz, 64)
    c0 = _dense(cc.corr_slotsz, 8)
    i0 = _dense(cc.input_slotsz, 8)
    jrec = None if r0 is not None or not nr else jnp.asarray(
        (cc.recon_slotsz[:, None] + np.arange(64)[None, :]).reshape(-1).astype(np.int32)
    )
    jcor = None if c0 is not None or not nc else jnp.asarray(
        (cc.corr_slotsz[:, None] + np.arange(8)[None, :]).reshape(-1).astype(np.int32)
    )
    jinp = None if i0 is not None or not ni else jnp.asarray(
        (cc.input_slotsz[:, None] + np.arange(8)[None, :]).reshape(-1).astype(np.int32)
    )

    def fn(onlz, prez, omit_i32, cols):
        K = cols.shape[0]
        parts = []
        if nr:
            if r0 is not None:
                a = jax.lax.slice_in_dim(onlz, r0, r0 + 64 * nr, axis=0)
            else:
                a = jnp.take(onlz, jrec, axis=0)
            a = jnp.take(a.reshape(nr, 8, 8, onlz.shape[1]), cols, axis=3)
            idx = jnp.broadcast_to(omit_i32[None, None, None, :],
                                   (nr, 1, 8, K))
            sel = jnp.take_along_axis(a, idx, axis=1)[:, 0]
            parts.append(jnp.transpose(sel, (2, 0, 1)).reshape(-1))
        if nc:
            if c0 is not None:
                b_ = jax.lax.slice_in_dim(prez, c0, c0 + 8 * nc, axis=0)
            else:
                b_ = jnp.take(prez, jcor, axis=0)
            b_ = jnp.take(b_.reshape(nc, 8, prez.shape[1]), cols, axis=2)
            parts.append(jnp.transpose(b_, (2, 0, 1)).reshape(-1))
        if ni:
            if i0 is not None:
                c_ = jax.lax.slice_in_dim(onlz, i0, i0 + 8 * ni, axis=0)
            else:
                c_ = jnp.take(onlz, jinp, axis=0)
            c_ = jnp.take(c_.reshape(ni, 8, onlz.shape[1]), cols, axis=2)
            parts.append(jnp.transpose(c_, (2, 0, 1)).reshape(-1))
        if not parts:
            return jnp.zeros((0,), jnp.uint8)
        return jnp.concatenate(parts)

    if out_sharding is not None:
        return jax.jit(fn, out_shardings=out_sharding)
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Stream injection (verifier) -- proof streams to executor-layout arrays
# ---------------------------------------------------------------------------


def _bits_from_stream(stream: bytes, n: int) -> np.ndarray:
    """byte stream -> first n bits (MSB-first), zero-padded (lenient)."""
    bits = np.unpackbits(np.frombuffer(stream, dtype=np.uint8))
    out = np.zeros(n, dtype=np.uint8)
    take = min(n, len(bits))
    out[:take] = bits[:take]
    return out


def _u64s_from_stream(stream: bytes, n: int) -> np.ndarray:
    words = np.frombuffer(stream[: (len(stream) // 8) * 8], dtype="<u8")
    out = np.zeros(n, dtype=U64)
    take = min(n, len(words))
    out[:take] = words[:take]
    return out


def _stack_streams(streams: List[bytes], nb: int) -> np.ndarray:
    """Per-rep byte streams -> (nb, R) uint8, zero-padded/truncated to nb
    rows per rep (lenient parsing, online.rs:124,163,171)."""
    R = len(streams)
    out = np.zeros((nb, R), dtype=np.uint8)
    for r, s in enumerate(streams):
        take = min(len(s), nb)
        out[:take, r] = np.frombuffer(s[:take], dtype=np.uint8)
    return out


def build_online_injection_packed(cc: CompiledCircuit, openings2: List[OpenOnline],
                                  openingsz: List[OpenOnline]):
    """openings: one per rep (R = len).  Returns the *packed* proof streams
    as small host arrays; make_online_unpacker expands them on device.
    (Building the full (n, R) bit arrays on host costs an ~8x larger H2D
    transfer on every verify -- ~100 MB at 1M gates.)"""
    R = len(openings2)
    packed = dict(
        co2p=_stack_streams([o.corrs for o in openings2], cc.n_corrs2 // 8 + 1),
        in2p=_stack_streams([o.inputs for o in openings2], cc.n_inputs2 // 8 + 1),
        re2p=_stack_streams([o.recons for o in openings2], cc.n_recons2 // 8 + 1),
    )
    omit = np.array([o.omit for o in openings2], dtype=np.int64)
    omitz = np.array([o.omit for o in openingsz], dtype=np.int64)
    coz = np.zeros((cc.n_corrsz, R), dtype=U64)
    inz = np.zeros((cc.n_inputsz, R), dtype=U64)
    rez_val = np.zeros((cc.n_reconsz, R), dtype=U64)
    for r, o in enumerate(openingsz):
        coz[:, r] = _u64s_from_stream(o.corrs, cc.n_corrsz)
        inz[:, r] = _u64s_from_stream(o.inputs, cc.n_inputsz)
        rez_val[:, r] = _u64s_from_stream(o.recons, cc.n_reconsz)
    coz_lo, coz_hi = up.from_u64(coz)
    inz_lo, inz_hi = up.from_u64(inz)
    rez_lo, rez_hi = up.from_u64(rez_val)
    packed.update(
        omit_u8=omit.astype(np.uint8), omitz_i32=omitz.astype(np.int32),
        rezv_lo=rez_lo, rezv_hi=rez_hi,
    )
    small = dict(coz_lo=coz_lo, coz_hi=coz_hi, inz_lo=inz_lo, inz_hi=inz_hi)
    return packed, small, omit, omitz


def make_online_unpacker(cc: CompiledCircuit, mesh=None):
    """Jitted device fn: packed proof streams -> VERIFY_ONL injection arrays
    (bit-unpack per stream; z64 recon shares one-hot at the omitted player).
    `mesh`: on a multi-process mesh the injection arrays are emitted with
    their executor-input shardings (rep axis sharded) so each process
    unpacks only its repetition slice."""
    import jax
    import jax.numpy as jnp

    def unpack_bits(packed, n):
        nb, R = packed.shape
        if n == 0:
            return jnp.zeros((0, R), jnp.uint8)
        sh = jnp.uint8(7) - jnp.arange(8, dtype=jnp.uint8)
        bits = (packed[:, None, :] >> sh[None, :, None]) & jnp.uint8(1)
        return bits.reshape(nb * 8, R)[:n]

    def fn(co2p, in2p, re2p, omit_u8, rezv_lo, rezv_hi, omitz_i32):
        co2 = unpack_bits(co2p, cc.n_corrs2)
        in2 = unpack_bits(in2p, cc.n_inputs2)
        re2 = unpack_bits(re2p, cc.n_recons2) << (jnp.uint8(7) - omit_u8)[None, :]
        R = omitz_i32.shape[0]
        onehot = (jnp.arange(8, dtype=jnp.int32)[:, None] == omitz_i32[None, :]).astype(
            jnp.uint32
        )  # (8, R) player-major
        rez_lo = rezv_lo[:, None, :] * onehot[None, :, :]
        rez_hi = rezv_hi[:, None, :] * onehot[None, :, :]
        return dict(co2=co2, in2=in2, re2=re2, rez_lo=rez_lo, rez_hi=rez_hi)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = mesh.axis_names[0]
        out_sh = dict(
            co2=NamedSharding(mesh, P(None, rep)),
            in2=NamedSharding(mesh, P(None, rep)),
            re2=NamedSharding(mesh, P(None, rep)),
            rez_lo=NamedSharding(mesh, P(None, None, rep)),
            rez_hi=NamedSharding(mesh, P(None, None, rep)),
        )
        return jax.jit(fn, out_shardings=out_sh)
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# The proof system
# ---------------------------------------------------------------------------


class TpuKKW:
    """Compile a circuit once; prove and verify on the JAX device backend."""

    def __init__(self, program: Sequence[CombineOp], params: ProtocolParams = DEFAULT_PARAMS,
                 mesh=None, cc=None, cache_key=None):
        """`mesh`: optional jax.sharding.Mesh -- shards the repetition axis
        of proving/verification over the mesh devices (parallel/mesh.py).
        `cc`: optionally a precompiled circuit (make_system compiles once to
        size the system and passes it through).  `cache_key`: opaque bytes
        identifying `program` -- enables the levelizer's disk cache
        (compile.compile_program; the pure-Python compile pass is ~10 s at
        1M gates)."""
        self.params = params
        self.mesh = mesh
        from ..parallel.distributed import mesh_is_multiprocess

        # process-spanning mesh (multi-host shape): host-read outputs get
        # replicated out_shardings (XLA all-gathers across processes), and
        # device-built executor inputs get global out_shardings so each
        # process computes only its repetition slice
        self._multiproc = mesh_is_multiprocess(mesh)
        self.cc = (compile_program(program, cache_key=cache_key)
                   if cc is None else cc)
        self._executors: Dict[tuple, Executor] = {}
        self._hash_fns: Dict[tuple, object] = {}

    def _sh(self, *spec):
        """NamedSharding over self.mesh with the given PartitionSpec entries
        (None entries replicate that axis); only used when multiprocess."""
        from jax.sharding import NamedSharding, PartitionSpec

        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def _rep_axis_name(self):
        return self.mesh.axis_names[0]

    SCAN_DEPTH_THRESHOLD = SCAN_DEPTH_THRESHOLD

    @property
    def _use_tape_split(self):
        """Split-plane gf2 tape for the levelized executor (Executor.
        take_tape: contiguous MUL tape reads); the scan executor and
        process-spanning meshes keep the interleaved layout.
        REVERIE_TAPE_SPLIT=0 restores it everywhere."""
        import os as _os

        if _os.environ.get("REVERIE_TAPE_SPLIT", "1") in ("", "0"):
            return False
        return (self.cc.depth <= self.SCAN_DEPTH_THRESHOLD
                and not self._multiproc)

    def _executor(self, mode: int, R: int):
        key = (mode, R)
        if key not in self._executors:
            cc = self.cc
            if cc.depth > self.SCAN_DEPTH_THRESHOLD:
                from .tpu_scan import ScanExecutor

                self._executors[key] = ScanExecutor(cc, mode, total_reps=R,
                                                    mesh=self.mesh)
            else:
                self._executors[key] = Executor(self.cc, mode, total_reps=R,
                                                mesh=self.mesh,
                                                tape_split=self._use_tape_split)
        return self._executors[key]

    def _tape2_inp(self, tape2):
        """Input-dict entries for a gf2 tape in either layout."""
        if isinstance(tape2, tuple):
            return {"tape2_e": tape2[0], "tape2_o": tape2[1]}
        return {"tape2": tape2}

    def _gf2_tape(self, player_keys: np.ndarray, omit: Optional[np.ndarray],
                  split: bool = False):
        """GF2 mask tape via the bitsliced device AES (aes_jax); host AES for
        tiny tapes, where launch overhead dominates, and for rep counts whose
        keys do not fill whole u32 lane words.

        split=True returns (tape_e, tape_o): even/odd slot planes (slot s ->
        plane s & 1, row s >> 1), the layout the levelized executor's
        stride-2 MUL tape reads want (Executor.take_tape).  Proof bytes are
        unchanged."""
        cc = self.cc
        if cc.m2 == 0:
            z = np.zeros((0, player_keys.shape[0]), np.uint8)
            return (z, z) if split else z
        R = player_keys.shape[0]
        if not device_tape_eligible(cc.m2, R, GF2_DEVICE_MIN):
            t2, _, _ = build_tapes(player_keys, omit, cc.m2, 0)
            if split:
                # pad to an even slot count so both planes have equal rows:
                # take_tape's mixed-parity window ((start+k+1)>>1) may read
                # one row past floor(m2/2) on the odd plane (the device
                # tape is 128-slot aligned and never hits this)
                if t2.shape[0] & 1:
                    t2 = np.concatenate(
                        [t2, np.zeros((1, t2.shape[1]), np.uint8)]
                    )
                return t2[0::2], t2[1::2]
            return t2
        import jax
        import jax.numpy as jnp

        from ..crypto.kernels import aes_jax as aj

        nblocks = ((cc.m2 + BATCH - 1) // BATCH) * GF2_BATCH_BYTES // 16
        fn_key = ("aes", split)
        if fn_key not in self._hash_fns:
            # keys are uploaded raw: the AES key schedule and the counter
            # planes run on device (the round-key planes are 45x the keys)
            def fn(keys, nb, mask):
                t = aj.aes_ctr_tape_gf2(
                    aj.round_key_planes_device(keys),
                    aj.counter_planes_device(nb),
                    mask,
                )
                if split:
                    n = t.shape[0]
                    return t[0:n:2], t[1:n:2]
                return t

            kw = {}
            if self._multiproc:
                # each process builds only its repetition slice of the tape
                sh = self._sh(None, self._rep_axis_name())
                kw["out_shardings"] = (sh, sh) if split else sh
            self._hash_fns[fn_key] = jax.jit(fn, static_argnums=(1,), **kw)
        if omit is None:
            mask = np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32)
        else:
            mask = aj.lane_mask_from_omit(omit, R)
        keys = player_keys.reshape(-1, KEY_SIZE)
        return self._hash_fns[fn_key](jnp.asarray(keys), nblocks,
                                      jnp.asarray(mask))

    def _z64_tape(self, player_keys: np.ndarray, omit: Optional[np.ndarray]):
        """Z64 mask tape via the bitsliced device AES (host AES for tiny
        tapes and for rep counts that do not fill whole lane words)."""
        cc = self.cc
        R = player_keys.shape[0]
        if cc.mz == 0:
            z = np.zeros((0, 8, R), np.uint32)
            return z, z
        if not device_tape_eligible(cc.mz, R, Z64_DEVICE_MIN):
            _, lo, hi = build_tapes(player_keys, omit, 0, cc.mz)
            return lo, hi
        import jax
        import jax.numpy as jnp

        from ..crypto.kernels import aes_jax as aj

        B = ((cc.mz + BATCH - 1) // BATCH) * Z64_BATCH_BYTES // 16
        if "aesz" not in self._hash_fns:
            def zfn(keys, nb, mask):
                return aj.aes_ctr_tape_z64_chunked(
                    aj.round_key_planes_device(keys),
                    aj.counter_planes_device(nb),
                    mask,
                )

            kw = {}
            if self._multiproc:
                rep = self._rep_axis_name()
                kw["out_shardings"] = (
                    self._sh(None, None, rep), self._sh(None, None, rep)
                )
            self._hash_fns["aesz"] = jax.jit(zfn, static_argnums=(1,), **kw)
        # player-major key order (key p*R + r): the (mz, 8, R) output
        # reshape is then free (see aes_jax.aes_ctr_tape_z64)
        pk_pm = np.ascontiguousarray(player_keys.transpose(1, 0, 2))
        if omit is None:
            mask = np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32)
        else:
            mask = aj.lane_mask_raw_pm(omit, R)
        return self._hash_fns["aesz"](
            jnp.asarray(pk_pm.reshape(-1, KEY_SIZE)), B, jnp.asarray(mask))

    def _hash_fn(self, with_comm: bool):
        """Jitted device transcript-hash pipeline.

        Maps the four stream buffers to per-rep combined hashes
        (transcript/mod.rs:77-96 + combine.rs:104-118) entirely on device;
        `with_comm` replaces the online hashes with committed values
        (preprocess verification, verifier/preprocess.rs:55-57)."""
        import jax

        from ..crypto.kernels.blake3_jax import hash_columns, hash_pair_columns

        key = (with_comm,)
        if key in self._hash_fns:
            return self._hash_fns[key]
        cc = self.cc

        if with_comm:
            def fn(onl2, pre2, onlz, prez, comm2, commz):
                hp2 = hash_columns(pre2, cc.pre2)
                hpz = hash_columns(prez, cc.prez)
                h2 = hash_pair_columns(hp2, comm2)
                hz = hash_pair_columns(hpz, commz)
                return hash_pair_columns(h2, hz), comm2, commz
        else:
            def fn(onl2, pre2, onlz, prez):
                ho2 = hash_columns(onl2, cc.onl2)
                hoz = hash_columns(onlz, cc.onlz)
                hp2 = hash_columns(pre2, cc.pre2)
                hpz = hash_columns(prez, cc.prez)
                h2 = hash_pair_columns(hp2, ho2)
                hz = hash_pair_columns(hpz, hoz)
                return hash_pair_columns(h2, hz), ho2, hoz

        kw = {}
        if self._multiproc:
            # THE rep-hash all-gather: per-rep hashes are 32 B/rep, so
            # replicating them to every process is the cheap DCN collective
            # that lets each process derive the same Fiat-Shamir challenge
            n_out = 3
            kw["out_shardings"] = tuple(self._sh() for _ in range(n_out))
        self._hash_fns[key] = jax.jit(fn, **kw)
        return self._hash_fns[key]

    def _pull_hash_fail(self):
        """Jitted concat of (rep_h, fail[, ho2, hoz]) into one uint8 buffer:
        a single device->host transfer (one pull instead of up to four
        small ones per proof)."""
        if "pull_hf" not in self._hash_fns:
            import jax
            import jax.numpy as jnp

            def fn(rep_h, fail, *extra):
                parts = [rep_h.reshape(-1)]
                parts.extend(e.reshape(-1) for e in extra)
                parts.append(fail.reshape(-1).astype(jnp.uint8))
                return jnp.concatenate(parts)

            kw = {"out_shardings": self._sh()} if self._multiproc else {}
            self._hash_fns["pull_hf"] = jax.jit(fn, **kw)
        return self._hash_fns["pull_hf"]

    # -- proving ------------------------------------------------------------
    def prove(self, wit_gf2, wit_z64, seeds: Optional[np.ndarray] = None) -> Proof:
        import os as _os

        from ..utils.profiling import PhaseTimer

        timer = PhaseTimer()
        profile = bool(_os.environ.get("REVERIE_PROFILE"))
        st = self._prove_dispatch(wit_gf2, wit_z64, seeds,
                                  timer=timer if profile else None)
        with timer.phase("challenge"):
            self._prove_challenge(st)
        with timer.phase("extract_pull"):
            proof = self._prove_assemble(st)
        if profile:
            import sys as _sys

            print("prove phase breakdown:\n" + timer.report(), file=_sys.stderr)
        return proof

    def prove_many(self, jobs, seeds: Optional[np.ndarray] = None):
        """Software-pipelined proving of independent statements (same
        circuit): proof i's device->host proof transfer and host assembly
        overlap proof i+1's device compute, so sustained throughput is set by
        per-proof device time rather than device time + transfer.  This is
        the device analog of running the reference prover on a stream of
        statements (its rayon pool keeps the CPU busy across proofs).

        `jobs`: list of (wit_gf2, wit_z64); `seeds`: (N, total_reps, 16).
        Returns a list of Proofs, each byte-identical to `prove()`'s output
        for the same seed."""
        import os as _os

        n = len(jobs)
        if n == 0:
            return []
        R = self.params.total_reps
        if seeds is None:
            seeds = np.frombuffer(
                _os.urandom(n * R * KEY_SIZE), dtype=np.uint8
            ).reshape(n, R, KEY_SIZE)
        seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(n, R, KEY_SIZE)
        states: list = [None] * n
        proofs: list = [None] * n
        for i in range(n):
            states[i] = self._prove_dispatch(jobs[i][0], jobs[i][1], seeds[i])
            if i >= 1:
                self._prove_challenge(states[i - 1])
            if i >= 2:
                proofs[i - 2] = self._prove_assemble(states[i - 2])
                states[i - 2] = None
        self._prove_challenge(states[n - 1])
        if n >= 2:
            proofs[n - 2] = self._prove_assemble(states[n - 2])
        proofs[n - 1] = self._prove_assemble(states[n - 1])
        return proofs

    def _prove_dispatch(self, wit_gf2, wit_z64, seeds, timer=None):
        """Pipeline stage 1: enqueue all pre-challenge device work (tapes,
        execution, transcript hashing) and start the async pull of the
        per-rep hashes.  Returns the in-flight proof state."""
        import os as _os

        cc, params = self.cc, self.params
        R = params.total_reps

        if timer is None:
            from ..utils.profiling import PhaseTimer

            timer = PhaseTimer()
            profile = False
        else:
            profile = True

        if seeds is None:
            seeds = np.frombuffer(
                _os.urandom(R * KEY_SIZE), dtype=np.uint8
            ).reshape(R, KEY_SIZE)
        seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(R, KEY_SIZE)

        with timer.phase("expand_seeds"):
            player_keys = expand_seeds(seeds).reshape(R, 8, KEY_SIZE)
        # non-divisor meshes (e.g. 12 devices): pad the repetition axis with
        # dummy zero-key lanes so GSPMD shards evenly; hashes/fail flags are
        # sliced back to R in _prove_challenge and extraction gathers only
        # real lanes, so proof bytes are unchanged (the verifier pads the
        # same way, _rep_pad).  Reference analog: rayon over any group
        # count (proof/mod.rs:249,266).
        Rp = self._rep_pad(R)
        pk_exec = player_keys
        if Rp != R:
            pk_exec = np.concatenate(
                [player_keys,
                 np.zeros((Rp - R, 8, KEY_SIZE), np.uint8)])
        with timer.phase("tape_gf2"):
            tape2 = self._gf2_tape(pk_exec, None, split=self._use_tape_split)
            if profile:
                import jax

                jax.block_until_ready(tape2)
        with timer.phase("tape_z64"):
            tz_lo, tz_hi = self._z64_tape(pk_exec, None)

        wit2 = np.asarray([1 if b else 0 for b in wit_gf2], dtype=np.uint8)
        witz = np.asarray([int(v) & 0xFFFFFFFFFFFFFFFF for v in wit_z64], dtype=U64)
        if len(wit2) < cc.n_wit2 or len(witz) < cc.n_witz:
            raise AssertionError("witness is too short")
        wl, wh = up.from_u64(witz[: cc.n_witz])

        if self._multiproc:
            # host-side broadcast: zero-size outputs reject forced jit
            # shardings, and witness columns are small; shard_inputs
            # device_puts the (n_wit, R) arrays with the global sharding
            def bc(w, r):
                return np.ascontiguousarray(np.repeat(w, r, axis=1))
        else:
            if "wit_bcast" not in self._hash_fns:
                import jax
                import jax.numpy as _jnp

                self._hash_fns["wit_bcast"] = jax.jit(
                    lambda w, r: _jnp.repeat(w, r, axis=1), static_argnums=(1,)
                )
            bc = self._hash_fns["wit_bcast"]
        wit2_bc = bc(wit2[: cc.n_wit2, None], Rp)
        wzlo_bc = bc(wl[:, None], Rp)
        wzhi_bc = bc(wh[:, None], Rp)
        with timer.phase("execute"):
            inp = dict(
                tapez_lo=tz_lo, tapez_hi=tz_hi,
                # one witness column uploaded; broadcast to R on device
                wit2=wit2_bc, witz_lo=wzlo_bc, witz_hi=wzhi_bc,
                **self._tape2_inp(tape2),
            )
            if self.mesh is not None:
                from ..parallel.mesh import shard_inputs

                inp = shard_inputs(self.mesh, inp)
            out = self._executor(PROVER, Rp)(inp)
            if profile:
                import jax

                jax.block_until_ready(out)
        with timer.phase("hash"):
            rep_h, ho2, hoz = self._hash_fn(False)(
                out["onl2"], out["pre2"], out["onlz"], out["prez"]
            )
            # one fused device->host transfer: hashes + per-rep fail flags
            dbuf = self._pull_hash_fail()(rep_h, out["fail"], ho2, hoz)
            try:
                dbuf.copy_to_host_async()
            except AttributeError:  # sharded / older arrays: pull lazily
                pass
            if profile:
                import jax

                jax.block_until_ready(dbuf)
        return dict(seeds=seeds, player_keys=player_keys, out=out, dbuf=dbuf,
                    Rp=Rp)

    def _prove_challenge(self, st):
        """Pipeline stage 2: block on the hash pull, derive the Fiat-Shamir
        challenge on host, enqueue device extraction of the opened streams
        and start their async pulls."""
        params = self.params
        R = params.total_reps
        # Rp > R on non-divisor meshes: the dispatch padded the rep axis
        # with dummy zero-key lanes; everything per-rep is sliced back to R
        # here (a dummy lane's fail flag is meaningless -- its asserts ran
        # on garbage shares)
        Rp = st.pop("Rp", R)
        buf = np.asarray(st.pop("dbuf"))
        rep_h = buf[: Rp * 32].reshape(Rp, 32)[:R]
        st["ho2"] = buf[Rp * 32 : 2 * Rp * 32].reshape(Rp, 32)[:R]
        st["hoz"] = buf[2 * Rp * 32 : 3 * Rp * 32].reshape(Rp, 32)[:R]
        if buf[3 * Rp * 32 : 3 * Rp * 32 + R].any():
            raise AssertionError("witness is invalid (AssertZero failed)")
        comm = blake3(rep_h.tobytes())
        open_map = challenge_to_opening(comm, params)
        omit = np.full(R, 8, dtype=np.int64)
        for rep, p in open_map.items():
            omit[rep] = p
        cols = np.nonzero(omit < 8)[0]
        omit_sel = omit[cols]
        out = st.pop("out")
        st["g2buf"] = self._extract_gf2_dispatch(out, cols, omit_sel)
        st["zbuf"] = self._extract_z64_dispatch(out, cols, omit_sel)
        for b in (st["g2buf"], st["zbuf"]):
            if b is not None:
                try:
                    b.copy_to_host_async()
                except AttributeError:
                    pass
        st.update(comm=comm, omit=omit, K=len(cols))

    def _prove_assemble(self, st) -> Proof:
        """Pipeline stage 3: block on the opened-stream pulls and assemble
        the proof container."""
        R = self.params.total_reps
        K = st["K"]
        open2 = self._parse_gf2_buf(np.asarray(st["g2buf"]), K)
        openz = self._parse_z64_buf(
            None if st["zbuf"] is None else np.asarray(st["zbuf"]), K
        )
        seeds, player_keys, omit = st["seeds"], st["player_keys"], st["omit"]
        ho2, hoz = st["ho2"], st["hoz"]
        p2 = ProofSingle([], [])
        pz = ProofSingle([], [])
        j = 0
        for r in range(R):
            if omit[r] < 8:
                ks = player_keys[r].copy()
                ks[omit[r]] = 0
                rec, cor, inpt = open2[j]
                p2.online.append(OpenOnline(int(omit[r]), ks.tobytes(), rec, cor, inpt))
                rec, cor, inpt = openz[j]
                pz.online.append(OpenOnline(int(omit[r]), ks.tobytes(), rec, cor, inpt))
                j += 1
            else:
                p2.preprocessing.append(
                    OpenPreprocessing(seeds[r].tobytes(), ho2[r].tobytes())
                )
                pz.preprocessing.append(
                    OpenPreprocessing(seeds[r].tobytes(), hoz[r].tobytes())
                )
        return Proof(st["comm"], p2, pz)

    def _extract_gf2_dispatch(self, out, cols: np.ndarray, omit_sel: np.ndarray):
        """Enqueue device extraction of the gf2 opened streams (column
        gather + bit packing); returns the in-flight device buffer."""
        import jax.numpy as jnp

        cc = self.cc
        R = out["onl2"].shape[1]
        K = len(cols)
        if "extract2" not in self._hash_fns:
            self._hash_fns["extract2"] = {}
        cache = self._hash_fns["extract2"]
        key = (R, K)
        if key not in cache:
            cache[key] = make_gf2_extractor(
                cc, out_sharding=self._sh() if self._multiproc else None
            )
        shifts_sel = (7 - omit_sel).astype(np.uint8)
        return cache[key](
            out["onl2"], out["pre2"], jnp.asarray(shifts_sel),
            jnp.asarray(cols.astype(np.int32)),
        )  # single buffer: rec | cor | inp, each (K, n//8+1) flattened

    def _parse_gf2_buf(self, buf: np.ndarray, K: int):
        """Split a pulled gf2 extraction buffer into per-rep
        (recons, corrs, inputs) byte strings."""
        cc = self.cc
        nb_r, nb_c, nb_i = (
            cc.n_recons2 // 8 + 1, cc.n_corrs2 // 8 + 1, cc.n_inputs2 // 8 + 1,
        )
        rec = buf[: K * nb_r].reshape(K, nb_r)
        cor = buf[K * nb_r : K * (nb_r + nb_c)].reshape(K, nb_c)
        inp = buf[K * (nb_r + nb_c) :].reshape(K, nb_i)
        return [
            (rec[j].tobytes(), cor[j].tobytes(), inp[j].tobytes())
            for j in range(K)
        ]

    def _extract_z64_dispatch(self, out, cols: np.ndarray, omit_sel: np.ndarray):
        """Enqueue device extraction of the z64 opened streams (omitted-player
        bytes selected before the pull); returns the in-flight device buffer,
        or None when the circuit has no z64 events."""
        import jax.numpy as jnp

        cc = self.cc
        nr, nc, ni = len(cc.recon_slotsz), len(cc.corr_slotsz), len(cc.input_slotsz)
        if nr == 0 and nc == 0 and ni == 0:
            return None
        if "extractz" not in self._hash_fns:
            self._hash_fns["extractz"] = make_z64_extractor(
                cc, out_sharding=self._sh() if self._multiproc else None
            )
        return self._hash_fns["extractz"](
            out["onlz"], out["prez"],
            jnp.asarray(omit_sel.astype(np.int32)),
            jnp.asarray(cols.astype(np.int32)),
        )

    def _parse_z64_buf(self, buf: Optional[np.ndarray], K: int):
        """Split a pulled z64 extraction buffer into per-rep
        (recons, corrs, inputs) byte strings."""
        cc = self.cc
        nr, nc, ni = len(cc.recon_slotsz), len(cc.corr_slotsz), len(cc.input_slotsz)
        if buf is None:
            return [(b"", b"", b"")] * K
        o1, o2 = K * nr * 8, K * (nr + nc) * 8
        rec = buf[:o1].reshape(K, nr * 8)
        cor = buf[o1:o2].reshape(K, nc * 8)
        inp = buf[o2:].reshape(K, ni * 8)
        return [
            (rec[j].tobytes(), cor[j].tobytes(), inp[j].tobytes())
            for j in range(K)
        ]

    # -- batch proving ------------------------------------------------------
    def prove_batch(self, witnesses, seeds: Optional[np.ndarray] = None):
        """Prove N independent statements of the same circuit in one device
        batch (bench config 5).  `witnesses`: list of (wit_gf2, wit_z64);
        `seeds`: (N, total_reps, 16).  All N x 256 repetitions execute as one
        lane axis; per-proof challenges/extraction happen on host.
        Returns a list of Proofs (each independently reference-compatible)."""
        st = self._batch_dispatch(witnesses, seeds)
        self._batch_challenge(st)
        return self._batch_assemble(st)

    def prove_batch_chunked(self, witnesses, seeds: Optional[np.ndarray] = None,
                            chunk: int = 64):
        """Software-pipelined chunked batch proving: the device computes
        chunk i+1 while chunk i's Fiat-Shamir challenge, proof pull, and host
        assembly run (same 3-stage pipeline as prove_many, at batch width).
        Sized for config-5-scale workloads (e.g. 1024 SHA-256 proofs on one
        chip) where one device batch of all N would exceed HBM.

        Peak HBM is ~2x one chunk's footprint: chunk i's full transcript
        streams stay live (awaiting challenge + extraction pulls) while chunk
        i+1 dispatches -- size `chunk` so 2x device_footprint(cc, chunk*R)
        fits the HBM budget."""
        import os as _os

        n = len(witnesses)
        if n == 0:
            return []
        R = self.params.total_reps
        if seeds is None:
            seeds = np.frombuffer(
                _os.urandom(n * R * KEY_SIZE), dtype=np.uint8
            ).reshape(n, R, KEY_SIZE)
        seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(n, R, KEY_SIZE)
        bounds = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
        k = len(bounds)
        states: list = [None] * k
        proofs: list = [None] * n

        def assemble(ci):
            lo, hi = bounds[ci]
            proofs[lo:hi] = self._batch_assemble(states[ci])
            states[ci] = None

        for ci, (lo, hi) in enumerate(bounds):
            states[ci] = self._batch_dispatch(witnesses[lo:hi], seeds[lo:hi])
            if ci >= 1:
                self._batch_challenge(states[ci - 1])
            if ci >= 2:
                assemble(ci - 2)
        self._batch_challenge(states[k - 1])
        if k >= 2:
            assemble(k - 2)
        assemble(k - 1)
        return proofs

    def _batch_dispatch(self, witnesses, seeds: Optional[np.ndarray] = None):
        """Batch pipeline stage 1: enqueue tapes, batched execution, and
        transcript hashing for N statements; start the async hash pull."""
        cc, params = self.cc, self.params
        N = len(witnesses)
        R = params.total_reps
        RT = N * R
        import os as _os

        from ..utils.profiling import PhaseTimer

        timer = PhaseTimer()
        profile = bool(_os.environ.get("REVERIE_PROFILE"))

        if seeds is None:
            seeds = np.frombuffer(
                _os.urandom(RT * KEY_SIZE), dtype=np.uint8
            ).reshape(N, R, KEY_SIZE)
        seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(N, R, KEY_SIZE)

        with timer.phase("expand_seeds"):
            player_keys = expand_seeds(seeds.reshape(-1, KEY_SIZE)).reshape(RT, 8, KEY_SIZE)
        with timer.phase("tape_gf2"):
            tape2 = self._gf2_tape(player_keys, None,
                                   split=self._use_tape_split)
            if profile:
                import jax

                jax.block_until_ready(tape2)
        with timer.phase("tape_z64"):
            tz_lo, tz_hi = self._z64_tape(player_keys, None)

        with timer.phase("wit_build"):
            # upload one column per proof and broadcast to the R repetition
            # lanes on device (the (n_wit, N*R) tensor is R x larger)
            w2c = np.zeros((cc.n_wit2, N), dtype=np.uint8)
            wlc = np.zeros((cc.n_witz, N), dtype=np.uint32)
            whc = np.zeros((cc.n_witz, N), dtype=np.uint32)
            for pidx, (w2, wz) in enumerate(witnesses):
                a2 = np.asarray([1 if b else 0 for b in w2], dtype=np.uint8)
                az = np.asarray([int(v) & 0xFFFFFFFFFFFFFFFF for v in wz], dtype=U64)
                if len(a2) < cc.n_wit2 or len(az) < cc.n_witz:
                    raise AssertionError("witness is too short")
                lo, hi = up.from_u64(az[: cc.n_witz])
                w2c[:, pidx] = a2[: cc.n_wit2]
                wlc[:, pidx] = lo
                whc[:, pidx] = hi
            if self._multiproc:
                def bc(w, r):
                    return np.ascontiguousarray(np.repeat(w, r, axis=1))
            else:
                if "wit_bcast" not in self._hash_fns:
                    import jax

                    import jax.numpy as _jnp

                    self._hash_fns["wit_bcast"] = jax.jit(
                        lambda w, r: _jnp.repeat(w, r, axis=1),
                        static_argnums=(1,),
                    )
                bc = self._hash_fns["wit_bcast"]
            wit2, wzlo, wzhi = bc(w2c, R), bc(wlc, R), bc(whc, R)

        inp = dict(
            tapez_lo=tz_lo, tapez_hi=tz_hi,
            wit2=wit2, witz_lo=wzlo, witz_hi=wzhi,
            **self._tape2_inp(tape2),
        )
        if self.mesh is not None:
            from ..parallel.mesh import shard_inputs

            inp = shard_inputs(self.mesh, inp)
        with timer.phase("execute"):
            out = self._executor(PROVER, RT)(inp)
            if profile:
                import jax

                jax.block_until_ready(out)
        with timer.phase("hash"):
            rep_h, ho2, hoz = self._hash_fn(False)(
                out["onl2"], out["pre2"], out["onlz"], out["prez"]
            )
            dbuf = self._pull_hash_fail()(rep_h, out["fail"], ho2, hoz)
            try:
                dbuf.copy_to_host_async()
            except AttributeError:
                pass
        return dict(N=N, seeds=seeds, player_keys=player_keys, out=out,
                    dbuf=dbuf, timer=timer, profile=profile)

    def _batch_challenge(self, st):
        """Batch pipeline stage 2: block on the hash pull, derive each
        proof's challenge, enqueue extraction + async pulls."""
        params = self.params
        N, R = st["N"], params.total_reps
        RT = N * R
        timer = st["timer"]
        buf = np.asarray(st.pop("dbuf"))
        rep_h = buf[: RT * 32].reshape(N, R, 32)
        st["ho2"] = buf[RT * 32 : 2 * RT * 32].reshape(N, R, 32)
        st["hoz"] = buf[2 * RT * 32 : 3 * RT * 32].reshape(N, R, 32)
        fail = buf[3 * RT * 32 :].reshape(N, R)
        if fail.any():
            bad = int(np.nonzero(fail.any(axis=1))[0][0])
            raise AssertionError(f"witness {bad} is invalid (AssertZero failed)")

        with timer.phase("challenge"):
            comms = [blake3(rep_h[pidx].tobytes()) for pidx in range(N)]
            omits = np.full((N, R), 8, dtype=np.int64)
            for pidx in range(N):
                for rep, pl in challenge_to_opening(comms[pidx], params).items():
                    omits[pidx, rep] = pl

        flat_omit = omits.reshape(RT)
        cols = np.nonzero(flat_omit < 8)[0]
        omit_sel = flat_omit[cols]
        out = st.pop("out")
        with timer.phase("extract_dispatch"):
            st["g2buf"] = self._extract_gf2_dispatch(out, cols, omit_sel)
            st["zbuf"] = self._extract_z64_dispatch(out, cols, omit_sel)
            for b in (st["g2buf"], st["zbuf"]):
                if b is not None:
                    try:
                        b.copy_to_host_async()
                    except AttributeError:
                        pass
        st.update(comms=comms, omits=omits, K=len(cols))

    def _batch_assemble(self, st):
        """Batch pipeline stage 3: block on the opened-stream pulls and
        assemble the N proof containers."""
        params = self.params
        N, R, K = st["N"], params.total_reps, st["K"]
        timer, profile = st["timer"], st["profile"]
        with timer.phase("extract_pull"):
            open2 = self._parse_gf2_buf(np.asarray(st["g2buf"]), K)
            openz = self._parse_z64_buf(
                None if st["zbuf"] is None else np.asarray(st["zbuf"]), K
            )
        seeds, player_keys = st["seeds"], st["player_keys"]
        comms, omits = st["comms"], st["omits"]
        ho2, hoz = st["ho2"], st["hoz"]
        timer_assemble = timer.phase("assemble")
        timer_assemble.__enter__()
        proofs = []
        j = 0
        for pidx in range(N):
            p2 = ProofSingle([], [])
            pz = ProofSingle([], [])
            for r in range(R):
                omit = int(omits[pidx, r])
                if omit < 8:
                    ks = player_keys[pidx * R + r].copy()
                    ks[omit] = 0
                    rec, cor, inpt = open2[j]
                    p2.online.append(OpenOnline(omit, ks.tobytes(), rec, cor, inpt))
                    rec, cor, inpt = openz[j]
                    pz.online.append(OpenOnline(omit, ks.tobytes(), rec, cor, inpt))
                    j += 1
                else:
                    p2.preprocessing.append(
                        OpenPreprocessing(seeds[pidx, r].tobytes(), ho2[pidx, r].tobytes())
                    )
                    pz.preprocessing.append(
                        OpenPreprocessing(seeds[pidx, r].tobytes(), hoz[pidx, r].tobytes())
                    )
            proofs.append(Proof(comms[pidx], p2, pz))
        timer_assemble.__exit__(None, None, None)
        if profile:
            import sys as _sys

            print("prove_batch phase breakdown:\n" + timer.report(), file=_sys.stderr)
        return proofs

    # -- verification -------------------------------------------------------
    def _rep_pad(self, R: int) -> int:
        """Smallest rep count >= R divisible by the mesh size.  Verifier rep
        counts (40 online / 216 preprocessing) don't divide meshes larger
        than 8 devices; the re-executions pad with dummy repetition lanes
        (zero keys/streams, outputs sliced back to R) so ONE proof scales
        past gcd(256,40,216)=8 devices.  The reference's analog is rayon
        over any number of packed groups (proof/mod.rs:249,266)."""
        if self.mesh is None:
            return R
        D = self.mesh.size
        return ((R + D - 1) // D) * D

    def verify(self, proof: Proof, strict_zero_check: bool = True) -> bool:
        st = self._verify_dispatch(proof)
        if st is False:
            return False
        return self._verify_finish(st, strict_zero_check)

    def verify_many(self, proofs, strict_zero_check: bool = True):
        """Software-pipelined verification of a stream of proofs: proof
        i+1's host-side injection prep + uploads overlap proof i's device
        re-executions and hash pulls (the device analog of a rayon'd verifier
        service; sustained throughput is set by per-proof device time, not
        device + transfer).  Returns [bool] in order; each result equals
        verify() on that proof."""
        states = []
        results = [None] * len(proofs)
        for i, p in enumerate(proofs):
            states.append(self._verify_dispatch(p))
            if i >= 1 and states[i - 1] is not False:
                results[i - 1] = self._verify_finish(states[i - 1],
                                                     strict_zero_check)
                states[i - 1] = None
        for i, st in enumerate(states):
            if st is False:
                results[i] = False
            elif st is not None:
                results[i] = self._verify_finish(st, strict_zero_check)
        return results

    def _verify_dispatch(self, proof: Proof):
        """Enqueue both verifier re-executions (online + preprocessing) and
        start the async hash pulls; returns the in-flight state, or False
        for a malformed proof."""
        import os as _os

        from ..utils.profiling import PhaseTimer

        timer = PhaseTimer()
        profile = bool(_os.environ.get("REVERIE_PROFILE"))
        cc, params = self.cc, self.params
        if not proof.gf2.check_format(params.online_reps, params.preprocessing_reps):
            return False
        if not proof.z64.check_format(params.online_reps, params.preprocessing_reps):
            return False

        # ---- online re-execution (all 40 opened reps as one batch) --------
        Ro = params.online_reps
        Rop = self._rep_pad(Ro)
        with timer.phase("onl_inject"):
            packed, small, omit, omitz = build_online_injection_packed(
                cc, proof.gf2.online, proof.z64.online
            )
            player_keys = np.stack(
                [np.frombuffer(o.seeds, dtype=np.uint8).reshape(8, KEY_SIZE) for o in proof.gf2.online]
            )
            player_keysz = np.stack(
                [np.frombuffer(o.seeds, dtype=np.uint8).reshape(8, KEY_SIZE) for o in proof.z64.online]
            )
            if Rop != Ro:
                pad = Rop - Ro
                player_keys = np.concatenate(
                    [player_keys, np.zeros((pad, 8, KEY_SIZE), np.uint8)])
                player_keysz = np.concatenate(
                    [player_keysz, np.zeros((pad, 8, KEY_SIZE), np.uint8)])
                omit = np.concatenate([omit, np.full(pad, 8, omit.dtype)])
                omitz = np.concatenate([omitz, np.full(pad, 8, omitz.dtype)])
                packed = {
                    k: np.concatenate(
                        [v, np.zeros(v.shape[:-1] + (pad,), v.dtype)], axis=-1)
                    for k, v in packed.items()
                }
                small = {
                    k: np.concatenate(
                        [v, np.zeros(v.shape[:-1] + (pad,), v.dtype)], axis=-1)
                    for k, v in small.items()
                }
            if "onl_unpack" not in self._hash_fns:
                self._hash_fns["onl_unpack"] = make_online_unpacker(
                    cc, mesh=self.mesh if self._multiproc else None
                )
            inj = self._hash_fns["onl_unpack"](
                packed["co2p"], packed["in2p"], packed["re2p"], packed["omit_u8"],
                packed["rezv_lo"], packed["rezv_hi"], packed["omitz_i32"],
            )
            inj.update(small)
        with timer.phase("onl_tape"):
            tape2 = self._gf2_tape(player_keys, omit,
                                   split=self._use_tape_split)
            tz_lo, tz_hi = self._z64_tape(player_keysz, omitz)
            if _os.environ.get("REVERIE_DEBUG"):
                # omitted-player tape lanes must be all-zero
                # (verifier/online.rs:141-160 debug invariant); one device
                # reduction per domain, turning a silent tape-builder
                # miscompile into a loud failure
                import jax.numpy as jnp

                bitmask = np.where(omit < 8, 1 << (7 - omit), 0).astype(np.uint8)
                _tplanes = tape2 if isinstance(tape2, tuple) else (tape2,)
                if any(int(jnp.any(jnp.asarray(t) & bitmask[None, :]))
                       for t in _tplanes):
                    raise AssertionError(
                        "REVERIE_DEBUG: gf2 tape is nonzero at the omitted "
                        "player's bit lane"
                    )
                oz = np.asarray(omitz)
                cols = np.nonzero(oz < 8)[0]
                if cols.size and tz_lo.shape[0]:
                    sel_lo = jnp.asarray(tz_lo)[:, oz[cols], cols]
                    sel_hi = jnp.asarray(tz_hi)[:, oz[cols], cols]
                    if int(jnp.any(sel_lo)) or int(jnp.any(sel_hi)):
                        raise AssertionError(
                            "REVERIE_DEBUG: z64 tape is nonzero at the "
                            "omitted player's lane"
                        )
            if profile:
                import jax

                jax.block_until_ready((tape2, tz_lo))
        with timer.phase("onl_exec"):
            inp = dict(tapez_lo=tz_lo, tapez_hi=tz_hi, **inj,
                       **self._tape2_inp(tape2))
            if self.mesh is not None:
                from ..parallel.mesh import shard_inputs

                inp = shard_inputs(self.mesh, inp)
            out = self._executor(VERIFY_ONL, Rop)(inp)
            if profile:
                import jax

                jax.block_until_ready(out)
        with timer.phase("onl_hash"):
            rep_h, _, _ = self._hash_fn(False)(
                out["onl2"], out["pre2"], out["onlz"], out["prez"]
            )
            # one fused device->host pull for hashes + fail flags; the pull
            # runs async UNDER the preprocessing leg's device compute below
            # (the two re-executions are independent until the final
            # commitment reorder)
            dbuf_onl = self._pull_hash_fail()(rep_h, out["fail"])
            try:
                dbuf_onl.copy_to_host_async()
            except AttributeError:
                pass

        # ---- preprocessing re-execution -----------------------------------
        Rp = params.preprocessing_reps
        Rpp = self._rep_pad(Rp)
        seeds2 = np.stack(
            [np.frombuffer(p.seed, dtype=np.uint8) for p in proof.gf2.preprocessing]
        )
        seedsz = np.stack(
            [np.frombuffer(p.seed, dtype=np.uint8) for p in proof.z64.preprocessing]
        )
        comm2 = np.stack(
            [np.frombuffer(p.comm_online, dtype=np.uint8) for p in proof.gf2.preprocessing]
        )
        commz = np.stack(
            [np.frombuffer(p.comm_online, dtype=np.uint8) for p in proof.z64.preprocessing]
        )
        if Rpp != Rp:
            pad = Rpp - Rp
            seeds2 = np.concatenate([seeds2, np.zeros((pad, KEY_SIZE), np.uint8)])
            seedsz = np.concatenate([seedsz, np.zeros((pad, KEY_SIZE), np.uint8)])
            comm2 = np.concatenate([comm2, np.zeros((pad, 32), np.uint8)])
            commz = np.concatenate([commz, np.zeros((pad, 32), np.uint8)])
        with timer.phase("pre_tape"):
            pk2 = expand_seeds(seeds2).reshape(Rpp, 8, KEY_SIZE)
            pkz = expand_seeds(seedsz).reshape(Rpp, 8, KEY_SIZE)
            tape2 = self._gf2_tape(pk2, None, split=self._use_tape_split)
            tz_lo, tz_hi = self._z64_tape(pkz, None)
        with timer.phase("pre_exec"):
            inp = dict(tapez_lo=tz_lo, tapez_hi=tz_hi,
                       **self._tape2_inp(tape2))
            if self.mesh is not None:
                from ..parallel.mesh import shard_inputs

                inp = shard_inputs(self.mesh, inp)
            out = self._executor(VERIFY_PRE, Rpp)(inp)
            if profile:
                import jax

                jax.block_until_ready(out)
        with timer.phase("pre_hash"):
            rep_h, _, _ = self._hash_fn(True)(
                out["onl2"], out["pre2"], out["onlz"], out["prez"], comm2, commz
            )

        try:
            rep_h.copy_to_host_async()
        except AttributeError:
            pass
        return dict(dbuf_onl=dbuf_onl, rep_h=rep_h, comm=proof.comm,
                    Ro=Ro, Rop=Rop, Rp=Rp, timer=timer, profile=profile)

    def _verify_finish(self, st, strict_zero_check: bool = True) -> bool:
        """Block on the hash pulls, reorder per the challenge, and compare
        the commitment."""
        params = self.params
        timer, profile = st["timer"], st["profile"]
        Ro, Rop, Rp = st["Ro"], st["Rop"], st["Rp"]
        with timer.phase("pulls"):
            buf = np.asarray(st["dbuf_onl"])
            # dummy pad lanes (zero keys/streams) compute garbage: slice to
            # the real online reps before the fail check
            hashes_online = buf[: Rop * 32].reshape(Rop, 32)[:Ro]  # (40, 32)
            if strict_zero_check and buf[Rop * 32 : Rop * 32 + Ro].any():
                return False
            hashes_pre = np.asarray(st["rep_h"])[:Rp]  # (216, 32)

        # ---- reorder + commitment check -----------------------------------
        open_map = challenge_to_opening(st["comm"], params)
        ordered = np.zeros((params.total_reps, 32), dtype=np.uint8)
        io_ = ip = 0
        for i in range(params.total_reps):
            if i in open_map:
                ordered[i] = hashes_online[io_]
                io_ += 1
            else:
                ordered[i] = hashes_pre[ip]
                ip += 1
        ok = blake3(ordered.tobytes()) == st["comm"]
        if profile:
            import sys as _sys

            print("verify phase breakdown:\n" + timer.report(), file=_sys.stderr)
        return ok
