"""Streaming segmented prover for beyond-HBM circuits (SURVEY §7 hard-part 5).

The reference holds the whole wire arena and all transcript streams in RAM
for the duration of a proof (interpreter/combine.rs SizeHint arena growth;
proof/mod.rs:118-196).  On a device the equivalent would pin O(circuit)
device memory; instead the op list is split into segments (circuit/compile.py:
compile_segments) and proved in two passes with O(segment) device memory:

  pass 1 (hash): execute segments in order, carrying the cross-segment live
    wires (mask/correction arena rows) on device; each segment's transcript
    stream bytes are absorbed into incremental per-rep BLAKE3 states
    (crypto/kernels/blake3_jax.py:ColumnHasher) and then discarded.  This
    yields the per-rep commitments -> Fiat-Shamir challenge, byte-identical
    to unsegmented proving.
  pass 2 (extract): re-execute every segment with the same carried state and
    pull only the opened repetitions' recon/corr/input bits, accumulating
    them on host; one final bit-pack produces the proof streams.

Re-execution trades ~1x extra compute for never materializing a full stream
(the alternative is spooling all streams to host memory over the
host-device link).  Each segment builds its gf2 and z64 tape windows with
the device AES when the window is large enough (the same rule as TpuKKW,
tpu_host.device_tape_eligible).  Segment executors are the regular
levelized Executors (backend/tpu.py) with carry_in/carry_out; uniform
segments share jit cache entries because gate tables are runtime inputs.

All op kinds stream: GF2, Z64, and B2A segments carry their domain's arena
rows (gf2 byte rows + z64 u32-pair rows) across segment boundaries.  With a
`mesh`, every segment executor additionally shards the repetition axis over
the device mesh (multi-chip streaming of beyond-HBM circuits).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..algebra import u64pair as up
from ..circuit.compile import Segment, compile_segments
from ..circuit.ir import CombineOp
from ..crypto import blake3, expand_seeds, keystream_batch
from ..params import DEFAULT_PARAMS, KEY_SIZE, ProtocolParams
from ..proof.challenge import challenge_to_opening
from ..proof.container import OpenOnline, OpenPreprocessing, Proof, ProofSingle
from .tpu import PROVER, VERIFY_ONL, VERIFY_PRE, Executor
from .tpu_host import (
    BATCH,
    GF2_BATCH_BYTES,
    GF2_DEVICE_MIN,
    Z64_BATCH_BYTES,
    Z64_DEVICE_MIN,
    _pack_bits_stream,
    _stack_streams,
    _u64s_from_stream,
    device_tape_eligible,
)

U64 = np.uint64


def _tape2_window_host(player_keys: np.ndarray, tape0: int, m2s: int) -> np.ndarray:
    """(m2s, R) GF2 tape rows [tape0, tape0+m2s) via host AES (small
    segments).  Layout identical to tpu_host.build_tapes."""
    R = player_keys.shape[0]
    if m2s == 0:
        return np.zeros((0, R), np.uint8)
    flat = player_keys.reshape(R * 8, KEY_SIZE)
    b0 = tape0 // BATCH
    b1 = (tape0 + m2s + BATCH - 1) // BATCH
    ks = keystream_batch(flat, (b1 - b0) * GF2_BATCH_BYTES, start_block=b0)
    ks = ks.reshape(R, 8, -1)
    bits = np.unpackbits(ks, axis=-1)  # (R, 8, (b1-b0)*128)
    off = tape0 - b0 * BATCH
    bits = bits[:, :, off : off + m2s]
    return np.packbits(bits.transpose(2, 0, 1), axis=-1)[..., 0]  # (m2s, R)


def _tapez_window_host(player_keys: np.ndarray, tapez0: int, mzs: int,
                       omit: Optional[np.ndarray] = None):
    """(mzs, 8, R) u32-pair z64 tape rows [tapez0, tapez0+mzs) via host AES.
    Layout identical to tpu_host.build_tapes (1 KiB per 128-word refill;
    player-major)."""
    R = player_keys.shape[0]
    if mzs == 0:
        z = np.zeros((0, 8, R), np.uint32)
        return z, z
    flat = player_keys.reshape(R * 8, KEY_SIZE)
    b0 = tapez0 // BATCH
    b1 = (tapez0 + mzs + BATCH - 1) // BATCH
    ks = keystream_batch(flat, (b1 - b0) * Z64_BATCH_BYTES,
                         start_block=b0 * (Z64_BATCH_BYTES // 16))
    ks = ks.reshape(R, 8, -1)
    if omit is not None:
        idx = np.nonzero(omit < 8)[0]
        ks[idx, omit[idx].astype(np.int64)] = 0
    words = np.ascontiguousarray(ks).view("<u8")  # (R, 8, (b1-b0)*128)
    off = tapez0 - b0 * BATCH
    words = np.transpose(words[:, :, off : off + mzs], (2, 1, 0))  # (mzs,8,R)
    return up.from_u64(words)


class StreamingKKW:
    """Segmented streaming prover.  Proof bytes are identical to
    TpuKKW.prove on the same seeds (tests/test_streaming.py)."""

    def __init__(self, program: Sequence[CombineOp], seg_ops: int,
                 params: ProtocolParams = DEFAULT_PARAMS, mesh=None):
        """`mesh`: optional jax.sharding.Mesh -- shards the repetition axis of
        every segment executor over the mesh devices (parallel/mesh.py), so a
        beyond-HBM circuit streams across a multi-chip slice: each device
        holds O(segment / n_devices) arena rows + tape windows + hash states.
        Proof bytes are unchanged (tests/test_streaming.py)."""
        self.params = params
        self.mesh = mesh
        self.segments: List[Segment] = compile_segments(program, seg_ops)
        self.m2 = sum(s.cc.m2 for s in self.segments)
        self.n_wit2 = sum(s.cc.n_wit2 for s in self.segments)
        self.onl_total = sum(s.cc.onl2 for s in self.segments)
        self.pre_total = sum(s.cc.pre2 for s in self.segments)
        self.rec_total = sum(s.cc.n_recons2 for s in self.segments)
        self.cor_total = sum(s.cc.n_corrs2 for s in self.segments)
        self.inp_total = sum(s.cc.n_inputs2 for s in self.segments)
        self.mz = sum(s.cc.mz for s in self.segments)
        self.n_witz = sum(s.cc.n_witz for s in self.segments)
        self.onlz_total = sum(s.cc.onlz for s in self.segments)
        self.prez_total = sum(s.cc.prez for s in self.segments)
        self.recz_total = sum(s.cc.n_reconsz for s in self.segments)
        self.corz_total = sum(s.cc.n_corrsz for s in self.segments)
        self.inpz_total = sum(s.cc.n_inputsz for s in self.segments)
        self._executors: Dict[int, Executor] = {}
        self._bitx: Dict[int, object] = {}

    # ------------------------------------------------------------------
    class _ScanThreshold:
        """Per-segment depth beyond which segments use the lax.scan executor.
        Resolves TpuKKW.SCAN_DEPTH_THRESHOLD at every read (works on the
        class or an instance), so segmented and unsegmented proving always
        pick executors consistently -- including under test monkeypatching
        of TpuKKW's attribute."""

        def __get__(self, obj, objtype=None) -> int:
            from .tpu_host import TpuKKW

            return TpuKKW.SCAN_DEPTH_THRESHOLD

    SCAN_DEPTH_THRESHOLD = _ScanThreshold()

    def _executor(self, s: int, mode: int, R: int) -> Executor:
        key = (s, mode, R)
        if key not in self._executors:
            seg = self.segments[s]
            kw = dict(
                total_reps=R, mesh=self.mesh,
                carry_in=len(seg.carry_in), carry_out_vals=seg.carry_out_vals,
                carry_inz=len(seg.carry_inz),
                carry_outz_vals=seg.carry_outz_vals,
            )
            if seg.cc.depth > self.SCAN_DEPTH_THRESHOLD:
                from .tpu_scan import ScanExecutor

                self._executors[key] = ScanExecutor(seg.cc, mode, **kw)
            else:
                self._executors[key] = Executor(seg.cc, mode, **kw)
        return self._executors[key]

    def _tape2_window(self, s: int, player_keys, omit: Optional[np.ndarray],
                      dev: dict):
        """(m2s, R) tape rows for segment s, on device when the window is
        large enough.  `omit` (verification): zero the omitted player's bit
        per rep column -- the device path encodes it in the lane mask, the
        host path applies a byte mask.  `dev` holds one pass's device round
        keys and lane mask, computed by the first window that needs them."""
        seg = self.segments[s]
        m2s = seg.cc.m2
        R = player_keys.shape[0]
        if not device_tape_eligible(m2s, R, GF2_DEVICE_MIN):
            rows = _tape2_window_host(player_keys, seg.tape0, m2s)
            if omit is not None:
                keep = (0xFF ^ (1 << (7 - omit))).astype(np.uint8)
                rows = rows & keep[None, :]
            return rows
        import jax
        import jax.numpy as jnp

        from ..crypto.kernels import aes_jax as aj

        if "rkp" not in dev:
            dev["rkp"] = aj.rkp_on_device(player_keys.reshape(-1, KEY_SIZE))
            dev["mask"] = jnp.asarray(
                np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32) if omit is None
                else aj.lane_mask_from_omit(omit, R))
        b0 = seg.tape0 // BATCH
        b1 = (seg.tape0 + m2s + BATCH - 1) // BATCH
        if "aes" not in self._bitx:
            # static block count, traced start: uniform segments share one
            # compile
            def _afn(rkp_, nb, start, mask_):
                return aj.aes_ctr_tape_gf2(
                    rkp_, aj.counter_planes_device(nb, start), mask_
                )

            self._bitx["aes"] = jax.jit(_afn, static_argnums=(1,))
        rows = self._bitx["aes"](dev["rkp"], b1 - b0, np.int32(b0),
                                 dev["mask"])
        off = seg.tape0 - b0 * BATCH
        return rows[off : off + m2s]

    def _bit_extractor(self, s: int):
        """Jitted fn: (onl2, pre2, shifts(R,), cols(K,)) -> flat u8 of the
        *packed* opened bit rows [recons | corrs | inputs], 8 bits/byte
        MSB-first per stream (host unpacks and re-aligns across segments;
        packing before the pull keeps the device-to-host transfer at proof size)."""
        if ("bx", s) not in self._bitx:
            import jax
            import jax.numpy as jnp

            from .tpu_host import _pack_rows_device

            cc = self.segments[s].cc
            rec = jnp.asarray(cc.recon_slots2.astype(np.int32))
            cor = jnp.asarray(cc.corr_slots2.astype(np.int32))
            inp = jnp.asarray(cc.input_slots2.astype(np.int32))

            def fn(onl2, pre2, shifts, cols):
                rb = (jnp.take(onl2, rec, axis=0) >> shifts[None, :]) & jnp.uint8(1)
                cb = jnp.take(pre2, cor, axis=0) & jnp.uint8(1)
                ib = jnp.take(onl2, inp, axis=0) & jnp.uint8(1)
                return jnp.concatenate(
                    [
                        _pack_rows_device(jnp.take(b, cols, axis=1)).reshape(-1)
                        for b in (rb, cb, ib)
                    ]
                )

            self._bitx[("bx", s)] = jax.jit(fn)
        return self._bitx[("bx", s)]

    def _z64_extractor(self, s: int):
        """Jitted per-segment z64 opened-stream extractor (the segment-local
        twin of tpu_host.make_z64_extractor; z64 events are byte-aligned so
        segment buffers concatenate directly into the global streams)."""
        key = ("bz", s)
        if key not in self._bitx:
            from .tpu_host import make_z64_extractor

            self._bitx[key] = make_z64_extractor(self.segments[s].cc)
        return self._bitx[key]

    def _onl_injector(self, nr: int, nc: int, ni: int):
        """Jitted fn: device-resident *packed* proof streams + static
        per-segment record counts + traced global bases -> the segment's
        VERIFY_ONL injection arrays (co2, in2, re2).  Uniform segments share
        one compile (bases are traced scalars)."""
        key = ("vinj", nr, nc, ni)
        if key not in self._bitx:
            import jax
            import jax.numpy as jnp

            def unpack(packed, base, n):
                R = packed.shape[1]
                if n == 0:
                    return jnp.zeros((0, R), jnp.uint8)
                p = base + jnp.arange(n, dtype=jnp.int32)
                by = jnp.take(packed, p >> 3, axis=0)
                sh = (jnp.uint8(7) - (p & 7).astype(jnp.uint8))[:, None]
                return (by >> sh) & jnp.uint8(1)

            def fn(co2p, in2p, re2p, shifts, cor0, inp0, rec0):
                return dict(
                    co2=unpack(co2p, cor0, nc),
                    in2=unpack(in2p, inp0, ni),
                    re2=unpack(re2p, rec0, nr) << shifts[None, :],
                )

            self._bitx[key] = jax.jit(fn)
        return self._bitx[key]

    def _tapez_window(self, s: int, player_keys,
                      omit: Optional[np.ndarray] = None):
        """Device/host (mzs, 8, R) u32-pair z64 tape rows for segment s."""
        import jax

        seg = self.segments[s]
        mzs = seg.cc.mz
        R = player_keys.shape[0]
        if not device_tape_eligible(mzs, R, Z64_DEVICE_MIN):
            return _tapez_window_host(player_keys, seg.tapez0, mzs, omit=omit)
        import jax.numpy as jnp

        from ..crypto.kernels import aes_jax as aj

        b0 = seg.tapez0 // BATCH
        b1 = (seg.tapez0 + mzs + BATCH - 1) // BATCH
        B = (b1 - b0) * (Z64_BATCH_BYTES // 16)
        if "aesz" not in self._bitx:
            # keys uploaded raw; round keys + counter planes expand on device
            # (static block count, traced start: uniform segments share one
            # compile and skip the per-segment ctrp/rkp transfers)
            def _zfn(keys, nb, start, mask):
                return aj.aes_ctr_tape_z64_chunked(
                    aj.round_key_planes_device(keys),
                    aj.counter_planes_device(nb, start),
                    mask,
                )

            self._bitx["aesz"] = jax.jit(_zfn, static_argnums=(1,))
        if omit is None:
            maskz = np.full(R * 8 // 32, 0xFFFFFFFF, np.uint32)
        else:
            maskz = aj.lane_mask_raw_pm(omit, R)
        lo, hi = self._bitx["aesz"](
            jnp.asarray(np.ascontiguousarray(
                player_keys.transpose(1, 0, 2)).reshape(-1, KEY_SIZE)), B,
            np.int32(b0 * (Z64_BATCH_BYTES // 16)), jnp.asarray(maskz)
        )
        off = seg.tapez0 - b0 * BATCH
        return lo[off : off + mzs], hi[off : off + mzs]

    # ------------------------------------------------------------------
    @staticmethod
    def _gather_carry(carry_src: List[tuple], carry_store: List[dict],
                      names: List[str], inp: dict) -> None:
        """Collect this segment's carry rows from the producing segments'
        carry outputs: one gather per source segment per array, then one
        inverse-perm take (device ops)."""
        import jax.numpy as jnp

        by_src: Dict[int, List[int]] = {}
        pos_order: List[int] = []
        for pos, (src, row) in enumerate(carry_src):
            by_src.setdefault(src, []).append(row)
        srcs = sorted(by_src)
        for src in srcs:
            pos_order.extend(
                p for p, (sv, _) in enumerate(carry_src) if sv == src
            )
        inv = np.empty(len(pos_order), np.int32)
        inv[np.asarray(pos_order, np.int32)] = np.arange(
            len(pos_order), dtype=np.int32
        )
        jinv = jnp.asarray(inv)
        for name in names:
            parts = [
                jnp.take(carry_store[src][name],
                         jnp.asarray(np.asarray(by_src[src], np.int32)), axis=0)
                for src in srcs
            ]
            inp[name] = jnp.take(jnp.concatenate(parts, axis=0), jinv, axis=0)

    _GF2_CARRY = ["carry_mask2", "carry_corr2"]
    _Z64_CARRY = ["carry_mzlo", "carry_mzhi", "carry_czlo", "carry_czhi"]

    def _run_segments(self, player_keys, wit2, on_out,
                      mode: int = PROVER, seg_inputs=None,
                      omit: Optional[np.ndarray] = None, witz=None,
                      player_keysz=None, omitz: Optional[np.ndarray] = None):
        """Execute all segments in order, calling on_out(s, out) per segment.
        Returns the final fail flags (R,) as a device array.  `seg_inputs`
        (verification): callable s -> dict of per-segment injection arrays.
        player_keysz/omitz: z64-domain keys (verification opens the two
        domains with their own seed lists; proving shares one set)."""
        R = player_keys.shape[0]
        if player_keysz is None:
            player_keysz, omitz = player_keys, omit
        carry_store: List[dict] = [None] * len(self.segments)
        dev: dict = {}
        fail = None
        for s, seg in enumerate(self.segments):
            cc = seg.cc
            inp = dict(
                tape2=self._tape2_window(s, player_keys, omit, dev),
            )
            if cc.mz:
                inp["tapez_lo"], inp["tapez_hi"] = self._tapez_window(
                    s, player_keysz, omit=omitz
                )
            else:
                inp["tapez_lo"] = np.zeros((0, 8, R), np.uint32)
                inp["tapez_hi"] = np.zeros((0, 8, R), np.uint32)
            if mode == PROVER:
                inp["wit2"] = np.ascontiguousarray(
                    np.broadcast_to(
                        wit2[seg.wit0 : seg.wit0 + cc.n_wit2, None],
                        (cc.n_wit2, R),
                    )
                )
                wz = witz[seg.witz0 : seg.witz0 + cc.n_witz] if cc.n_witz else \
                    np.zeros(0, np.uint64)
                wlo, whi = up.from_u64(
                    np.ascontiguousarray(
                        np.broadcast_to(wz[:, None], (cc.n_witz, R))
                    )
                )
                inp["witz_lo"], inp["witz_hi"] = wlo, whi
            else:
                inp["witz_lo"] = np.zeros((0, R), np.uint32)
                inp["witz_hi"] = np.zeros((0, R), np.uint32)
            if seg_inputs is not None:
                inp.update(seg_inputs(s))
            if self.mesh is not None:
                # shard the rep axis over the mesh (carry arrays join below
                # as executor outputs, already laid out by GSPMD)
                from ..parallel.mesh import shard_inputs

                inp = shard_inputs(self.mesh, inp)
            if seg.carry_in:
                self._gather_carry(seg.carry_src, carry_store,
                                   self._GF2_CARRY, inp)
            if seg.carry_inz:
                self._gather_carry(seg.carry_srcz, carry_store,
                                   self._Z64_CARRY, inp)
            out = self._executor(s, mode, R)(inp)
            if seg.carry_out or seg.carry_outz:
                carry_store[s] = {
                    k: out[k]
                    for k in self._GF2_CARRY + self._Z64_CARRY
                    if k in out
                }
            fail = out["fail"] if fail is None else (fail | out["fail"])
            on_out(s, out)
        return fail

    # ------------------------------------------------------------------
    def prove(self, wit_gf2, wit_z64=(), seeds: Optional[np.ndarray] = None) -> Proof:
        import jax.numpy as jnp

        from ..crypto.kernels.blake3_jax import ColumnHasher, hash_pair_columns
        from ..utils.profiling import PhaseTimer

        timer = PhaseTimer()
        profile = bool(os.environ.get("REVERIE_PROFILE"))
        params = self.params
        R = params.total_reps

        if seeds is None:
            seeds = np.frombuffer(
                os.urandom(R * KEY_SIZE), dtype=np.uint8
            ).reshape(R, KEY_SIZE)
        seeds = np.ascontiguousarray(seeds, dtype=np.uint8).reshape(R, KEY_SIZE)
        player_keys = expand_seeds(seeds).reshape(R, 8, KEY_SIZE)

        wit2 = np.asarray([1 if b else 0 for b in wit_gf2], dtype=np.uint8)
        witz = np.asarray([int(v) & 0xFFFFFFFFFFFFFFFF for v in wit_z64],
                          dtype=np.uint64)
        if len(wit2) < self.n_wit2 or len(witz) < self.n_witz:
            raise AssertionError("witness is too short")

        # ---- pass 1: execute + absorb + discard ---------------------------
        onl_h = ColumnHasher(self.onl_total, R)
        pre_h = ColumnHasher(self.pre_total, R)
        onlz_h = ColumnHasher(self.onlz_total, R)
        prez_h = ColumnHasher(self.prez_total, R)

        def absorb(s, out):
            cc = self.segments[s].cc
            if cc.onl2:
                onl_h.absorb(out["onl2"][: cc.onl2])
            if cc.pre2:
                pre_h.absorb(out["pre2"][: cc.pre2])
            if cc.onlz:
                onlz_h.absorb(out["onlz"][: cc.onlz])
            if cc.prez:
                prez_h.absorb(out["prez"][: cc.prez])

        with timer.phase("pass1"):
            fail = self._run_segments(player_keys, wit2, absorb, witz=witz)

        with timer.phase("hash_final"):
            ho2 = onl_h.finalize()
            hp2 = pre_h.finalize()
            hoz = onlz_h.finalize()
            hpz = prez_h.finalize()
            h2 = hash_pair_columns(hp2, ho2)
            hz = hash_pair_columns(hpz, hoz)
            rep_h = np.asarray(hash_pair_columns(h2, hz))
            ho2_np = np.asarray(ho2)
            hoz_np = np.asarray(hoz)
            if np.asarray(fail).any():
                raise AssertionError("witness is invalid (AssertZero failed)")

        with timer.phase("challenge"):
            comm = blake3(rep_h.tobytes())
        open_map = challenge_to_opening(comm, params)
        omit = np.full(R, 8, dtype=np.int64)
        for rep, p in open_map.items():
            omit[rep] = p
        cols = np.nonzero(omit < 8)[0]
        K = len(cols)
        shifts = np.zeros(R, dtype=np.uint8)
        shifts[cols] = (7 - omit[cols]).astype(np.uint8)
        jshifts = jnp.asarray(shifts)
        jcols = jnp.asarray(cols.astype(np.int32))

        # ---- pass 2: re-execute + pull opened bits ------------------------
        # Extraction buffers stay on device until all segments are enqueued
        # (a blocking per-segment pull would idle the device during each
        # transfer); one deferred pull per segment then drains the queue.
        dev_bufs: List[object] = [None] * len(self.segments)
        dev_bufsz: List[object] = [None] * len(self.segments)
        jomit = jnp.asarray(omit[cols].astype(np.int32))

        def extract(s, out):
            dev_bufs[s] = self._bit_extractor(s)(
                out["onl2"], out["pre2"], jshifts, jcols
            )
            cc = self.segments[s].cc
            if cc.n_reconsz or cc.n_corrsz or cc.n_inputsz:
                dev_bufsz[s] = self._z64_extractor(s)(
                    out["onlz"], out["prez"], jomit, jcols
                )

        rec_bits = np.zeros((K, self.rec_total), np.uint8)
        cor_bits = np.zeros((K, self.cor_total), np.uint8)
        inp_bits = np.zeros((K, self.inp_total), np.uint8)
        recz_b = np.zeros((K, self.recz_total * 8), np.uint8)
        corz_b = np.zeros((K, self.corz_total * 8), np.uint8)
        inpz_b = np.zeros((K, self.inpz_total * 8), np.uint8)

        with timer.phase("pass2"):
            self._run_segments(player_keys, wit2, extract, witz=witz)
            for s, seg in enumerate(self.segments):
                cc = seg.cc
                buf = np.asarray(dev_bufs[s])
                dev_bufs[s] = None
                o = 0
                for n, dest, base in (
                    (cc.n_recons2, rec_bits, seg.rec0),
                    (cc.n_corrs2, cor_bits, seg.cor0),
                    (cc.n_inputs2, inp_bits, seg.inp0),
                ):
                    nb = n // 8 + 1
                    packed = buf[o : o + nb * K].reshape(nb, K)
                    o += nb * K
                    # (K, n) destination rows are contiguous per rep column
                    dest[:, base : base + n] = np.unpackbits(
                        packed, axis=0, count=n
                    ).T
                if dev_bufsz[s] is not None:
                    bufz = np.asarray(dev_bufsz[s])
                    dev_bufsz[s] = None
                    o = 0
                    for n, dest, base in (
                        (cc.n_reconsz, recz_b, seg.recz0),
                        (cc.n_corrsz, corz_b, seg.corz0),
                        (cc.n_inputsz, inpz_b, seg.inpz0),
                    ):
                        nb = n * 8
                        dest[:, base * 8 : base * 8 + nb] = (
                            bufz[o : o + K * nb].reshape(K, nb)
                        )
                        o += K * nb

        # ---- assemble the proof (byte-identical to TpuKKW.prove) ----------
        with timer.phase("pack"):
            open2 = [
                (
                    _pack_bits_stream(rec_bits[j]),
                    _pack_bits_stream(cor_bits[j]),
                    _pack_bits_stream(inp_bits[j]),
                )
                for j in range(K)
            ]
        p2 = ProofSingle([], [])
        pz = ProofSingle([], [])
        j = 0
        for r in range(R):
            if omit[r] < 8:
                ks = player_keys[r].copy()
                ks[omit[r]] = 0
                rec, cor, inpt = open2[j]
                p2.online.append(OpenOnline(int(omit[r]), ks.tobytes(), rec, cor, inpt))
                pz.online.append(OpenOnline(
                    int(omit[r]), ks.tobytes(),
                    recz_b[j].tobytes(), corz_b[j].tobytes(), inpz_b[j].tobytes(),
                ))
                j += 1
            else:
                p2.preprocessing.append(
                    OpenPreprocessing(seeds[r].tobytes(), ho2_np[r].tobytes())
                )
                pz.preprocessing.append(
                    OpenPreprocessing(seeds[r].tobytes(), hoz_np[r].tobytes())
                )
        if profile:
            import sys as _sys

            print("streaming prove phase breakdown:\n" + timer.report(),
                  file=_sys.stderr)
        return Proof(comm, p2, pz)

    # ------------------------------------------------------------------
    def verify(self, proof: Proof, strict_zero_check: bool = True) -> bool:
        """Segmented verification with O(segment) device memory: the packed
        proof streams live on device once, each segment unpacks its own
        injection window; onl/pre transcript streams are absorbed into
        incremental blake3 states and discarded (same carry machinery as
        prove).  Accept/reject behavior matches TpuKKW.verify
        (tests/test_streaming.py)."""
        import jax.numpy as jnp

        from ..crypto.kernels.blake3_jax import ColumnHasher, hash_pair_columns
        from ..utils.profiling import PhaseTimer

        timer = PhaseTimer()
        profile = bool(os.environ.get("REVERIE_PROFILE"))
        params = self.params
        if not proof.gf2.check_format(params.online_reps, params.preprocessing_reps):
            return False
        if not proof.z64.check_format(params.online_reps, params.preprocessing_reps):
            return False

        # ---- online re-execution (all opened reps as one batch) -----------
        Ro = params.online_reps
        with timer.phase("onl_inject"):
            omit = np.array([o.omit for o in proof.gf2.online], dtype=np.int64)
            omitz = np.array([o.omit for o in proof.z64.online], dtype=np.int64)
            player_keys = np.stack([
                np.frombuffer(o.seeds, dtype=np.uint8).reshape(8, KEY_SIZE)
                for o in proof.gf2.online
            ])
            player_keysz = np.stack([
                np.frombuffer(o.seeds, dtype=np.uint8).reshape(8, KEY_SIZE)
                for o in proof.z64.online
            ])
            co2p = jnp.asarray(_stack_streams(
                [o.corrs for o in proof.gf2.online], self.cor_total // 8 + 1))
            in2p = jnp.asarray(_stack_streams(
                [o.inputs for o in proof.gf2.online], self.inp_total // 8 + 1))
            re2p = jnp.asarray(_stack_streams(
                [o.recons for o in proof.gf2.online], self.rec_total // 8 + 1))
            jshifts = jnp.asarray((7 - omit).astype(np.uint8))
            # z64 streams: u64 values on host (byte-aligned records; the z64
            # part of a proof is small next to the gf2 bit streams)
            coz = np.zeros((self.corz_total, Ro), dtype=np.uint64)
            inz = np.zeros((self.inpz_total, Ro), dtype=np.uint64)
            rezv = np.zeros((self.recz_total, Ro), dtype=np.uint64)
            for r, o in enumerate(proof.z64.online):
                coz[:, r] = _u64s_from_stream(o.corrs, self.corz_total)
                inz[:, r] = _u64s_from_stream(o.inputs, self.inpz_total)
                rezv[:, r] = _u64s_from_stream(o.recons, self.recz_total)
            coz_lo, coz_hi = up.from_u64(coz)
            inz_lo, inz_hi = up.from_u64(inz)
            rezv_lo, rezv_hi = up.from_u64(rezv)
            onehot = (np.arange(8)[:, None] == omitz[None, :]).astype(np.uint32)
            rez_lo = rezv_lo[:, None, :] * onehot[None, :, :]  # (n, 8, R)
            rez_hi = rezv_hi[:, None, :] * onehot[None, :, :]

        onl_h = ColumnHasher(self.onl_total, Ro)
        pre_h = ColumnHasher(self.pre_total, Ro)
        onlz_h = ColumnHasher(self.onlz_total, Ro)
        prez_h = ColumnHasher(self.prez_total, Ro)

        def inj(s):
            seg = self.segments[s]
            cc = seg.cc
            out = self._onl_injector(cc.n_recons2, cc.n_corrs2, cc.n_inputs2)(
                co2p, in2p, re2p, jshifts,
                np.int32(seg.cor0), np.int32(seg.inp0), np.int32(seg.rec0),
            )
            out = dict(out)
            out["coz_lo"] = coz_lo[seg.corz0 : seg.corz0 + cc.n_corrsz]
            out["coz_hi"] = coz_hi[seg.corz0 : seg.corz0 + cc.n_corrsz]
            out["inz_lo"] = inz_lo[seg.inpz0 : seg.inpz0 + cc.n_inputsz]
            out["inz_hi"] = inz_hi[seg.inpz0 : seg.inpz0 + cc.n_inputsz]
            out["rez_lo"] = rez_lo[seg.recz0 : seg.recz0 + cc.n_reconsz]
            out["rez_hi"] = rez_hi[seg.recz0 : seg.recz0 + cc.n_reconsz]
            return out

        def absorb(s, out):
            cc = self.segments[s].cc
            if cc.onl2:
                onl_h.absorb(out["onl2"][: cc.onl2])
            if cc.pre2:
                pre_h.absorb(out["pre2"][: cc.pre2])
            if cc.onlz:
                onlz_h.absorb(out["onlz"][: cc.onlz])
            if cc.prez:
                prez_h.absorb(out["prez"][: cc.prez])

        with timer.phase("onl_exec"):
            fail = self._run_segments(player_keys, None, absorb,
                                      mode=VERIFY_ONL, seg_inputs=inj,
                                      omit=omit, player_keysz=player_keysz,
                                      omitz=omitz)
        with timer.phase("onl_hash"):
            ho2 = onl_h.finalize()
            hp2 = pre_h.finalize()
            h2 = hash_pair_columns(hp2, ho2)
            hz = hash_pair_columns(prez_h.finalize(), onlz_h.finalize())
            hashes_online = np.asarray(hash_pair_columns(h2, hz))
            if strict_zero_check and np.asarray(fail).any():
                return False

        # ---- preprocessing re-execution ------------------------------------
        Rp = params.preprocessing_reps
        with timer.phase("pre_tape"):
            seeds2 = np.stack([
                np.frombuffer(p.seed, dtype=np.uint8)
                for p in proof.gf2.preprocessing
            ])
            seedsz = np.stack([
                np.frombuffer(p.seed, dtype=np.uint8)
                for p in proof.z64.preprocessing
            ])
            comm2 = np.stack([
                np.frombuffer(p.comm_online, dtype=np.uint8)
                for p in proof.gf2.preprocessing
            ])
            commz = np.stack([
                np.frombuffer(p.comm_online, dtype=np.uint8)
                for p in proof.z64.preprocessing
            ])
            pk2 = expand_seeds(seeds2).reshape(Rp, 8, KEY_SIZE)
            pkz = expand_seeds(seedsz).reshape(Rp, 8, KEY_SIZE)

        pre_hp = ColumnHasher(self.pre_total, Rp)
        prez_hp = ColumnHasher(self.prez_total, Rp)

        def absorb_pre(s, out):
            cc = self.segments[s].cc
            if cc.pre2:
                pre_hp.absorb(out["pre2"][: cc.pre2])
            if cc.prez:
                prez_hp.absorb(out["prez"][: cc.prez])

        with timer.phase("pre_exec"):
            self._run_segments(pk2, None, absorb_pre,
                               mode=VERIFY_PRE, player_keysz=pkz, omitz=None)
        with timer.phase("pre_hash"):
            hp2p = pre_hp.finalize()
            h2 = hash_pair_columns(hp2p, jnp.asarray(comm2))
            hz = hash_pair_columns(prez_hp.finalize(), jnp.asarray(commz))
            hashes_pre = np.asarray(hash_pair_columns(h2, hz))

        # ---- reorder + commitment check ------------------------------------
        open_map = challenge_to_opening(proof.comm, params)
        ordered = np.zeros((params.total_reps, 32), dtype=np.uint8)
        io_ = ip = 0
        for i in range(params.total_reps):
            if i in open_map:
                ordered[i] = hashes_online[io_]
                io_ += 1
            else:
                ordered[i] = hashes_pre[ip]
                ip += 1
        ok = blake3(ordered.tobytes()) == proof.comm
        if profile:
            import sys as _sys

            print("streaming verify phase breakdown:\n" + timer.report(),
                  file=_sys.stderr)
        return ok
