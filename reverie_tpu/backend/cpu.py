"""CPU golden backend: gate-at-a-time KKW execution, vectorized over groups.

This is the bit-exact executable specification of the protocol -- the role of
the reference's transcript + interpreter layers (src/transcript/*,
src/interpreter/*) -- used as the truth oracle for the device backend and for
proof (de)serialization.  Where the reference packs 8 reps x 8 players into
one u64 and loops groups under rayon (proof/mod.rs:127-128), this backend
carries a leading group axis G through every array, executing all groups of a
role at once.

Roles (reference transcript/mod.rs:15-97):
  PROVER      -- records recons/corrs/inputs, computes both hashes
  VERIFY_ONL  -- rebuilds 7-player execution, streams from the proof
  VERIFY_PRE  -- all-8-player re-execution, preprocessing hash only
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from ..algebra import gf2, z64
from ..circuit.ir import CombineOp, Gate, Kind, Op
from ..crypto import blake3_many, expand_seeds, keystream_batch

U64 = np.uint64

PROVER = 0
VERIFY_ONL = 1
VERIFY_PRE = 2

GF2_BATCH_BYTES = 16  # gf2 batch refill: 128 shares = 16 keystream bytes
Z64_BATCH_BYTES = 1024  # z64 batch refill: 128 shares = 1KiB keystream
BATCH = 128


# ---------------------------------------------------------------------------
# Mask / event counting (compile-time prescan)
# ---------------------------------------------------------------------------


def count_masks(program: Sequence[CombineOp]) -> tuple:
    """Number of ShareGen.next() calls per domain over one execution."""
    m2 = mz = 0
    for op in program:
        if op.kind == Kind.GF2:
            o = op.gate.op
            if o in (Op.INPUT, Op.RANDOM):
                m2 += 1
            elif o == Op.MUL:
                m2 += 2
        elif op.kind == Kind.Z64:
            o = op.gate.op
            if o in (Op.INPUT, Op.RANDOM):
                mz += 1
            elif o == Op.MUL:
                mz += 2
        elif op.kind == Kind.B2A:
            # 64 fresh bit masks + 63 AND gates x 2 masks (combine.rs:132-219)
            m2 += 64 + 63 * 2
            mz += 1
    return m2, mz


# ---------------------------------------------------------------------------
# Tapes
# ---------------------------------------------------------------------------


def make_tapes(player_keys: np.ndarray, omit: Optional[np.ndarray], m2: int, mz: int):
    """player_keys: (G, 8reps, 8players, 16) uint8; omit: (G, 8) int or None.

    Returns (tape_gf2 (m2, G) u64, tape_z64 (mz, G, 8, 8) u64).  An omitted
    player's keystream is all-zero (generator/batch.rs:30-40).
    """
    G = player_keys.shape[0]
    flat = player_keys.reshape(G * 64, 16)
    omit_mask = None
    if omit is not None:
        # (G, 8reps, 8players) bool
        omit_mask = omit[..., None] == np.arange(8)[None, None, :]

    tape2 = np.zeros((m2, G), dtype=U64)
    if m2:
        n2 = ((m2 + BATCH - 1) // BATCH) * GF2_BATCH_BYTES
        ks2 = keystream_batch(flat, n2).reshape(G, 8, 8, n2)
        if omit_mask is not None:
            ks2[omit_mask] = 0
        tape2 = gf2.gf2_tape_from_keystreams(ks2, m2)

    tapez = np.zeros((mz, G, 8, 8), dtype=U64)
    if mz:
        nz = ((mz + BATCH - 1) // BATCH) * Z64_BATCH_BYTES
        ksz = keystream_batch(flat, nz).reshape(G, 8, 8, nz)
        if omit_mask is not None:
            ksz[omit_mask] = 0
        tapez = z64.z64_tape_from_keystreams(ksz, mz)
    return tape2, tapez


# ---------------------------------------------------------------------------
# Transcripts
# ---------------------------------------------------------------------------


class _StreamReader:
    """Lenient stream: reads past the end yield zeros (the reference's
    `.next().unwrap_or_default()`, verifier/online.rs:124,163,171)."""

    def __init__(self, data: np.ndarray, zero_shape):
        self.data = data
        self.idx = 0
        self.zero = np.zeros(zero_shape, dtype=U64)

    def next(self) -> np.ndarray:
        if self.data is not None and self.idx < len(self.data):
            out = self.data[self.idx]
        else:
            out = self.zero
        self.idx += 1
        return out


class Transcript:
    """One domain's transcript for G parallel groups."""

    def __init__(self, domain: str, mode: int, G: int, tape: np.ndarray, witness=None):
        assert domain in ("gf2", "z64")
        self.domain = domain
        self.mode = mode
        self.G = G
        self.tape = tape
        self.tape_pos = 0
        self.witness = witness  # iterator of scalars (bool / int)
        self.online_events: List[np.ndarray] = []  # each (G, 8, k) uint8
        self.pre_events: List[np.ndarray] = []
        # prover recordings
        self.recons: List[np.ndarray] = []
        self.corrs: List[np.ndarray] = []
        self.inputs: List[np.ndarray] = []
        # verifier-online provided streams
        self.r_recons: Optional[_StreamReader] = None
        self.r_corrs: Optional[_StreamReader] = None
        self.r_inputs: Optional[_StreamReader] = None
        self.okay = np.ones(() if domain == "gf2" else (), dtype=bool)
        self.zero_failures: List[np.ndarray] = []
        # verifier-preprocess provided online commitment: (G, 8, 32) uint8
        self.comm_online: Optional[np.ndarray] = None
        # REVERIE_DEBUG verifier invariants (verifier/online.rs:141-160):
        # set_debug_omit installs the omitted-player map; every reconstruct
        # then asserts the regenerated share is zero at the omitted player
        # and the proof-supplied missing share lives ONLY there.
        self._omit_mask = None  # gf2: (G,) u64 bitmask; z64: (G, 8) bool

    def set_debug_omit(self, omit: np.ndarray) -> None:
        """omit: (G, 8) per-(group, rep) omitted player (0..7).  Enables the
        debug omitted-share-zero checks in VERIFY_ONL reconstructs."""
        if not os.environ.get("REVERIE_DEBUG") or self.mode != VERIFY_ONL:
            return
        omit = np.asarray(omit, dtype=np.int64)
        if self.domain == "gf2":
            # share bit layout: (7-rep)*8 + (7-player) (gf2/share.rs:23-24)
            G = omit.shape[0]
            m = np.zeros(G, dtype=U64)
            for g in range(G):
                acc = 0
                for r in range(8):
                    p = int(omit[g, r])
                    if p < 8:
                        acc |= 1 << ((7 - r) * 8 + (7 - p))
                m[g] = acc
            self._omit_mask = m
        else:
            self._omit_mask = omit  # (G, 8) player index per rep

    def _debug_omit_check(self, mask: np.ndarray, msg: np.ndarray) -> None:
        if self._omit_mask is None:
            return
        if self.domain == "gf2":
            if np.any(mask & self._omit_mask):
                raise AssertionError(
                    "REVERIE_DEBUG: regenerated gf2 share is nonzero at the "
                    "omitted player (tape build violated the omit mask)"
                )
            if np.any(msg & ~self._omit_mask):
                raise AssertionError(
                    "REVERIE_DEBUG: injected gf2 missing-share has bits "
                    "outside the omitted player's positions"
                )
        else:
            omit = self._omit_mask  # (G, 8) player per rep
            G = omit.shape[0]
            for g in range(G):
                for r in range(8):
                    p = int(omit[g, r])
                    if p >= 8:
                        continue
                    if np.any(mask[g, r, p]):
                        raise AssertionError(
                            "REVERIE_DEBUG: regenerated z64 share is nonzero "
                            "at the omitted player"
                        )
                    others = [q for q in range(8) if q != p]
                    if np.any(msg[g, r, others]):
                        raise AssertionError(
                            "REVERIE_DEBUG: injected z64 missing-share has "
                            "values outside the omitted player"
                        )

    # -- domain helpers -----------------------------------------------------
    def _alg(self):
        return gf2 if self.domain == "gf2" else z64

    def _share_bytes(self, s: np.ndarray) -> np.ndarray:
        if self.domain == "gf2":
            return gf2.rep_bytes(s)[..., None]  # (G, 8, 1)
        return z64.share_hash_bytes(s)  # (G, 8, 64)

    def _recon_bytes(self, r: np.ndarray) -> np.ndarray:
        if self.domain == "gf2":
            return gf2.rep_bytes(r)[..., None]
        return z64.recon_hash_bytes(r)

    def _reconstruct(self, s):
        return self._alg().reconstruct(s)

    # -- protocol API (mirrors Transcript trait, transcript/mod.rs:15-97) ---
    def new_mask(self) -> np.ndarray:
        m = self.tape[self.tape_pos]
        self.tape_pos += 1
        return m

    def input_wire(self):
        if self.mode == PROVER:
            mask = self.new_mask()
            lam = self._reconstruct(mask)
            w = next(self.witness)
            if self.domain == "gf2":
                wit = gf2.recon_from_bool(w)
                corr = gf2.recon_sub(np.full(self.G, wit, dtype=U64), lam)
            else:
                wit = z64.recon_from_u64(w, self.G)
                corr = z64.recon_sub(wit, lam)
            self.online_events.append(self._recon_bytes(corr))
            self.inputs.append(corr)
            return mask, corr
        if self.mode == VERIFY_ONL:
            corr = self.r_inputs.next()
            self.online_events.append(self._recon_bytes(corr))
            return self.new_mask(), corr
        # VERIFY_PRE: corr is junk zero (verifier/preprocess.rs:47-53)
        mask = self.new_mask()
        if self.domain == "gf2":
            corr = np.zeros(self.G, dtype=U64)
        else:
            corr = np.zeros((self.G, 8), dtype=U64)
        return mask, corr

    def reconstruct(self, mask: np.ndarray) -> np.ndarray:
        if self.mode == PROVER:
            self.online_events.append(self._share_bytes(mask))
            self.recons.append(mask)
            return self._reconstruct(mask)
        if self.mode == VERIFY_ONL:
            msg = self.r_recons.next()
            self._debug_omit_check(mask, msg)
            full = self._alg().share_add(mask, msg)
            self.online_events.append(self._share_bytes(full))
            return self._reconstruct(full)
        # VERIFY_PRE: junk zero, no hashing (verifier/preprocess.rs:63-65)
        if self.domain == "gf2":
            return np.zeros(self.G, dtype=U64)
        return np.zeros((self.G, 8), dtype=U64)

    def correction(self, corr: np.ndarray) -> np.ndarray:
        if self.mode == VERIFY_ONL:
            corr = self.r_corrs.next()
        self.pre_events.append(self._recon_bytes(corr))
        if self.mode == PROVER:
            self.corrs.append(corr)
        return corr

    def zero_check(self, recon: np.ndarray) -> None:
        if self.mode == PROVER:
            if np.any(recon != 0):
                raise AssertionError(
                    f"witness is invalid: {self.domain} AssertZero wire is nonzero"
                )
        elif self.mode == VERIFY_ONL:
            # reference tracks `okay` but never consults it (caveat; see
            # SURVEY.md section 5 item 1) -- we record it for strict mode.
            self.zero_failures.append(recon != 0)

    # -- finalize ------------------------------------------------------------
    def _finalize_stream(self, events: List[np.ndarray]) -> np.ndarray:
        if not events:
            return np.zeros((self.G * 8, 0), dtype=np.uint8)
        cat = np.concatenate([e.reshape(self.G, 8, -1) for e in events], axis=-1)
        return cat.reshape(self.G * 8, -1)

    def online_hash(self) -> np.ndarray:
        """(G, 8, 32) per-rep blake3 of the online stream."""
        if self.mode == VERIFY_PRE:
            return self.comm_online
        h = blake3_many(self._finalize_stream(self.online_events))
        return h.reshape(self.G, 8, 32)

    def preprocess_hash(self) -> np.ndarray:
        h = blake3_many(self._finalize_stream(self.pre_events))
        return h.reshape(self.G, 8, 32)

    def rep_hash(self) -> np.ndarray:
        """H(preprocess || online) per rep (transcript/mod.rs:77-96)."""
        pre = self.preprocess_hash().reshape(self.G * 8, 32)
        onl = self.online_hash().reshape(self.G * 8, 32)
        return blake3_many(np.concatenate([pre, onl], axis=-1)).reshape(self.G, 8, 32)


# ---------------------------------------------------------------------------
# Interpreter (reference src/interpreter/{single,combine}.rs)
# ---------------------------------------------------------------------------


class Instance:
    """Wire arena + gate dispatch for one domain, G groups at once.

    With REVERIE_DEBUG set, prover execution carries the cleartext value of
    every wire alongside its shares and asserts per-gate equality between the
    MPC result and the cleartext gate semantics -- the runtime analog of the
    reference's debug-only `Wire::value()` checks (interpreter/mod.rs:16-20).
    """

    def __init__(self, domain: str, t: Transcript, cells: int):
        self.domain = domain
        self.t = t
        self.debug = bool(os.environ.get("REVERIE_DEBUG")) and t.mode == PROVER
        G = t.G
        if domain == "gf2":
            self.mask = np.zeros((cells, G), dtype=U64)
            self.corr = np.zeros((cells, G), dtype=U64)
        else:
            self.mask = np.zeros((cells, G, 8, 8), dtype=U64)
            self.corr = np.zeros((cells, G, 8), dtype=U64)

    def _value(self, idx) -> np.ndarray:
        """Cleartext wire value: reconstruct(mask) + corr (Wire::value())."""
        a = self._alg()
        return a.recon_add(a.reconstruct(self.mask[idx]), self.corr[idx])

    def _debug_check(self, g: Gate, expect: Optional[np.ndarray]) -> None:
        got = self._value(g.dst)
        if expect is not None and np.any(got != expect):
            raise AssertionError(
                f"REVERIE_DEBUG: {self.domain} {g.op.name} gate at wire "
                f"{g.dst}: MPC value diverges from cleartext semantics"
            )
        if g.op == Op.INPUT:
            # honest execution: every repetition carries the same witness
            if self.domain == "gf2":
                full = U64(0xFFFFFFFFFFFFFFFF)
                if np.any((got != 0) & (got != full)):
                    raise AssertionError(
                        f"REVERIE_DEBUG: gf2 INPUT wire {g.dst}: repetitions disagree"
                    )
            elif np.any(got != got[..., :1]):
                raise AssertionError(
                    f"REVERIE_DEBUG: z64 INPUT wire {g.dst}: repetitions disagree"
                )

    def _grow(self, cells: int) -> None:
        if cells > len(self.mask):
            extra = cells - len(self.mask)
            self.mask = np.concatenate(
                [self.mask, np.zeros((extra,) + self.mask.shape[1:], dtype=U64)]
            )
            self.corr = np.concatenate(
                [self.corr, np.zeros((extra,) + self.corr.shape[1:], dtype=U64)]
            )

    def op_mul(self, m1, c1, m2, c2):
        """The core KKW multiplication gate (single.rs:25-69)."""
        a = self._alg()
        t = self.t
        mask_ab = t.new_mask()
        mask_new = t.new_mask()
        ra = t._reconstruct(m1)
        rb = t._reconstruct(m2)
        rc = t._reconstruct(mask_ab)
        delta = t.correction(a.recon_sub(a.recon_mul(ra, rb), rc))
        s = a.share_sub(
            a.share_add(a.share_add(a.share_mul_recon(m2, c1), a.share_mul_recon(m1, c2)), mask_ab),
            mask_new,
        )
        recon = a.recon_add(t.reconstruct(s), delta)
        return mask_new, a.recon_add(recon, a.recon_mul(c1, c2))

    def _alg(self):
        return gf2 if self.domain == "gf2" else z64

    def _const_recon(self, val):
        if self.domain == "gf2":
            return np.full(self.t.G, gf2.recon_from_bool(val & 1), dtype=U64)
        return z64.recon_from_u64(val, self.t.G)

    def step(self, g: Gate) -> None:
        a = self._alg()
        op = g.op
        if self.debug:
            self._step_checked(g)
            return
        self._step(g)

    def _step_checked(self, g: Gate) -> None:
        """Debug-mode step: capture source cleartext values before the gate
        (dst may alias a source), execute, then assert the MPC output equals
        the cleartext gate semantics."""
        a = self._alg()
        op = g.op
        v1 = self._value(g.src1) if op not in (Op.INPUT, Op.RANDOM, Op.CONST) else None
        v2 = self._value(g.src2) if op in (Op.ADD, Op.SUB, Op.MUL) else None
        self._step(g)
        if op == Op.ADD:
            expect = a.recon_add(v1, v2)
        elif op == Op.SUB:
            expect = a.recon_sub(v1, v2)
        elif op == Op.MUL:
            expect = a.recon_mul(v1, v2)
        elif op == Op.ADDC:
            expect = a.recon_add(v1, self._const_recon(g.const))
        elif op == Op.SUBC:
            expect = a.recon_sub(v1, self._const_recon(g.const))
        elif op == Op.MULC:
            expect = a.recon_mul(v1, self._const_recon(g.const))
        elif op == Op.CONST:
            expect = self._const_recon(g.const)
        elif op == Op.INPUT:
            expect = None  # INPUT consistency handled in _debug_check
        else:
            return  # RANDOM / ASSERT_ZERO: no dst value to check
        self._debug_check(g, expect)

    def _step(self, g: Gate) -> None:
        a = self._alg()
        op = g.op
        if op == Op.INPUT:
            m, c = self.t.input_wire()
            self.mask[g.dst], self.corr[g.dst] = m, c
        elif op == Op.ADD:
            self.mask[g.dst] = a.share_add(self.mask[g.src1], self.mask[g.src2])
            self.corr[g.dst] = a.recon_add(self.corr[g.src1], self.corr[g.src2])
        elif op == Op.SUB:
            self.mask[g.dst] = a.share_sub(self.mask[g.src1], self.mask[g.src2])
            self.corr[g.dst] = a.recon_sub(self.corr[g.src1], self.corr[g.src2])
        elif op == Op.MUL:
            m, c = self.op_mul(
                self.mask[g.src1], self.corr[g.src1], self.mask[g.src2], self.corr[g.src2]
            )
            self.mask[g.dst], self.corr[g.dst] = m, c
        elif op == Op.ADDC:
            self.mask[g.dst] = self.mask[g.src1]
            self.corr[g.dst] = a.recon_add(self.corr[g.src1], self._const_recon(g.const))
        elif op == Op.SUBC:
            self.mask[g.dst] = self.mask[g.src1]
            self.corr[g.dst] = a.recon_sub(self.corr[g.src1], self._const_recon(g.const))
        elif op == Op.MULC:
            cr = self._const_recon(g.const)
            self.mask[g.dst] = a.share_mul_recon(self.mask[g.src1], cr)
            self.corr[g.dst] = a.recon_mul(self.corr[g.src1], cr)
        elif op == Op.ASSERT_ZERO:
            m = self.t.reconstruct(self.mask[g.src1])
            self.t.zero_check(a.recon_add(self.corr[g.src1], m))
        elif op == Op.RANDOM:
            self.mask[g.dst] = self.t.new_mask()
            self.corr[g.dst] = (
                np.zeros(self.t.G, dtype=U64)
                if self.domain == "gf2"
                else np.zeros((self.t.G, 8), dtype=U64)
            )
        elif op == Op.CONST:
            self.mask[g.dst] = (
                np.zeros(self.t.G, dtype=U64)
                if self.domain == "gf2"
                else np.zeros((self.t.G, 8, 8), dtype=U64)
            )
            self.corr[g.dst] = self._const_recon(g.const)
        else:
            raise ValueError(f"bad opcode {op}")


def _recon_gf2_wires_to_z64(masks: np.ndarray, corrs: np.ndarray) -> np.ndarray:
    """64 gf2 wires -> (G, 8) u64, bit i = wire i (combine.rs:19-36)."""
    # masks: (64, G); corrs: (64, G)
    bits = (gf2.rep_bytes(gf2.recon_add(gf2.reconstruct(masks), corrs)) & 1).astype(U64)
    # bits: (64, G, 8reps); compose little-endian over wire axis
    weights = (U64(1) << np.arange(64, dtype=U64))[:, None, None]
    return (bits * weights).sum(axis=0, dtype=U64)


class CombineInstance:
    """GF2 + Z64 instances in lockstep with B2A (combine.rs:14-222)."""

    def __init__(self, i2: Instance, iz: Instance):
        self.gf2 = i2
        self.z64 = iz

    def step(self, op: CombineOp) -> None:
        if op.kind == Kind.GF2:
            self.gf2.step(op.gate)
        elif op.kind == Kind.Z64:
            self.z64.step(op.gate)
        elif op.kind == Kind.SIZE_HINT:
            self.z64._grow(op.a)
            self.gf2._grow(op.b)
        elif op.kind == Kind.B2A:
            self._b2a(op.a, op.b)

    def _b2a(self, dst: int, src: int) -> None:
        t2, tz = self.gf2.t, self.z64.t
        G = t2.G
        # 64 fresh gf2 bit masks (corr = 0)
        a_masks = np.stack([t2.new_mask() for _ in range(64)])  # (64, G)
        a_corrs = np.zeros((64, G), dtype=U64)
        z64_value = _recon_gf2_wires_to_z64(a_masks, a_corrs)  # direct reconstruct

        # share the same value in z64 via a correction
        z_mask = tz.new_mask()
        z_corr = tz.correction(z64.recon_sub(z64_value, z64.reconstruct(z_mask)))

        # 64-bit ripple-carry addition in gf2 (combine.rs:39-93)
        b_masks = self.gf2.mask[src : src + 64]
        b_corrs = self.gf2.corr[src : src + 64]
        res_m = np.zeros((64, G), dtype=U64)
        res_c = np.zeros((64, G), dtype=U64)
        carry_m, carry_c = self.gf2.op_mul(a_masks[0], a_corrs[0], b_masks[0], b_corrs[0])
        res_m[0] = gf2.share_add(a_masks[0], b_masks[0])
        res_c[0] = gf2.recon_add(a_corrs[0], b_corrs[0])
        for i in range(1, 63):
            ac_m = gf2.share_add(a_masks[i], carry_m)
            ac_c = gf2.recon_add(a_corrs[i], carry_c)
            bc_m = gf2.share_add(b_masks[i], carry_m)
            bc_c = gf2.recon_add(b_corrs[i], carry_c)
            and_m, and_c = self.gf2.op_mul(ac_m, ac_c, bc_m, bc_c)
            res_m[i] = gf2.share_add(ac_m, b_masks[i])
            res_c[i] = gf2.recon_add(ac_c, b_corrs[i])
            carry_m = gf2.share_add(and_m, carry_m)
            carry_c = gf2.recon_add(and_c, carry_c)
        res_m[63] = gf2.share_add(carry_m, gf2.share_add(a_masks[63], b_masks[63]))
        res_c[63] = gf2.recon_add(carry_c, gf2.recon_add(a_corrs[63], b_corrs[63]))

        # reconstruct the 64 result bits via the transcript (online events)
        bits = np.zeros((64, G), dtype=U64)
        for i in range(64):
            bits[i] = gf2.recon_add(t2.reconstruct(res_m[i]), res_c[i])
        bvals = (gf2.rep_bytes(bits) & 1).astype(U64)  # (64, G, 8)
        weights = (U64(1) << np.arange(64, dtype=U64))[:, None, None]
        z64_recon = (bvals * weights).sum(axis=0, dtype=U64)  # (G, 8)

        # dst = sum - r  (combine.rs:200-204)
        self.z64._grow(dst + 1)
        self.z64.mask[dst] = z64.share_neg(z_mask)
        self.z64.corr[dst] = z64.recon_sub(z64_recon, z_corr)

    def rep_hash(self) -> np.ndarray:
        """Combined per-rep hash H(gf2_i || z64_i) (combine.rs:104-118)."""
        h2 = self.gf2.t.rep_hash().reshape(-1, 32)
        hz = self.z64.t.rep_hash().reshape(-1, 32)
        G = self.gf2.t.G
        return blake3_many(np.concatenate([h2, hz], axis=-1)).reshape(G, 8, 32)


def execute(
    program: Sequence[CombineOp],
    t2: Transcript,
    tz: Transcript,
    wire_counts: tuple,
) -> CombineInstance:
    z64_count, gf2_count = wire_counts
    ins = CombineInstance(
        Instance("gf2", t2, gf2_count), Instance("z64", tz, z64_count)
    )
    for op in program:
        ins.step(op)
    return ins
