"""Device backend: levelized batched KKW execution in JAX/XLA.

Where the reference packs 8 reps x 8 players into one u64 and walks gates one
at a time (src/algebra/gf2/share.rs:13-15, src/interpreter/single.rs), this
backend executes every gate as a vector op over ALL repetitions at once:

  gf2 mask arena  : (V, R) uint8 -- byte r = 8 player bits of rep r
                    (bit 7-p = player p, matching the reference byte layout)
  gf2 corr arena  : (V, R) uint8 -- 0/1 per rep (LSB form; expanded to
                    0x00/0xFF only at transcript-byte emission)
  z64 mask arena  : (V, 8, R) uint32 pairs (lo, hi) -- player-major u64
                    shares (reps on vector lanes; the 8-wide player axis
                    never touches the lane dim)
  z64 corr arena  : (V, R) uint32 pairs

R = total repetitions (256).  The transcript is materialized as byte tensors
(stream_len, R) whose rows are scattered at compile-time-assigned offsets, so
per-rep columns are byte-identical to the reference's sequential hasher
absorption; hashing the columns then yields identical commitments.

Execution is one jit-traced program: a Python-unrolled loop over levels, each
level a handful of gather -> vector-op -> scatter steps batched over that
level's gates x all reps.  Gate index tables are passed as runtime inputs
(not trace constants): million-gate circuits would otherwise embed
megabytes of constants into the HLO and blow up compilation.
"""

from __future__ import annotations

import os
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..algebra import u64pair as up
from ..circuit.compile import (
    B2A_CORR,
    B2A_OUT,
    G_ADD,
    G_ADDC,
    G_ASSERT,
    G_CONST,
    G_INPUT,
    G_MUL,
    G_MULC,
    G_RANDOM,
    G_SUBC,
    GF2,
    N_KINDS,
    Z_SUB,
    CompiledCircuit,
)

U8 = jnp.uint8
U32 = jnp.uint32

PROVER = 0
VERIFY_ONL = 1
VERIFY_PRE = 2

#: restore the barrier ahead of every arena write (see _Acc.put)
_FULL_BARRIER = bool(os.environ.get("REVERIE_FULL_BARRIER"))

#: disable dead-value elimination (arena writes of never-read values)
_NO_DVE = bool(os.environ.get("REVERIE_NO_DVE"))


def _parity8(x):
    t = x ^ (x >> 4)
    t = t ^ (t >> 2)
    t = t ^ (t >> 1)
    return t & jnp.asarray(1, U8)


def _expand(c):
    """0/1 uint8 -> 0x00/0xFF (recon hash byte form)."""
    return jnp.zeros_like(c) - c


def _scat(buf, rows, vals):
    # Miscompile workaround, kept until the GPU shows byte identity without
    # it (ROADMAP Design 4): the optimization_barrier stops XLA from fusing
    # the producing expression into the scatter.  The compiler this code
    # was first written for miscompiled certain gather+bitops+scatter
    # fusions (found by differential test against the golden backend).
    vals = jax.lax.optimization_barrier(vals)
    return buf.at[rows].set(vals)


def _recon_sum(lo, hi):
    """Sum u64 pairs over the player axis: (k, 8, R) -> (k, R)."""
    alo, ahi = lo[..., 0, :], hi[..., 0, :]
    for p in range(1, lo.shape[-2]):
        alo, ahi = up.add64(alo, ahi, lo[..., p, :], hi[..., p, :])
    return alo, ahi


def carry_arena(n_vals: int, R: int, carried=None, tail=(), dtype=U8,
                extra_rows: int = 0, lead=()):
    """Value arena with the streaming-segment carry contract: row 0 is the
    constant-zero value, rows 1..k hold the carried-in rows (in order), the
    rest are zeros; `extra_rows` appends trash rows (the scan executor's
    uniform-scatter targets).  `lead` inserts axes between the value-row axis
    and R (the z64 arenas are (V, 8 players, R)).  SINGLE source of truth
    for the row layout -- both executors build their arenas through this
    helper so segment streams stay byte-identical between them."""
    shape_t = lead + (R,) + tail
    if carried is None or carried.shape[0] == 0:
        return jnp.zeros((n_vals + extra_rows,) + shape_t, dtype)
    k = carried.shape[0]
    z1 = jnp.zeros((1,) + shape_t, dtype)
    zrest = jnp.zeros((n_vals - 1 - k + extra_rows,) + shape_t, dtype)
    return jnp.concatenate([z1, carried, zrest], axis=0)


def _dead_dst_columns(cc: CompiledCircuit, carry_out_vals, carry_outz_vals):
    """(level, key) -> True when NO later gate (nor a streaming segment
    carry) reads the column's dst values: their arena writes are dead and
    the executor skips them.  Transcript streams are untouched, so proof
    bytes are identical; what disappears is pure HBM write traffic (the
    reference's bench circuit -- every MUL output overwritten unread,
    proof/mod.rs:322-335 -- spends half its arena bandwidth on it)."""
    r2 = np.zeros(cc.n_vals2 + 1, bool)
    rz = np.zeros(cc.n_valsz + 1, bool)
    for table in cc.levels:
        for key, cols in table.items():
            domain, _kind = divmod(key, N_KINDS)
            tgt = r2 if domain == GF2 else rz
            for nm in ("a", "b"):
                if nm in cols:
                    tgt[np.asarray(cols[nm], np.int64)] = True
            if "zr" in cols:
                rz[np.asarray(cols["zr"], np.int64)] = True
            if "bits" in cols:  # B2A reads gf2 bit values
                r2[np.asarray(cols["bits"], np.int64).reshape(-1)] = True
    if carry_out_vals is not None:
        r2[np.asarray(carry_out_vals, np.int64)] = True
    if carry_outz_vals is not None:
        rz[np.asarray(carry_outz_vals, np.int64)] = True
    dead = {}
    for li, table in enumerate(cc.levels):
        for key, cols in table.items():
            if "dst" not in cols:
                continue
            domain, _kind = divmod(key, N_KINDS)
            tgt = r2 if domain == GF2 else rz
            dead[(li, key)] = not bool(
                tgt[np.asarray(cols["dst"], np.int64)].any()
            )
    return dead


def _classify(idx: np.ndarray):
    """Classify an index column: ('const', v) | ('arith', start, step) |
    ('gather', None).  Most compiled columns are constant, strided, or
    contiguous runs -- lowering those to broadcasts / (strided) slices
    instead of gathers/scatters saves the index reads and the scattered
    access pattern."""
    k = len(idx)
    if k == 0:
        return ("gather", None)
    if np.all(idx == idx[0]):
        return ("const", int(idx[0]))
    d = np.diff(idx.astype(np.int64))
    if np.all(d == d[0]) and d[0] > 0:
        return ("arith", int(idx[0]), int(d[0]))
    return ("gather", None)


class Executor:
    """Jitted executor for one compiled circuit in one role.

    Gate tables are device arrays passed at call time; the traced program
    references them positionally via a flat name->array dict.  Index columns
    that form constant/arithmetic runs are lowered to broadcasts and
    (strided) slice ops instead of gather/scatter.
    """

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int = 256,
                 mesh=None, carry_in: int = 0, carry_out_vals=None,
                 carry_inz: int = 0, carry_outz_vals=None,
                 tape_split: bool = False):
        """carry_in/carry_out_vals: streaming-segment wire carry (see
        backend/streaming.py) -- carry_in GF2 arena rows 1..k are initialized
        from inputs carry_mask2/carry_corr2; outputs gain carry_mask2/
        carry_corr2 rows gathered at carry_out_vals.  carry_inz/
        carry_outz_vals: same for the z64 arena (carry_mzlo/mzhi/czlo/czhi)."""
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.mesh = mesh
        self.carry_in = carry_in
        self.carry_out_vals = (
            None if carry_out_vals is None or len(carry_out_vals) == 0
            else np.asarray(carry_out_vals, dtype=np.int32)
        )
        self.carry_inz = carry_inz
        #: gf2 tape arrives as even/odd slot planes (inputs tape2_e/tape2_o)
        self.tape_split = tape_split
        self.carry_outz_vals = (
            None if carry_outz_vals is None or len(carry_outz_vals) == 0
            else np.asarray(carry_outz_vals, dtype=np.int32)
        )
        self.tables: Dict[str, np.ndarray] = {}
        self.meta: Dict[str, tuple] = {}
        self._np_cols: Dict[str, np.ndarray] = {}
        self._dead = (
            {} if _NO_DVE
            else _dead_dst_columns(cc, self.carry_out_vals,
                                   self.carry_outz_vals)
        )
        self._prep_tables()
        if self.carry_out_vals is not None:
            self.tables["carry_out_vals"] = self.carry_out_vals
        if self.carry_outz_vals is not None:
            self.tables["carry_outz_vals"] = self.carry_outz_vals
        # commit tables to device once (re-transferring megabytes of index
        # arrays per prove call would dominate small-circuit latency); under a
        # mesh the tables replicate across devices
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            self.tables = jax.device_put(
                self.tables, NamedSharding(mesh, PartitionSpec())
            )
        else:
            self.tables = jax.device_put(self.tables)
        self._run = jax.jit(self._trace)

    # ------------------------------------------------------------------
    def _prep_tables(self) -> None:
        """Precompute per-level index/constant arrays (runtime inputs)."""
        for li, table in enumerate(self.cc.levels):
            for key, cols in table.items():
                domain, kind = divmod(key, N_KINDS)
                pre = f"{li}.{key}."
                for name, arr in cols.items():
                    if name == "const":
                        if domain == GF2:
                            self.tables[pre + "cbit"] = (arr & 1).astype(np.uint8)
                        else:
                            lo, hi = up.from_u64(arr)
                            self.tables[pre + "clo"] = lo
                            self.tables[pre + "chi"] = hi
                    elif name == "bits":
                        self.tables[pre + name] = np.asarray(arr, np.int32)
                    else:
                        col = np.asarray(arr, np.int32)
                        self._np_cols[pre + name] = col
                        meta = _classify(col)
                        self.meta[pre + name] = meta + (len(col),)
                        if meta[0] == "gather":
                            self.tables[pre + name] = col
                def reg_rows(name, rows):
                    rows = rows.astype(np.int32)
                    self._np_cols[pre + name] = rows
                    meta = _classify(rows)
                    self.meta[pre + name] = meta + (len(rows),)
                    if meta[0] == "gather":
                        self.tables[pre + name] = rows

                # derived event-row arrays for z64 byte events
                if domain != GF2:
                    if kind in (G_MUL, G_ASSERT) and "onl" in cols:
                        reg_rows("onl_rows", (
                            cols["onl"][:, None] + np.arange(64)[None, :]
                        ).reshape(-1))
                    if kind in (G_MUL, B2A_CORR) and "pre" in cols:
                        reg_rows("pre_rows", (
                            cols["pre"][:, None] + np.arange(8)[None, :]
                        ).reshape(-1))
                    if kind == G_INPUT and "onl" in cols:
                        reg_rows("onl_rows", (
                            cols["onl"][:, None] + np.arange(8)[None, :]
                        ).reshape(-1))
                    if kind == B2A_OUT:
                        reg_rows("onl_rows", (
                            cols["onl"][:, None] + np.arange(64)[None, :]
                        ).reshape(-1))
                        self.tables[pre + "rec_rows"] = (
                            cols["rec"][:, None] + np.arange(64)[None, :]
                        ).astype(np.int32)
                elif kind == G_MUL:
                    pass  # gf2 mul uses scalar slots directly

    # ------------------------------------------------------------------
    def __call__(self, inputs: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        return self._run(dict(inputs), self.tables)

    # ------------------------------------------------------------------
    def _arena_rows(self):
        """Tight arena row bounds: 1 + the highest row any gate READS or
        (live) WRITES.  The value-numbering spans n_vals rows, but when a
        circuit's dst writes are dead (DVE) the tail rows are never touched
        -- allocating them only zero-fills HBM.  The reference bench circuit
        (every MUL output overwritten unread) reads 3 arena rows; the full
        (n_vals2, R) zero-init was ~0.5 GB of pure write traffic per
        executor call at 1M gates.  Streams/proof bytes are unchanged."""
        cc = self.cc
        hi2 = 0
        hiz = 0
        for li, table in enumerate(cc.levels):
            for key, cols in table.items():
                domain, _kind = divmod(key, N_KINDS)
                rd = ["a", "b"] if domain == GF2 else ["a", "b", "zr"]
                for nm in rd:
                    if nm in cols and len(cols[nm]):
                        m = int(np.max(cols[nm]))
                        if domain == GF2:
                            hi2 = max(hi2, m)
                        else:
                            hiz = max(hiz, m)
                if "zr" in cols and len(cols["zr"]):
                    hiz = max(hiz, int(np.max(cols["zr"])))
                if "bits" in cols and len(np.asarray(cols["bits"]).reshape(-1)):
                    hi2 = max(hi2, int(np.max(cols["bits"])))
                if "dst" in cols and len(cols["dst"]) and not self._dead.get(
                        (li, key), False):
                    m = int(np.max(cols["dst"]))
                    if domain == GF2:
                        hi2 = max(hi2, m)
                    else:
                        hiz = max(hiz, m)
        if self.carry_out_vals is not None and len(self.carry_out_vals):
            hi2 = max(hi2, int(np.max(self.carry_out_vals)))
        if self.carry_outz_vals is not None and len(self.carry_outz_vals):
            hiz = max(hiz, int(np.max(self.carry_outz_vals)))
        L2 = min(self.cc.n_vals2, max(hi2 + 1, 1 + self.carry_in))
        Lz = min(self.cc.n_valsz, max(hiz + 1, 1 + self.carry_inz))
        return L2, Lz

    def _trace(self, inp, tables):
        cc, R = self.cc, self.R
        L2, Lz = self._arena_rows()
        c2 = inp if self.carry_in else {}
        mask2_init = carry_arena(L2, R, c2.get("carry_mask2"))
        corr2_init = carry_arena(L2, R, c2.get("carry_corr2"))
        cz = inp if self.carry_inz else {}
        mzlo_init = carry_arena(Lz, R, cz.get("carry_mzlo"), (), U32,
                                lead=(8,))
        mzhi_init = carry_arena(Lz, R, cz.get("carry_mzhi"), (), U32,
                                lead=(8,))
        czlo_init = carry_arena(Lz, R, cz.get("carry_czlo"), (), U32)
        czhi_init = carry_arena(Lz, R, cz.get("carry_czhi"), (), U32)
        st = dict(
            mask2=mask2_init,
            corr2=corr2_init,
            mzlo=mzlo_init,
            mzhi=mzhi_init,
            czlo=czlo_init,
            czhi=czhi_init,
            fail=jnp.zeros((R,), dtype=jnp.bool_),
        )
        # stream buffers are assembled at the end of the trace: when a
        # stream's put windows exactly tile [0, N) as contiguous runs (the
        # common compiled layout), one concatenate replaces zeros + DUS --
        # at 1M gates the zeros(onl2)+zeros(pre2) init alone was ~0.75 GB
        # of HBM writes immediately overwritten.  Order-preserving DUS
        # replay is the fallback, so bytes are identical either way.
        pending = {"onl2": [], "pre2": [], "onlz": [], "prez": []}
        st["_pending"] = pending
        for li, table in enumerate(cc.levels):
            for key in sorted(table.keys()):
                domain, kind = divmod(key, N_KINDS)
                acc = _Acc(self, li, key, tables)
                if domain == GF2:
                    self._gf2_kind(st, inp, kind, acc)
                else:
                    self._z64_kind(st, inp, kind, acc)
        sizes = {"onl2": cc.onl2, "pre2": cc.pre2,
                 "onlz": cc.onlz, "prez": cc.prez}
        out = {"fail": st["fail"]}
        for name, parts in st["_pending"].items():
            out[name] = _assemble_stream(parts, sizes[name], R)
        if self.carry_out_vals is not None:
            vals = tables["carry_out_vals"]
            out["carry_mask2"] = jnp.take(st["mask2"], vals, axis=0)
            out["carry_corr2"] = jnp.take(st["corr2"], vals, axis=0)
        if self.carry_outz_vals is not None:
            valsz = tables["carry_outz_vals"]
            out["carry_mzlo"] = jnp.take(st["mzlo"], valsz, axis=0)
            out["carry_mzhi"] = jnp.take(st["mzhi"], valsz, axis=0)
            out["carry_czlo"] = jnp.take(st["czlo"], valsz, axis=0)
            out["carry_czhi"] = jnp.take(st["czhi"], valsz, axis=0)
        return out

    # ------------------------------------------------------------------
    def _gf2_kind(self, st, inp, kind, A):
        mode = self.mode
        mask2, corr2 = st["mask2"], st["corr2"]
        if kind == G_INPUT:
            m = A.take_tape(inp, "tape")
            if mode == PROVER:
                wit = A.take(inp["wit2"], "wit")
                corr = wit ^ _parity8(m)
            elif mode == VERIFY_ONL:
                corr = A.take(inp["in2"], "rec")
            else:
                corr = jnp.zeros_like(m)
            if mode != VERIFY_PRE:
                A.put_stream(st, "onl2", "onl", _expand(corr))
            st["mask2"] = A.put_dst(mask2, m)
            st["corr2"] = A.put_dst(corr2, corr)
        elif kind == G_ADD:
            a = A.take(mask2, "a")
            b = A.take(mask2, "b")
            ac = A.take(corr2, "a")
            bc = A.take(corr2, "b")
            st["mask2"] = A.put_dst(mask2, a ^ b)
            st["corr2"] = A.put_dst(corr2, ac ^ bc)
        elif kind in (G_ADDC, G_SUBC):
            a = A.take(mask2, "a")
            ac = A.take(corr2, "a")
            cbit = A.arr("cbit")[:, None]
            st["mask2"] = A.put_dst(mask2, a)
            st["corr2"] = A.put_dst(corr2, ac ^ cbit)
        elif kind == G_MULC:
            a = A.take(mask2, "a")
            ac = A.take(corr2, "a")
            cbit = A.arr("cbit")[:, None]
            st["mask2"] = A.put_dst(mask2, a & _expand(cbit))
            st["corr2"] = A.put_dst(corr2, ac & cbit)
        elif kind == G_MUL:
            a = A.take(mask2, "a")
            b = A.take(mask2, "b")
            ac = A.take(corr2, "a")
            bc = A.take(corr2, "b")
            m_ab, m_new = A.take_tape_pair(inp, "tape_ab", "tape_new")
            if mode == VERIFY_ONL:
                delta = A.take(inp["co2"], "corr")
            else:
                delta = (_parity8(a) & _parity8(b)) ^ _parity8(m_ab)
            A.put_stream(st, "pre2", "pre", _expand(delta))
            s = (b & _expand(ac)) ^ (a & _expand(bc)) ^ m_ab ^ m_new
            if mode == VERIFY_ONL:
                s = s ^ A.take(inp["re2"], "rec")
            if mode != VERIFY_PRE:
                A.put_stream(st, "onl2", "onl", s)
                recon = _parity8(s) ^ delta
            else:
                recon = jnp.zeros_like(s)  # junk (verifier/preprocess.rs:63-65)
            st["mask2"] = A.put_dst(st["mask2"], m_new)
            st["corr2"] = A.put_dst(st["corr2"], recon ^ (ac & bc))
        elif kind == G_ASSERT:
            if mode == VERIFY_PRE:
                return
            s = A.take(mask2, "a")
            ac = A.take(corr2, "a")
            if mode == VERIFY_ONL:
                s = s ^ A.take(inp["re2"], "rec")
            A.put_stream(st, "onl2", "onl", s)
            nonzero = (_parity8(s) ^ ac) != 0
            st["fail"] = st["fail"] | jnp.any(nonzero, axis=0)
        elif kind == G_RANDOM:
            m = A.take_tape(inp, "tape")
            st["mask2"] = A.put_dst(mask2, m)
        elif kind == G_CONST:
            cbit = A.arr("cbit")
            vals = jnp.broadcast_to(cbit[:, None], (cbit.shape[0], self.R))
            st["corr2"] = A.put_dst(corr2, vals)
        else:
            raise ValueError(f"bad gf2 kind {kind}")

    # ------------------------------------------------------------------
    def _z64_kind(self, st, inp, kind, A):
        mode = self.mode

        def gm(name):
            return A.take(st["mzlo"], name), A.take(st["mzhi"], name)

        def gc(name):
            return A.take(st["czlo"], name), A.take(st["czhi"], name)

        def put_mask(lo, hi):
            st["mzlo"] = A.put_dst(st["mzlo"], lo)
            st["mzhi"] = A.put_dst(st["mzhi"], hi)

        def put_corr(lo, hi):
            st["czlo"] = A.put_dst(st["czlo"], lo)
            st["czhi"] = A.put_dst(st["czhi"], hi)

        def tape_row(name):
            return A.take(inp["tapez_lo"], name), A.take(inp["tapez_hi"], name)

        def const_pair():
            lo, hi = A.arr("clo"), A.arr("chi")
            return (
                jnp.broadcast_to(lo[:, None], (lo.shape[0], self.R)),
                jnp.broadcast_to(hi[:, None], (hi.shape[0], self.R)),
            )

        def emit_corr_bytes(buf_name, lo, hi):
            by = jnp.stack(up.le_bytes(lo, hi), axis=1)  # (k, 8, R)
            A.put_stream(st, buf_name, "pre_rows", by.reshape(-1, self.R))

        if kind == G_INPUT:
            lo, hi = tape_row("tape")
            rlo, rhi = _recon_sum(lo, hi)
            if mode == PROVER:
                wlo = A.take(inp["witz_lo"], "wit")
                whi = A.take(inp["witz_hi"], "wit")
                clo, chi = up.sub64(wlo, whi, rlo, rhi)
            elif mode == VERIFY_ONL:
                clo = A.take(inp["inz_lo"], "rec")
                chi = A.take(inp["inz_hi"], "rec")
            else:
                clo = jnp.zeros_like(rlo)
                chi = jnp.zeros_like(rhi)
            if mode != VERIFY_PRE:
                by = jnp.stack(up.le_bytes(clo, chi), axis=1)
                A.put_stream(st, "onlz", "onl_rows", by.reshape(-1, self.R))
            put_mask(lo, hi)
            put_corr(clo, chi)
        elif kind in (G_ADD, Z_SUB):
            alo, ahi = gm("a")
            blo, bhi = gm("b")
            aclo, achi = gc("a")
            bclo, bchi = gc("b")
            fn = up.add64 if kind == G_ADD else up.sub64
            lo, hi = fn(alo, ahi, blo, bhi)
            clo, chi = fn(aclo, achi, bclo, bchi)
            put_mask(lo, hi)
            put_corr(clo, chi)
        elif kind in (G_ADDC, G_SUBC):
            alo, ahi = gm("a")
            aclo, achi = gc("a")
            klo, khi = const_pair()
            fn = up.add64 if kind == G_ADDC else up.sub64
            clo, chi = fn(aclo, achi, klo, khi)
            put_mask(alo, ahi)
            put_corr(clo, chi)
        elif kind == G_MULC:
            alo, ahi = gm("a")
            aclo, achi = gc("a")
            klo, khi = const_pair()
            lo, hi = up.mul64(alo, ahi, klo[:, None, :], khi[:, None, :])
            clo, chi = up.mul64(aclo, achi, klo, khi)
            put_mask(lo, hi)
            put_corr(clo, chi)
        elif kind == G_MUL:
            alo, ahi = gm("a")
            blo, bhi = gm("b")
            aclo, achi = gc("a")
            bclo, bchi = gc("b")
            tablo, tabhi = tape_row("tape_ab")
            tnlo, tnhi = tape_row("tape_new")
            ralo, rahi = _recon_sum(alo, ahi)
            rblo, rbhi = _recon_sum(blo, bhi)
            rclo, rchi = _recon_sum(tablo, tabhi)
            if mode == VERIFY_ONL:
                dlo = A.take(inp["coz_lo"], "corr")
                dhi = A.take(inp["coz_hi"], "corr")
            else:
                plo, phi = up.mul64(ralo, rahi, rblo, rbhi)
                dlo, dhi = up.sub64(plo, phi, rclo, rchi)
            emit_corr_bytes("prez", dlo, dhi)
            s1lo, s1hi = up.mul64(blo, bhi, aclo[:, None, :], achi[:, None, :])
            s2lo, s2hi = up.mul64(alo, ahi, bclo[:, None, :], bchi[:, None, :])
            slo, shi = up.add64(s1lo, s1hi, s2lo, s2hi)
            slo, shi = up.add64(slo, shi, tablo, tabhi)
            slo, shi = up.sub64(slo, shi, tnlo, tnhi)
            if mode == VERIFY_ONL:
                slo, shi = up.add64(
                    slo, shi, A.take(inp["rez_lo"], "rec"), A.take(inp["rez_hi"], "rec")
                )
            if mode != VERIFY_PRE:
                # player-major masks: the 64-byte share event (8 players x
                # 8 LE bytes) is a stack + free reshape -- no transpose
                by = jnp.stack(up.le_bytes(slo, shi), axis=2)  # (k, 8p, 8b, R)
                A.put_stream(st, "onlz", "onl_rows", by.reshape(-1, self.R))
                srlo, srhi = _recon_sum(slo, shi)
                relo, rehi = up.add64(srlo, srhi, dlo, dhi)
            else:
                relo = jnp.zeros_like(dlo)
                rehi = jnp.zeros_like(dhi)
            pclo, pchi = up.mul64(aclo, achi, bclo, bchi)
            clo, chi = up.add64(relo, rehi, pclo, pchi)
            put_mask(tnlo, tnhi)
            put_corr(clo, chi)
        elif kind == G_ASSERT:
            if mode == VERIFY_PRE:
                return
            slo, shi = gm("a")
            aclo, achi = gc("a")
            if mode == VERIFY_ONL:
                slo, shi = up.add64(
                    slo, shi, A.take(inp["rez_lo"], "rec"), A.take(inp["rez_hi"], "rec")
                )
            by = jnp.stack(up.le_bytes(slo, shi), axis=2)  # (k, 8p, 8b, R)
            A.put_stream(st, "onlz", "onl_rows", by.reshape(-1, self.R))
            rlo, rhi = _recon_sum(slo, shi)
            vlo, vhi = up.add64(rlo, rhi, aclo, achi)
            st["fail"] = st["fail"] | jnp.any((vlo | vhi) != 0, axis=0)
        elif kind == G_RANDOM:
            lo, hi = tape_row("tape")
            put_mask(lo, hi)
        elif kind == G_CONST:
            klo, khi = const_pair()
            put_corr(klo, khi)
        elif kind == B2A_CORR:
            bits = _parity8(jnp.take(st["mask2"], A.arr("bits"), axis=0))
            vlo, vhi = _compose_bits(bits)
            lo, hi = tape_row("tape")
            rlo, rhi = _recon_sum(lo, hi)
            if mode == VERIFY_ONL:
                clo = A.take(inp["coz_lo"], "corr")
                chi = A.take(inp["coz_hi"], "corr")
            else:
                clo, chi = up.sub64(vlo, vhi, rlo, rhi)
            emit_corr_bytes("prez", clo, chi)
            put_mask(lo, hi)
            put_corr(clo, chi)
        elif kind == B2A_OUT:
            ids = A.arr("bits")  # (k, 64)
            s = jnp.take(st["mask2"], ids, axis=0)  # (k, 64, R)
            bc = jnp.take(st["corr2"], ids, axis=0)
            if mode == VERIFY_ONL:
                s = s ^ jnp.take(inp["re2"], A.arr("rec_rows"), axis=0)
            if mode != VERIFY_PRE:
                A.put_stream(st, "onl2", "onl_rows", s.reshape(-1, self.R))
                bits = _parity8(s) ^ bc
            else:
                bits = bc  # junk: recon is zero in preprocess mode
            vlo, vhi = _compose_bits(bits)
            zrlo, zrhi = gm("zr")
            zclo, zchi = gc("zr")
            nlo, nhi = up.neg64(zrlo, zrhi)
            clo, chi = up.sub64(vlo, vhi, zclo, zchi)
            put_mask(nlo, nhi)
            put_corr(clo, chi)
        else:
            raise ValueError(f"bad z64 kind {kind}")


def _assemble_stream(parts, n_rows: int, R: int):
    """parts: [(acc, colname, vals)] in trace order.  Concatenate when the
    arith-step-1 put windows exactly tile [0, n_rows); otherwise zeros +
    ordered put replay (byte-identical semantics)."""
    if n_rows == 0 or not parts:
        return jnp.zeros((max(n_rows, 1), R), dtype=U8)
    runs = []
    ok = True
    for acc, name, vals in parts:
        kind, *rest = acc.ex.meta[acc.pre + name]
        if kind == "arith" and rest[1] == 1:
            runs.append((rest[0], rest[2], vals))
        elif kind == "const" and rest[1] == 1:
            runs.append((rest[0], 1, vals))
        else:
            ok = False
            break
    if ok:
        runs.sort(key=lambda t: t[0])
        pos = 0
        for start, k, _ in runs:
            if start != pos:
                ok = False
                break
            pos += k
        ok = ok and pos == n_rows
    if ok:
        if len(runs) == 1:
            return runs[0][2]
        return jnp.concatenate([v for _, _, v in runs], axis=0)
    buf = jnp.zeros((n_rows, R), dtype=U8)
    for acc, name, vals in parts:
        buf = acc.put(buf, name, vals)
    return buf


class _Acc:
    """Per-(level, kind) table accessor: lowers constant/arithmetic index
    columns to broadcasts / (strided) slices; general columns to gathers."""

    def __init__(self, ex: "Executor", li: int, key: int, tables):
        self.ex = ex
        self.pre = f"{li}.{key}."
        self.tables = tables
        #: this column's dst values are never read -> skip their arena puts
        self.dead_dst = ex._dead.get((li, key), False)

    def arr(self, name: str):
        return self.tables[self.pre + name]

    def take(self, src, name: str):
        kind, *rest = self.ex.meta[self.pre + name]
        if kind == "const":
            v, k = rest
            row = jax.lax.slice_in_dim(src, v, v + 1, axis=0)
            return jnp.broadcast_to(row, (k,) + src.shape[1:])
        if kind == "arith":
            start, step, k = rest
            return jax.lax.slice_in_dim(
                src, start, start + (k - 1) * step + 1, stride=step, axis=0
            )
        return jnp.take(src, self.tables[self.pre + name], axis=0)

    # -- split-plane tape reads ---------------------------------------
    # The gf2 tape can arrive pre-split into even/odd slot planes (tape2_e /
    # tape2_o, slot s -> plane s & 1, row s >> 1), split by the tape
    # builder.  A stride-2 run (every MUL's tape_ab / tape_new) is then a
    # CONTIGUOUS window of one plane instead of a pair-window relayout.
    # Proof bytes are unchanged -- this is pure device storage layout.

    def take_tape(self, inp, name: str):
        if not self.ex.tape_split:
            return self.take(inp["tape2"], name)
        e, o = inp["tape2_e"], inp["tape2_o"]
        kind, *rest = self.ex.meta[self.pre + name]
        if kind == "const":
            v, k = rest
            src = o if (v & 1) else e
            row = jax.lax.slice_in_dim(src, v >> 1, (v >> 1) + 1, axis=0)
            return jnp.broadcast_to(row, (k,) + src.shape[1:])
        if kind == "arith":
            start, step, k = rest
            if step == 2 or k == 1:
                src = o if (start & 1) else e
                s2 = start >> 1
                return jax.lax.slice_in_dim(src, s2, s2 + k, axis=0)
            if step == 1:
                # mixed parity: read both plane windows, riffle, trim.
                # Rare (witness INPUT / RANDOM runs); pays one relayout.
                w0 = start >> 1
                w1 = (start + k + 1) >> 1
                we = jax.lax.slice_in_dim(e, w0, w1, axis=0)
                wo = jax.lax.slice_in_dim(o, w0, w1, axis=0)
                riff = jnp.stack([we, wo], axis=1).reshape(
                    2 * (w1 - w0), *e.shape[1:])
                off = start - 2 * w0
                return jax.lax.slice_in_dim(riff, off, off + k, axis=0)
            # other strides: fall through to the gather form
        idx = self.tables.get(self.pre + name)
        if idx is None:
            idx = self.ex.tables.get(self.pre + name)
        if idx is None:
            idx = jnp.asarray(self.ex._np_cols[self.pre + name])
        ge = jnp.take(e, idx >> 1, axis=0)
        go = jnp.take(o, idx >> 1, axis=0)
        par = (idx & 1).astype(jnp.bool_)
        return jnp.where(par[(...,) + (None,) * (ge.ndim - 1)], go, ge)

    def take_tape_pair(self, inp, name_a: str, name_b: str):
        if not self.ex.tape_split:
            return self.take_pair(inp["tape2"], name_a, name_b)
        ma = self.ex.meta[self.pre + name_a]
        mb = self.ex.meta[self.pre + name_b]
        if (
            ma[0] == "arith" and mb[0] == "arith"
            and ma[2] == 2 and mb[2] == 2
            and mb[1] == ma[1] + 1 and ma[3] == mb[3]
        ):
            e, o = inp["tape2_e"], inp["tape2_o"]
            a0, k = ma[1], ma[3]
            src_a, src_b = (e, o) if (a0 & 1) == 0 else (o, e)
            sa = a0 >> 1
            sb = (a0 + 1) >> 1
            return (
                jax.lax.slice_in_dim(src_a, sa, sa + k, axis=0),
                jax.lax.slice_in_dim(src_b, sb, sb + k, axis=0),
            )
        return self.take_tape(inp, name_a), self.take_tape(inp, name_b)

    def put_stream(self, st, buf_name: str, name: str, vals):
        """Deferred stream write: parts are recorded in trace order and
        assembled once at the end of the trace (_assemble_stream)."""
        st["_pending"][buf_name].append((self, name, vals))

    def take_pair(self, src, name_a: str, name_b: str):
        """Fused take of two columns that interleave as an arithmetic run of
        stride 2 (the MUL tape_ab/tape_new pattern: consecutive ShareGen
        calls per gate).  One contiguous window read + a minor-dim split
        replaces two stride-2 slices, each of which reads the whole window
        for half of its bytes."""
        ma = self.ex.meta[self.pre + name_a]
        mb = self.ex.meta[self.pre + name_b]
        if (
            src.ndim == 2
            and ma[0] == "arith" and mb[0] == "arith"
            and ma[2] == 2 and mb[2] == 2
            and mb[1] == ma[1] + 1 and ma[3] == mb[3]
        ):
            start, k = ma[1], ma[3]
            lanes = src.shape[1]
            w = jax.lax.slice_in_dim(src, start, start + 2 * k, axis=0)
            w = w.reshape(k, 2 * lanes)
            return w[:, :lanes], w[:, lanes:]
        return self.take(src, name_a), self.take(src, name_b)

    def put_dst(self, buf, vals):
        """Arena write at the dst column -- skipped when the whole column is
        dead (see _dead_dst_columns; REVERIE_NO_DVE=1 disables)."""
        if self.dead_dst:
            return buf
        return self.put(buf, "dst", vals)

    def put(self, buf, name: str, vals):
        kind, *rest = self.ex.meta[self.pre + name]
        # Miscompile workaround (see _scat), kept until the GPU shows byte
        # identity without it.  Slice/DUS lowerings were never affected, so
        # the barrier is only kept ahead of true scatters; set
        # REVERIE_FULL_BARRIER=1 to restore it everywhere.
        if kind == "gather" or _FULL_BARRIER:
            vals = jax.lax.optimization_barrier(vals)
        if kind == "const":
            v, k = rest
            assert k == 1, "duplicate scatter rows"
            return jax.lax.dynamic_update_slice_in_dim(buf, vals, v, axis=0)
        if kind == "arith":
            start, step, k = rest
            if step == 1:
                return jax.lax.dynamic_update_slice_in_dim(buf, vals, start, axis=0)
            # strided scatter: read-modify-write the covering window
            width = (k - 1) * step + 1
            win = jax.lax.slice_in_dim(buf, start, start + width, axis=0)
            pad = k * step - width
            if pad:
                win = jnp.concatenate(
                    [win, jnp.zeros((pad,) + win.shape[1:], win.dtype)], axis=0
                )
            win = win.reshape(k, step, *vals.shape[1:]).at[:, 0].set(vals)
            win = win.reshape(k * step, *vals.shape[1:])[:width]
            return jax.lax.dynamic_update_slice_in_dim(buf, win, start, axis=0)
        return buf.at[self.tables[self.pre + name]].set(vals)


def _compose_bits(bits):
    """(k, 64, R) 0/1 uint8 -> u64 pair (k, R): bit i = wire i (LE)."""
    b = bits.astype(U32)
    w = jnp.asarray((1 << np.arange(32)).astype(np.uint32))
    lo = jnp.sum(b[:, :32, :] * w[None, :, None], axis=1, dtype=U32)
    hi = jnp.sum(b[:, 32:, :] * w[None, :, None], axis=1, dtype=U32)
    return lo, hi
