"""Scan-mode executor for deep circuits (e.g. SHA-256: ~5200 levels).

The unrolled executor (backend/tpu.py) emits one XLA op sequence per level --
intractable to compile for thousands of levels.  This executor instead runs a
`lax.scan` over uniform fixed-width gate "waves" (circuit/compile.build_waves)
with a single compiled body: every slot carries a unified gate encoding and
the body computes all gate families and selects by opcode.  Slots that don't
produce a result write to trash rows (dst = V, event slot = T), keeping the
body fully uniform.

Waves carry W GF2 slots plus, for circuits with z64/B2A ops, Wz z64-side
slots (every z64 gate family computed + opcode-selected the same way; B2A
slots bridge the domains by indexing the GF2 arenas/streams through the
precompiled b* columns).  Deep arithmetic and B2A-heavy circuits therefore
compile as one scan body too, instead of one op sequence per level
(reference analog: the single interpreter loop, interpreter/combine.rs).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..algebra import u64pair as up
from ..circuit.compile import (
    _NOP as _SCAN_NOP,
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
    Z_SUB,
    CompiledCircuit,
    WaveTable,
    build_waves,
)
from .tpu import (
    PROVER,
    VERIFY_ONL,
    VERIFY_PRE,
    _compose_bits,
    _expand,
    _parity8,
    _recon_sum,
    carry_arena,
)

U8 = jnp.uint8
U16 = jnp.uint16
U32 = jnp.uint32

#: lax.scan unroll of the GF2 wave loop.  Measured on an H100 at 400 W
#: (SHA-256 prove, 5,198 waves): unroll 1 runs 101 ms; 2, 4 and 8 run
#: 566-583 ms and compile slower (see PERF.md)
SCAN_UNROLL = 1


class _Cfg(NamedTuple):
    """Static trace configuration: two segments with equal _Cfg + equal wave
    table shapes share one traced/jitted callable (streaming proves hundreds
    of uniform segments; per-instance jits would trace each one)."""

    mode: int
    R: int
    n_vals2: int
    n_valsz: int
    onl2: int
    pre2: int
    onlz: int
    prez: int
    has_z: bool
    carry_in: int
    carry_inz: int
    carry_out: bool
    carry_outz: bool
    zkinds: int = -1  # bitmask of z64 opcodes present anywhere (-1 = all)
    #: GF2-only fast path: arena slots renumbered wave-contiguously so the
    #: two arena writes are dynamic_update_slice (a contiguous update in
    #: place of a row scatter), and the
    #: onl/pre stream events leave the scan as stacked ys re-ordered by one
    #: post-scan gather.  n_vals2 then holds the renumbered arena height.
    fast2: bool = False

    def zhas(self, *kinds) -> bool:
        return any(self.zkinds & (1 << k) for k in kinds)


_TRACE_FNS: Dict[_Cfg, object] = {}


def default_wave_width(cc: CompiledCircuit) -> int:
    """Adapt the wave width to the mean level occupancy: wide enough to
    swallow typical levels, narrow enough to avoid NOP-padding waste."""
    n_gates = sum(
        len(next(iter(cols.values())))
        for lvl in cc.levels
        for cols in lvl.values()
    )
    mean = max(1, n_gates // max(1, cc.depth))
    # next pow2 >= mean (a 2*mean rule gives W=64 for SHA-256's mean 26,
    # 60% NOP slots; W=32 needs only 3.5% more waves)
    wave_width = 8
    while wave_width < min(256, mean):
        wave_width *= 2
    return wave_width


def _jitted(cfg: _Cfg):
    if cfg not in _TRACE_FNS:
        _TRACE_FNS[cfg] = jax.jit(functools.partial(_scan_trace, cfg))
    return _TRACE_FNS[cfg]


class ScanExecutor:
    """Jitted scan-mode executor for one compiled circuit in one role.

    carry_in/carry_out_vals (+ z64 twins): streaming-segment wire carry with
    the same contract as the unrolled Executor -- GF2 arena rows 1..k
    initialize from inputs carry_mask2/carry_corr2; outputs gain
    carry_mask2/carry_corr2 gathered at carry_out_vals."""

    def __init__(self, cc: CompiledCircuit, mode: int, total_reps: int = 256,
                 wave_width: int = 0, mesh=None, carry_in: int = 0,
                 carry_out_vals=None, carry_inz: int = 0,
                 carry_outz_vals=None):
        self.cc = cc
        self.mode = mode
        self.R = total_reps
        self.mesh = mesh
        if wave_width <= 0:
            wave_width = default_wave_width(cc)
        self.waves = build_waves(cc, wave_width)
        # fast path requires a pure-GF2 scan with no z64 arena traffic (a
        # mixed circuit's gf2-only segment may still pass z64 carry through)
        fast2 = (
            not self.waves.has_z64
            and self.waves.n_waves > 0
            and carry_inz == 0
            and (carry_outz_vals is None or len(carry_outz_vals) == 0)
        )
        if fast2:
            wv = self.waves
            nw, W = wv.op.shape
            base = 1 + carry_in  # row 0 = const zero, rows 1..k = carry-in
            V2 = base + nw * W
            # remap: SSA slot -> wave-contiguous slot (wave i slot j writes
            # arena row base + i*W + j; unmapped reads resolve to zero row 0)
            remap = np.zeros(cc.n_vals2 + 1, np.int64)
            remap[:base] = np.arange(base)
            newids = base + np.arange(nw * W, dtype=np.int64).reshape(nw, W)
            writes = wv.dst != cc.n_vals2
            remap[wv.dst[writes]] = newids[writes]
            xs_host = {
                "op": wv.op,
                # fused index columns: ONE (2W,) arena gather
                # replaces the 4 a/b mask/corr gathers (the arena packs
                # mask|corr in one u16), ONE (2W,) tape gather replaces t0/t1
                "ab": np.concatenate(
                    [remap[wv.a], remap[wv.b]], axis=1).astype(np.int32),
                "tt": np.concatenate([wv.t0, wv.t1], axis=1).astype(np.int32),
                "wit": wv.wit, "inrec": wv.inrec,
                "rec": wv.rec, "corr": wv.corr, "cbit": wv.cbit,
                "slot0": (base + np.arange(nw, dtype=np.int64) * W).astype(
                    np.int32),
            }
            # stream-event inversion: program stream row t <- ys flat slot
            def invert(col, n):
                flat = col.reshape(-1)
                m = flat < n
                g = np.zeros(max(n, 1), np.int32)
                g[flat[m]] = np.arange(flat.shape[0], dtype=np.int64)[m]
                return g

            couts_host = {
                "gidx_onl": invert(wv.onl, cc.onl2),
                "gidx_pre": invert(wv.pre, cc.pre2),
            }
            self._fast_shape = (nw, W, V2)
            if carry_out_vals is not None and len(carry_out_vals):
                carry_out_vals = remap[np.asarray(carry_out_vals, np.int64)]
        else:
            cols = ["op", "dst", "a", "b", "t0", "t1", "wit", "inrec", "rec",
                    "corr", "onl", "pre", "cbit"]
            if self.waves.has_z64:
                cols += ["zop", "zdst", "za", "zb", "zt0", "zt1", "zwit",
                         "zinrec", "zrec", "zcorr", "zzr", "zclo", "zchi",
                         "zonl", "zpre", "bbits", "brec", "bonl"]
            xs_host = {k: np.asarray(getattr(self.waves, k)) for k in cols}
            couts_host = {}
        if carry_out_vals is not None and len(carry_out_vals):
            couts_host["carry_out_vals"] = np.asarray(carry_out_vals, np.int32)
        if carry_outz_vals is not None and len(carry_outz_vals):
            couts_host["carry_outz_vals"] = np.asarray(carry_outz_vals, np.int32)
        if mesh is not None:
            # wave tables replicate across the mesh; the rep axis of the
            # inputs/carry is sharded (parallel/mesh.py) and propagates
            # through the scan (all ops are elementwise or axis-0 gathers)
            from jax.sharding import NamedSharding, PartitionSpec

            repl = NamedSharding(mesh, PartitionSpec())
            self.xs = jax.device_put(xs_host, repl)
            self.couts = jax.device_put(couts_host, repl)
        else:
            self.xs = jax.device_put(xs_host)
            self.couts = jax.device_put(couts_host)
        zkinds = 0
        if self.waves.has_z64:
            for k in np.unique(self.waves.zop):
                if k != _SCAN_NOP:
                    zkinds |= 1 << int(k)
        self.cfg = _Cfg(
            mode=mode, R=total_reps,
            n_vals2=self._fast_shape[2] if fast2 else cc.n_vals2,
            n_valsz=cc.n_valsz,
            onl2=cc.onl2, pre2=cc.pre2, onlz=cc.onlz, prez=cc.prez,
            has_z=self.waves.has_z64, carry_in=carry_in, carry_inz=carry_inz,
            carry_out="carry_out_vals" in couts_host,
            carry_outz="carry_outz_vals" in couts_host,
            zkinds=zkinds, fast2=fast2,
        )
        self._run = _jitted(self.cfg)

    def __call__(self, inputs: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        out = self._run(dict(inputs), self.xs, self.couts)
        R = self.R
        # present the same output dict as the unrolled executor
        res = {
            "onl2": out["onl2"],
            "pre2": out["pre2"],
            "onlz": out.get("onlz", jnp.zeros((1, R), U8)),
            "prez": out.get("prez", jnp.zeros((1, R), U8)),
            "fail": out["fail"],
        }
        for k in ("carry_mask2", "carry_corr2", "carry_mzlo", "carry_mzhi",
                  "carry_czlo", "carry_czhi"):
            if k in out:
                res[k] = out[k]
        return res


def _scan_trace_fast2(cfg: _Cfg, inp, xs, couts):
    """GF2-only scan body with wave-contiguous arena slots.

    The arena packs mask|corr into one u16 plane, so a single (2W,) gather
    (fused [a;b] index column) feeds all four operand reads and ONE
    dynamic_update_slice writes both results.  The wave writes land at slot0 (the __init__ renumbering made each
    wave's dst rows contiguous), and the onl/pre stream events leave the
    scan as stacked ys, re-ordered into program-order stream rows by one
    post-scan gather instead of one row scatter per scan step."""
    mode, R = cfg.mode, cfg.R
    c2 = inp if cfg.carry_in else {}
    carried = None
    if c2.get("carry_mask2") is not None and c2["carry_mask2"].shape[0]:
        carried = c2["carry_mask2"].astype(U16) | (
            c2["carry_corr2"].astype(U16) << 8)
    arena0 = carry_arena(cfg.n_vals2, R, carried, dtype=U16)
    fail0 = jnp.zeros((R,), jnp.bool_)

    def pad0(v, shape, dtype=U8):
        if v is None or v.shape[0] == 0:
            return jnp.zeros(shape, dtype)
        return v

    tape2 = pad0(inp["tape2"], (1, R))
    wit2 = pad0(inp.get("wit2"), (1, R))
    in2 = pad0(inp.get("in2"), (1, R))
    co2 = pad0(inp.get("co2"), (1, R))
    re2 = pad0(inp.get("re2"), (1, R))

    def body(carry, w):
        arena, fail = carry
        W = w["op"].shape[0]
        op = w["op"][:, None]
        ab = jnp.take(arena, w["ab"], axis=0)  # (2W, R) u16, one gather
        amc, bmc = ab[:W], ab[W:]
        a_m = (amc & jnp.uint16(0xFF)).astype(U8)
        a_c = (amc >> jnp.uint16(8)).astype(U8)
        b_m = (bmc & jnp.uint16(0xFF)).astype(U8)
        b_c = (bmc >> jnp.uint16(8)).astype(U8)
        tt = jnp.take(tape2, w["tt"], axis=0)  # (2W, R) u8, one gather
        t0, t1 = tt[:W], tt[W:]
        cbit = w["cbit"].astype(U8)[:, None]

        if mode == VERIFY_ONL:
            delta = jnp.take(co2, w["corr"], axis=0)
        else:
            delta = (_parity8(a_m) & _parity8(b_m)) ^ _parity8(t0)
        s = (b_m & _expand(a_c)) ^ (a_m & _expand(b_c)) ^ t0 ^ t1
        if mode == VERIFY_ONL:
            msg = jnp.take(re2, w["rec"], axis=0)
            s = s ^ msg
        if mode != VERIFY_PRE:
            recon = _parity8(s) ^ delta
        else:
            recon = jnp.zeros_like(s)
        mul_corr = recon ^ (a_c & b_c)

        if mode == PROVER:
            in_c = jnp.take(wit2, w["wit"], axis=0) ^ _parity8(t0)
        elif mode == VERIFY_ONL:
            in_c = jnp.take(in2, w["inrec"], axis=0)
        else:
            in_c = jnp.zeros_like(a_c)

        s_assert = a_m
        if mode == VERIFY_ONL:
            s_assert = s_assert ^ msg
        if mode != VERIFY_PRE:
            a_nonzero = (_parity8(s_assert) ^ a_c) != 0
            fail = fail | jnp.any((op == G_ASSERT) & a_nonzero, axis=0)

        mask_new = jnp.select(
            [op == G_MUL, op == G_INPUT, op == G_ADD,
             (op == G_ADDC) | (op == G_SUBC), op == G_MULC,
             op == G_RANDOM],
            [t1, t0, a_m ^ b_m, a_m, a_m & _expand(cbit), t0],
            jnp.zeros_like(a_m),
        )
        corr_new = jnp.select(
            [op == G_MUL, op == G_INPUT, op == G_ADD,
             (op == G_ADDC) | (op == G_SUBC), op == G_MULC,
             op == G_CONST],
            [mul_corr, in_c, a_c ^ b_c, a_c ^ cbit, a_c & cbit, cbit],
            jnp.zeros_like(a_c),
        )
        packed = mask_new.astype(U16) | (corr_new.astype(U16) << 8)
        # this and the other barriers in the scan bodies: miscompile
        # workaround (see backend/tpu._scat), kept until the GPU shows byte
        # identity without them
        packed = jax.lax.optimization_barrier(packed)
        arena = jax.lax.dynamic_update_slice_in_dim(
            arena, packed, w["slot0"], axis=0)

        ys = {"pre": _expand(delta)}
        if mode != VERIFY_PRE:
            ys["onl"] = jnp.select(
                [op == G_MUL, op == G_ASSERT, op == G_INPUT],
                [s, s_assert, _expand(in_c)],
                jnp.zeros_like(s),
            )
        return (arena, fail), ys

    (arena, fail), ys = jax.lax.scan(
        body, (arena0, fail0), xs, unroll=SCAN_UNROLL)
    pre2 = jnp.take(ys["pre"].reshape(-1, R), couts["gidx_pre"], axis=0)
    if cfg.pre2 == 0:
        pre2 = jnp.zeros((0, R), U8)
    if mode != VERIFY_PRE and cfg.onl2 > 0:
        onl2 = jnp.take(ys["onl"].reshape(-1, R), couts["gidx_onl"], axis=0)
    else:
        onl2 = jnp.zeros((cfg.onl2, R), U8)
    out = {"onl2": onl2, "pre2": pre2, "fail": fail}
    if cfg.carry_out:
        vals = couts["carry_out_vals"]
        sel = jnp.take(arena, vals, axis=0)
        out["carry_mask2"] = (sel & jnp.uint16(0xFF)).astype(U8)
        out["carry_corr2"] = (sel >> jnp.uint16(8)).astype(U8)
    return out


def _scan_trace(cfg: _Cfg, inp, xs, couts):
    if cfg.fast2:
        return _scan_trace_fast2(cfg, inp, xs, couts)
    mode, R, has_z = cfg.mode, cfg.R, cfg.has_z

    c2 = inp if cfg.carry_in else {}
    mask2 = carry_arena(cfg.n_vals2, R, c2.get("carry_mask2"), extra_rows=1)
    corr2 = carry_arena(cfg.n_vals2, R, c2.get("carry_corr2"), extra_rows=1)
    onl2 = jnp.zeros((cfg.onl2 + 1, R), U8)
    pre2 = jnp.zeros((cfg.pre2 + 1, R), U8)
    fail = jnp.zeros((R,), jnp.bool_)

    def pad0(v, shape, dtype=U8):
        # a z64-only circuit leaves gf2-side arrays empty; gathers with
        # (ignored) index 0 still need one row
        if v is None or v.shape[0] == 0:
            return jnp.zeros(shape, dtype)
        return v

    tape2 = pad0(inp["tape2"], (1, R))
    wit2 = pad0(inp.get("wit2"), (1, R))
    in2 = pad0(inp.get("in2"), (1, R))
    co2 = pad0(inp.get("co2"), (1, R))
    re2 = pad0(inp.get("re2"), (1, R))

    # z64 arenas are also needed (untouched by the scan) when a segment only
    # passes z64 carry wires through without executing any z64 op
    if has_z or cfg.carry_inz or cfg.carry_outz:
        Vz = cfg.n_valsz
        cz = inp if cfg.carry_inz else {}
        mzlo = carry_arena(Vz, R, cz.get("carry_mzlo"), (), U32, extra_rows=1,
                           lead=(8,))
        mzhi = carry_arena(Vz, R, cz.get("carry_mzhi"), (), U32, extra_rows=1,
                           lead=(8,))
        czlo = carry_arena(Vz, R, cz.get("carry_czlo"), (), U32, extra_rows=1)
        czhi = carry_arena(Vz, R, cz.get("carry_czhi"), (), U32, extra_rows=1)
        onlz = jnp.zeros((cfg.onlz + 1, R), U8)
        prez = jnp.zeros((cfg.prez + 1, R), U8)

        def zpad(name, shape, dtype=U32):
            v = inp.get(name)
            if v is None or v.shape[0] == 0:
                return jnp.zeros(shape, dtype)
            return v

        tz_lo = zpad("tapez_lo", (1, 8, R))
        tz_hi = zpad("tapez_hi", (1, 8, R))
        wz_lo = zpad("witz_lo", (1, R))
        wz_hi = zpad("witz_hi", (1, R))
        inz_lo = zpad("inz_lo", (1, R))
        inz_hi = zpad("inz_hi", (1, R))
        coz_lo = zpad("coz_lo", (1, R))
        coz_hi = zpad("coz_hi", (1, R))
        rez_lo = zpad("rez_lo", (1, 8, R))
        rez_hi = zpad("rez_hi", (1, 8, R))

    def z64_slots(zst, w):
        """Compute one wave's Wz z64 slots and select by opcode.  Gate
        families whose opcode never appears in the circuit (cfg.zkinds) are
        skipped entirely -- e.g. a pure z64-mul chain never pays the B2A
        (Wz, 64, R) gathers, and a B2A-only circuit never pays the mul64
        chains.  Selection semantics are unchanged: a skipped family's
        condition can never be true."""
        mzlo, mzhi, czlo, czhi, onlz, prez, mask2, corr2, onl2, fail = zst
        zh = cfg.zhas
        zop = w["zop"]
        op2 = zop[:, None]  # (Wz, 1) -> (Wz, R) selects
        op3 = zop[:, None, None]  # (Wz, 8, R) / (Wz, 64, R) selects
        Wz = zop.shape[0]

        am_lo = jnp.take(mzlo, w["za"], axis=0)  # (Wz, 8, R)
        am_hi = jnp.take(mzhi, w["za"], axis=0)
        bm_lo = jnp.take(mzlo, w["zb"], axis=0)
        bm_hi = jnp.take(mzhi, w["zb"], axis=0)
        ac_lo = jnp.take(czlo, w["za"], axis=0)  # (Wz, R)
        ac_hi = jnp.take(czhi, w["za"], axis=0)
        bc_lo = jnp.take(czlo, w["zb"], axis=0)
        bc_hi = jnp.take(czhi, w["zb"], axis=0)
        t0_lo = jnp.take(tz_lo, w["zt0"], axis=0)  # (Wz, 8, R)
        t0_hi = jnp.take(tz_hi, w["zt0"], axis=0)
        k_lo = jnp.broadcast_to(w["zclo"][:, None], (Wz, R))
        k_hi = jnp.broadcast_to(w["zchi"][:, None], (Wz, R))
        zero2 = jnp.zeros((Wz, R), U32)

        # mask/corr select entries accumulate per present kind
        m_conds, m_lo, m_hi = [], [], []  # (Wz, 8, R) mask selection
        c_conds, c_lo, c_hi = [], [], []  # (Wz, R) corr selection

        if mode == VERIFY_ONL and zh(G_MUL, G_ASSERT):
            rz_lo = jnp.take(rez_lo, w["zrec"], axis=0)
            rz_hi = jnp.take(rez_hi, w["zrec"], axis=0)
        if zh(G_INPUT, B2A_CORR):
            r_lo, r_hi = _recon_sum(t0_lo, t0_hi)

        # ---- INPUT ----------------------------------------------------
        if zh(G_INPUT):
            if mode == PROVER:
                wv_lo = jnp.take(wz_lo, w["zwit"], axis=0)
                wv_hi = jnp.take(wz_hi, w["zwit"], axis=0)
                in_clo, in_chi = up.sub64(wv_lo, wv_hi, r_lo, r_hi)
            elif mode == VERIFY_ONL:
                in_clo = jnp.take(inz_lo, w["zinrec"], axis=0)
                in_chi = jnp.take(inz_hi, w["zinrec"], axis=0)
            else:
                in_clo, in_chi = zero2, zero2
            m_conds.append(op3 == G_INPUT)
            m_lo.append(t0_lo)
            m_hi.append(t0_hi)
            c_conds.append(op2 == G_INPUT)
            c_lo.append(in_clo)
            c_hi.append(in_chi)

        # ---- ADD / SUB / const families -------------------------------
        if zh(G_ADD):
            lo, hi = up.add64(am_lo, am_hi, bm_lo, bm_hi)
            m_conds.append(op3 == G_ADD)
            m_lo.append(lo)
            m_hi.append(hi)
            clo, chi = up.add64(ac_lo, ac_hi, bc_lo, bc_hi)
            c_conds.append(op2 == G_ADD)
            c_lo.append(clo)
            c_hi.append(chi)
        if zh(Z_SUB):
            lo, hi = up.sub64(am_lo, am_hi, bm_lo, bm_hi)
            m_conds.append(op3 == Z_SUB)
            m_lo.append(lo)
            m_hi.append(hi)
            clo, chi = up.sub64(ac_lo, ac_hi, bc_lo, bc_hi)
            c_conds.append(op2 == Z_SUB)
            c_lo.append(clo)
            c_hi.append(chi)
        if zh(G_ADDC, G_SUBC):
            m_conds.append((op3 == G_ADDC) | (op3 == G_SUBC))
            m_lo.append(am_lo)
            m_hi.append(am_hi)
            if zh(G_ADDC):
                clo, chi = up.add64(ac_lo, ac_hi, k_lo, k_hi)
                c_conds.append(op2 == G_ADDC)
                c_lo.append(clo)
                c_hi.append(chi)
            if zh(G_SUBC):
                clo, chi = up.sub64(ac_lo, ac_hi, k_lo, k_hi)
                c_conds.append(op2 == G_SUBC)
                c_lo.append(clo)
                c_hi.append(chi)
        if zh(G_MULC):
            lo, hi = up.mul64(am_lo, am_hi, k_lo[:, None, :], k_hi[:, None, :])
            m_conds.append(op3 == G_MULC)
            m_lo.append(lo)
            m_hi.append(hi)
            clo, chi = up.mul64(ac_lo, ac_hi, k_lo, k_hi)
            c_conds.append(op2 == G_MULC)
            c_lo.append(clo)
            c_hi.append(chi)
        if zh(G_CONST):
            c_conds.append(op2 == G_CONST)
            c_lo.append(k_lo)
            c_hi.append(k_hi)
        if zh(G_RANDOM):
            m_conds.append(op3 == G_RANDOM)
            m_lo.append(t0_lo)
            m_hi.append(t0_hi)

        # ---- MUL ------------------------------------------------------
        if zh(G_MUL):
            t1_lo = jnp.take(tz_lo, w["zt1"], axis=0)
            t1_hi = jnp.take(tz_hi, w["zt1"], axis=0)
            if mode == VERIFY_ONL:
                d_lo = jnp.take(coz_lo, w["zcorr"], axis=0)
                d_hi = jnp.take(coz_hi, w["zcorr"], axis=0)
            else:
                ra_lo, ra_hi = _recon_sum(am_lo, am_hi)
                rb_lo, rb_hi = _recon_sum(bm_lo, bm_hi)
                rc_lo, rc_hi = _recon_sum(t0_lo, t0_hi)
                p_lo, p_hi = up.mul64(ra_lo, ra_hi, rb_lo, rb_hi)
                d_lo, d_hi = up.sub64(p_lo, p_hi, rc_lo, rc_hi)
            s1_lo, s1_hi = up.mul64(bm_lo, bm_hi, ac_lo[:, None, :], ac_hi[:, None, :])
            s2_lo, s2_hi = up.mul64(am_lo, am_hi, bc_lo[:, None, :], bc_hi[:, None, :])
            s_lo, s_hi = up.add64(s1_lo, s1_hi, s2_lo, s2_hi)
            s_lo, s_hi = up.add64(s_lo, s_hi, t0_lo, t0_hi)
            s_lo, s_hi = up.sub64(s_lo, s_hi, t1_lo, t1_hi)
            if mode == VERIFY_ONL:
                s_lo, s_hi = up.add64(s_lo, s_hi, rz_lo, rz_hi)
            if mode != VERIFY_PRE:
                sr_lo, sr_hi = _recon_sum(s_lo, s_hi)
                re_lo, re_hi = up.add64(sr_lo, sr_hi, d_lo, d_hi)
            else:
                re_lo, re_hi = zero2, zero2
            pc_lo, pc_hi = up.mul64(ac_lo, ac_hi, bc_lo, bc_hi)
            clo, chi = up.add64(re_lo, re_hi, pc_lo, pc_hi)
            m_conds.append(op3 == G_MUL)
            m_lo.append(t1_lo)
            m_hi.append(t1_hi)
            c_conds.append(op2 == G_MUL)
            c_lo.append(clo)
            c_hi.append(chi)

        # ---- ASSERT ---------------------------------------------------
        if zh(G_ASSERT):
            sa_lo, sa_hi = am_lo, am_hi
            if mode == VERIFY_ONL:
                sa_lo, sa_hi = up.add64(sa_lo, sa_hi, rz_lo, rz_hi)
            if mode != VERIFY_PRE:
                ar_lo, ar_hi = _recon_sum(sa_lo, sa_hi)
                av_lo, av_hi = up.add64(ar_lo, ar_hi, ac_lo, ac_hi)
                a_bad = jnp.any(
                    ((av_lo | av_hi) != 0) & (op2 == G_ASSERT), axis=0
                )
                fail = fail | a_bad

        # ---- B2A ------------------------------------------------------
        if zh(B2A_CORR, B2A_OUT):
            bits_m = jnp.take(mask2, w["bbits"], axis=0)  # (Wz, 64, R) u8
        if zh(B2A_CORR):
            # compose the 64 fresh mask bits -> r's mask correction
            cb = _parity8(bits_m)
            cv_lo, cv_hi = _compose_bits(cb)
            if mode == VERIFY_ONL:
                bcc_lo = jnp.take(coz_lo, w["zcorr"], axis=0)
                bcc_hi = jnp.take(coz_hi, w["zcorr"], axis=0)
            else:
                bcc_lo, bcc_hi = up.sub64(cv_lo, cv_hi, r_lo, r_hi)
            m_conds.append(op3 == B2A_CORR)
            m_lo.append(t0_lo)
            m_hi.append(t0_hi)
            c_conds.append(op2 == B2A_CORR)
            c_lo.append(bcc_lo)
            c_hi.append(bcc_hi)
        if zh(B2A_OUT):
            # 64 gf2 bit reconstructions -> z64 value
            bits_c = jnp.take(corr2, w["bbits"], axis=0)
            sb = bits_m
            if mode == VERIFY_ONL:
                sb = sb ^ jnp.take(re2, w["brec"], axis=0)
            if mode != VERIFY_PRE:
                ob = _parity8(sb) ^ bits_c
            else:
                ob = bits_c
            ov_lo, ov_hi = _compose_bits(ob)
            zr_mlo = jnp.take(mzlo, w["zzr"], axis=0)
            zr_mhi = jnp.take(mzhi, w["zzr"], axis=0)
            zr_clo = jnp.take(czlo, w["zzr"], axis=0)
            zr_chi = jnp.take(czhi, w["zzr"], axis=0)
            lo, hi = up.neg64(zr_mlo, zr_mhi)
            clo, chi = up.sub64(ov_lo, ov_hi, zr_clo, zr_chi)
            m_conds.append(op3 == B2A_OUT)
            m_lo.append(lo)
            m_hi.append(hi)
            c_conds.append(op2 == B2A_OUT)
            c_lo.append(clo)
            c_hi.append(chi)

        # ---- result selection + scatters ------------------------------
        z3 = jnp.zeros_like(am_lo)
        mask_new_lo = jnp.select(m_conds, m_lo, z3) if m_conds else z3
        mask_new_hi = jnp.select(m_conds, m_hi, z3) if m_conds else z3
        corr_new_lo = jnp.select(c_conds, c_lo, zero2) if c_conds else zero2
        corr_new_hi = jnp.select(c_conds, c_hi, zero2) if c_conds else zero2

        upd = jax.lax.optimization_barrier(
            (mask_new_lo, mask_new_hi, corr_new_lo, corr_new_hi)
        )
        mzlo = mzlo.at[w["zdst"]].set(upd[0])
        mzhi = mzhi.at[w["zdst"]].set(upd[1])
        czlo = czlo.at[w["zdst"]].set(upd[2])
        czhi = czhi.at[w["zdst"]].set(upd[3])

        # prez events (8 bytes): MUL delta / B2A_CORR correction
        if zh(G_MUL) or zh(B2A_CORR):
            if zh(G_MUL) and zh(B2A_CORR):
                pe_lo = jnp.where(op2 == B2A_CORR, bcc_lo, d_lo)
                pe_hi = jnp.where(op2 == B2A_CORR, bcc_hi, d_hi)
            elif zh(B2A_CORR):
                pe_lo, pe_hi = bcc_lo, bcc_hi
            else:
                pe_lo, pe_hi = d_lo, d_hi
            pre8 = jnp.stack(up.le_bytes(pe_lo, pe_hi), axis=1)  # (Wz, 8, R)
            pre8 = jax.lax.optimization_barrier(pre8)
            prez = prez.at[w["zpre"].reshape(-1)].set(pre8.reshape(-1, R))

        if mode != VERIFY_PRE:
            # onlz events (64 rows): share bytes (MUL/ASSERT) or the
            # 8-byte input correction (first 8 rows; rest go to trash)
            if zh(G_MUL, G_ASSERT, G_INPUT):
                val64 = None
                if zh(G_MUL, G_ASSERT):
                    if zh(G_MUL) and zh(G_ASSERT):
                        se_lo = jnp.where(op3 == G_ASSERT, sa_lo, s_lo)
                        se_hi = jnp.where(op3 == G_ASSERT, sa_hi, s_hi)
                    elif zh(G_ASSERT):
                        se_lo, se_hi = sa_lo, sa_hi
                    else:
                        se_lo, se_hi = s_lo, s_hi
                    # player-major: (Wz, 8p, 8b, R) stack + free reshape
                    sh64 = jnp.stack(up.le_bytes(se_lo, se_hi), axis=2)
                    val64 = sh64.reshape(Wz, 64, R)
                if zh(G_INPUT):
                    in8 = jnp.stack(up.le_bytes(in_clo, in_chi), axis=1)
                    in64 = jnp.concatenate(
                        [in8, jnp.zeros((Wz, 56, R), U8)], axis=1
                    )
                    val64 = (
                        in64 if val64 is None
                        else jnp.where(op3 == G_INPUT, in64, val64)
                    )
                val64 = jax.lax.optimization_barrier(val64)
                onlz = onlz.at[w["zonl"].reshape(-1)].set(val64.reshape(-1, R))
            if zh(B2A_OUT):
                # B2A_OUT writes its 64 bit-reconstruction events into the
                # GF2 online stream
                sb_w = jnp.where(op3 == B2A_OUT, sb, jnp.zeros_like(sb))
                sb_w = jax.lax.optimization_barrier(sb_w)
                onl2 = onl2.at[w["bonl"].reshape(-1)].set(sb_w.reshape(-1, R))

        return (mzlo, mzhi, czlo, czhi, onlz, prez, mask2, corr2, onl2,
                fail)

    def body(carry, w):
        if has_z:
            (mask2, corr2, onl2, pre2, fail,
             mzlo, mzhi, czlo, czhi, onlz, prez) = carry
        else:
            mask2, corr2, onl2, pre2, fail = carry
        if has_z:
            # z64 slots read the GF2 arenas (B2A) from the carry-in state:
            # wave placement guarantees their GF2 dependencies come from
            # strictly earlier waves
            (mzlo, mzhi, czlo, czhi, onlz, prez,
             mask2_unused, corr2_unused, onl2, fail) = z64_slots(
                (mzlo, mzhi, czlo, czhi, onlz, prez, mask2, corr2, onl2,
                 fail), w)
        op = w["op"][:, None]  # (W, 1)
        a_m = jnp.take(mask2, w["a"], axis=0)
        a_c = jnp.take(corr2, w["a"], axis=0)
        b_m = jnp.take(mask2, w["b"], axis=0)
        b_c = jnp.take(corr2, w["b"], axis=0)
        t0 = jnp.take(tape2, w["t0"], axis=0)
        t1 = jnp.take(tape2, w["t1"], axis=0)
        cbit = w["cbit"].astype(U8)[:, None]

        # ---- MUL family -----------------------------------------------
        if mode == VERIFY_ONL:
            delta = jnp.take(co2, w["corr"], axis=0)
        else:
            delta = (_parity8(a_m) & _parity8(b_m)) ^ _parity8(t0)
        s = (b_m & _expand(a_c)) ^ (a_m & _expand(b_c)) ^ t0 ^ t1
        if mode == VERIFY_ONL:
            msg = jnp.take(re2, w["rec"], axis=0)
            s = s ^ msg
        if mode != VERIFY_PRE:
            recon = _parity8(s) ^ delta
        else:
            recon = jnp.zeros_like(s)
        mul_corr = recon ^ (a_c & b_c)

        # ---- INPUT ----------------------------------------------------
        if mode == PROVER:
            in_c = jnp.take(wit2, w["wit"], axis=0) ^ _parity8(t0)
        elif mode == VERIFY_ONL:
            in_c = jnp.take(in2, w["inrec"], axis=0)
        else:
            in_c = jnp.zeros_like(a_c)

        # ---- ASSERT ---------------------------------------------------
        s_assert = a_m
        if mode == VERIFY_ONL:
            s_assert = s_assert ^ msg
        if mode != VERIFY_PRE:
            a_nonzero = (_parity8(s_assert) ^ a_c) != 0
            fail = fail | jnp.any((op == G_ASSERT) & a_nonzero, axis=0)

        # ---- result selection ----------------------------------------
        mask_new = jnp.select(
            [op == G_MUL, op == G_INPUT, op == G_ADD,
             (op == G_ADDC) | (op == G_SUBC), op == G_MULC,
             op == G_RANDOM],
            [t1, t0, a_m ^ b_m, a_m, a_m & _expand(cbit), t0],
            jnp.zeros_like(a_m),
        )
        corr_new = jnp.select(
            [op == G_MUL, op == G_INPUT, op == G_ADD,
             (op == G_ADDC) | (op == G_SUBC), op == G_MULC,
             op == G_CONST],
            [mul_corr, in_c, a_c ^ b_c, a_c ^ cbit, a_c & cbit, cbit],
            jnp.zeros_like(a_c),
        )

        # ---- scatters -------------------------------------------------
        mask_new, corr_new = jax.lax.optimization_barrier((mask_new, corr_new))
        mask2 = mask2.at[w["dst"]].set(mask_new)
        corr2 = corr2.at[w["dst"]].set(corr_new)

        if mode != VERIFY_PRE:
            onl_val = jnp.select(
                [op == G_MUL, op == G_ASSERT, op == G_INPUT],
                [s, s_assert, _expand(in_c)],
                jnp.zeros_like(s),
            )
            onl_val = jax.lax.optimization_barrier(onl_val)
            onl2 = onl2.at[w["onl"]].set(onl_val)
        pre_val = jax.lax.optimization_barrier(_expand(delta))
        pre2 = pre2.at[w["pre"]].set(pre_val)

        if has_z:
            return (mask2, corr2, onl2, pre2, fail,
                    mzlo, mzhi, czlo, czhi, onlz, prez), None
        return (mask2, corr2, onl2, pre2, fail), None

    if has_z:
        carry = (mask2, corr2, onl2, pre2, fail,
                 mzlo, mzhi, czlo, czhi, onlz, prez)
        (mask2, corr2, onl2, pre2, fail,
         mzlo, mzhi, czlo, czhi, onlz, prez), _ = jax.lax.scan(
            body, carry, xs)
        out = {"onl2": onl2[:-1], "pre2": pre2[:-1],
               "onlz": onlz[:-1], "prez": prez[:-1], "fail": fail}
    else:
        carry = (mask2, corr2, onl2, pre2, fail)
        (mask2, corr2, onl2, pre2, fail), _ = jax.lax.scan(body, carry, xs)
        out = {"onl2": onl2[:-1], "pre2": pre2[:-1], "fail": fail}
    if cfg.carry_out:
        vals = couts["carry_out_vals"]
        out["carry_mask2"] = jnp.take(mask2, vals, axis=0)
        out["carry_corr2"] = jnp.take(corr2, vals, axis=0)
    if cfg.carry_outz:
        valsz = couts["carry_outz_vals"]
        out["carry_mzlo"] = jnp.take(mzlo, valsz, axis=0)
        out["carry_mzhi"] = jnp.take(mzhi, valsz, axis=0)
        out["carry_czlo"] = jnp.take(czlo, valsz, axis=0)
        out["carry_czhi"] = jnp.take(czhi, valsz, axis=0)
    return out
