"""Circuit compiler for the device backend.

The reference interprets gates one at a time (src/interpreter/single.rs:106-
157); the device executes the circuit as *levelized batched tensor ops*
instead.
This compiler turns a composite program into static-level gate tables:

  * SSA conversion: the mutable wire arena becomes an immutable value arena
    (each gate output is a fresh value id), so gates within a level are
    trivially independent (safe to execute batched).
  * Level assignment: level(gate) = 1 + max(level(operand producers)).
  * Static stream assignment, exactly reproducing the reference's sequential
    transcript order (critical for bit-identical proofs):
      - mask tape indices (ShareGen.next() call order, generator/share.rs)
      - online/preprocess transcript byte offsets per domain
        (gf2 events are 1 byte/rep; z64 input/corr 8 bytes, share 64 bytes)
      - witness indices, and record indices for recons/corrs/inputs
  * B2A macro-expansion (combine.rs:132-219): 64 fresh bit masks, a z64
    correction, a 63-AND ripple-carry adder, 64 bit reconstructions -- all in
    the reference's exact tape/event order.

Because hashing order is determined by the *compile-time* slot assignment,
execution order is free: levels run in any schedule and the transcript bytes
land in their program-order positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .ir import ONE_SRC_OPS, TWO_SRC_OPS, CombineOp, Gate, Kind, Op

# Compiled gate kinds (per domain).
G_INPUT = 0
G_ADD = 1  # also SUB (gf2: same op; z64 uses Z_SUB)
G_ADDC = 2
G_SUBC = 3
G_MULC = 4
G_MUL = 5
G_ASSERT = 6
G_RANDOM = 7
G_CONST = 8
Z_SUB = 9  # z64 subtraction (distinct from add)
B2A_CORR = 10  # defines the z64 'r' value + its correction event
B2A_OUT = 11  # 64 bit reconstructions + z64 destination write

N_KINDS = 12

# Bytes per event in the per-rep transcript streams.
GF2_EVENT = 1
Z64_CORR_EVENT = 8
Z64_SHARE_EVENT = 64


class _DomState:
    """Per-domain compile-time counters + SSA map."""

    def __init__(self) -> None:
        self.wire_to_val: Dict[int, int] = {}
        self.val_level: List[int] = [0]  # value 0 = constant zero
        self.n_vals = 1
        self.tape = 0  # masks consumed
        self.onl = 0  # online stream bytes
        self.pre = 0  # preprocess stream bytes
        self.n_inputs = 0
        self.n_corrs = 0
        self.n_recons = 0
        self.wit = 0  # witness elements consumed

    def read(self, wire: int) -> int:
        return self.wire_to_val.get(wire, 0)

    def write(self, wire: int, level: int) -> int:
        vid = self.n_vals
        self.n_vals += 1
        self.val_level.append(level)
        self.wire_to_val[wire] = vid
        return vid

    def fresh(self, level: int) -> int:
        vid = self.n_vals
        self.n_vals += 1
        self.val_level.append(level)
        return vid


@dataclasses.dataclass
class CompiledCircuit:
    levels: List[Dict[int, Dict[str, np.ndarray]]]  # [level][domain*N_KINDS+kind] -> cols
    n_vals2: int
    n_valsz: int
    m2: int
    mz: int
    onl2: int  # gf2 online stream bytes per rep
    pre2: int
    onlz: int
    prez: int
    n_wit2: int
    n_witz: int
    n_inputs2: int
    n_corrs2: int
    n_recons2: int
    n_inputsz: int
    n_corrsz: int
    n_reconsz: int
    # byte offsets of each record in its stream (for extraction/injection)
    input_slots2: np.ndarray  # (n_inputs2,) online byte offsets
    corr_slots2: np.ndarray
    recon_slots2: np.ndarray
    input_slotsz: np.ndarray
    corr_slotsz: np.ndarray
    recon_slotsz: np.ndarray

    @property
    def depth(self) -> int:
        return len(self.levels)


def _key(domain: int, kind: int) -> int:
    return domain * N_KINDS + kind


GF2, Z64D = 0, 1


class _Builder:
    def __init__(self) -> None:
        self.rows: Dict[int, Dict[int, List[dict]]] = {}  # level -> key -> rows
        self.max_level = 0

    def emit(self, level: int, domain: int, kind: int, **cols) -> None:
        self.rows.setdefault(level, {}).setdefault(_key(domain, kind), []).append(cols)
        self.max_level = max(self.max_level, level)


def _compile_cache_salt() -> bytes:
    """Invalidate cached CompiledCircuits whenever the levelizer or the IR
    semantics change (ir.py defines the gate/op encoding the compile pass
    interprets)."""
    import hashlib
    import os

    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("compile.py", "ir.py"):
        try:
            with open(os.path.join(here, name), "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"missing:" + name.encode())
    return h.digest()[:8]


def compile_program(program: Sequence[CombineOp],
                    carry_in: Optional[Sequence[int]] = None,
                    out_val_map: Optional[Dict[int, int]] = None,
                    carry_inz: Optional[Sequence[int]] = None,
                    out_val_mapz: Optional[Dict[int, int]] = None,
                    cache_key: Optional[bytes] = None) -> CompiledCircuit:
    """carry_in / carry_inz: GF2 / Z64 wire ids whose values enter this
    (sub)program from a previous segment; they are pre-assigned value slots
    1..len(carry) in order per domain.  out_val_map / out_val_mapz (if given)
    are filled with the final wire->value slot maps (streaming segmentation,
    see backend/streaming.py).

    cache_key: opaque bytes that uniquely identify `program` (e.g. the
    program file's raw bytes, or a builder name+params string) -- enables a
    pickle disk cache under REVERIE_COMPILE_CACHE (default
    `<repo>/.circuit_cache`), salted with this module's source hash.
    The levelizer is a pure-Python per-gate pass (~10 s at 1M gates), a
    fixed warm-start cost for repeat circuits otherwise.  Only valid
    without carry/out_val_map plumbing (whole-program compiles)."""
    import hashlib
    import os
    import pickle

    cpath = None
    if (cache_key is not None and carry_in is None and out_val_map is None
            and carry_inz is None and out_val_mapz is None):
        from ..utils.compile_cache import REPO_ROOT

        cdir = os.environ.get("REVERIE_COMPILE_CACHE",
                              os.path.join(REPO_ROOT, ".circuit_cache"))
        if cdir not in ("", "0"):
            h = hashlib.sha256(_compile_cache_salt() + cache_key).hexdigest()
            cpath = os.path.join(cdir, h + ".pkl")
            try:
                with open(cpath, "rb") as f:
                    return pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError,
                    AttributeError):
                pass
    d2 = _DomState()
    dz = _DomState()
    if carry_in:
        for w in carry_in:
            d2.write(w, 0)
    if carry_inz:
        for w in carry_inz:
            dz.write(w, 0)
    b = _Builder()
    in_slots2: List[int] = []
    co_slots2: List[int] = []
    re_slots2: List[int] = []
    in_slotsz: List[int] = []
    co_slotsz: List[int] = []
    re_slotsz: List[int] = []

    def emit_gate(domain: int, g: Gate) -> None:
        d = d2 if domain == GF2 else dz
        ev_in = GF2_EVENT if domain == GF2 else Z64_CORR_EVENT
        ev_sh = GF2_EVENT if domain == GF2 else Z64_SHARE_EVENT
        islots = in_slots2 if domain == GF2 else in_slotsz
        cslots = co_slots2 if domain == GF2 else co_slotsz
        rslots = re_slots2 if domain == GF2 else re_slotsz
        op = g.op
        if op == Op.INPUT:
            v = d.fresh(0)
            b.emit(0, domain, G_INPUT, dst=v, tape=d.tape, wit=d.wit, onl=d.onl, rec=d.n_inputs)
            d.tape += 1
            d.wit += 1
            islots.append(d.onl)
            d.onl += ev_in
            d.n_inputs += 1
            d.wire_to_val[g.dst] = v
        elif op in (Op.ADD, Op.SUB):
            a, c = d.read(g.src1), d.read(g.src2)
            lvl = max(d.val_level[a], d.val_level[c])
            v = d.write(g.dst, lvl + 1)
            kind = G_ADD if (op == Op.ADD or domain == GF2) else Z_SUB
            b.emit(lvl + 1, domain, kind, dst=v, a=a, b=c)
        elif op in (Op.ADDC, Op.SUBC, Op.MULC):
            a = d.read(g.src1)
            lvl = d.val_level[a]
            v = d.write(g.dst, lvl + 1)
            kind = {Op.ADDC: G_ADDC, Op.SUBC: G_SUBC, Op.MULC: G_MULC}[op]
            b.emit(lvl + 1, domain, kind, dst=v, a=a, const=g.const)
        elif op == Op.MUL:
            a, c = d.read(g.src1), d.read(g.src2)
            lvl = max(d.val_level[a], d.val_level[c]) + 1
            v = d.write(g.dst, lvl)
            b.emit(
                lvl, domain, G_MUL,
                dst=v, a=a, b=c,
                tape_ab=d.tape, tape_new=d.tape + 1,
                onl=d.onl, pre=d.pre, rec=d.n_recons, corr=d.n_corrs,
            )
            d.tape += 2
            cslots.append(d.pre)
            rslots.append(d.onl)
            d.pre += ev_in
            d.onl += ev_sh
            d.n_corrs += 1
            d.n_recons += 1
        elif op == Op.ASSERT_ZERO:
            a = d.read(g.src1)
            lvl = d.val_level[a] + 1
            b.emit(lvl, domain, G_ASSERT, a=a, onl=d.onl, rec=d.n_recons)
            rslots.append(d.onl)
            d.onl += ev_sh
            d.n_recons += 1
        elif op == Op.RANDOM:
            v = d.fresh(0)
            b.emit(0, domain, G_RANDOM, dst=v, tape=d.tape)
            d.tape += 1
            d.wire_to_val[g.dst] = v
        elif op == Op.CONST:
            v = d.fresh(0)
            b.emit(0, domain, G_CONST, dst=v, const=g.const)
            d.wire_to_val[g.dst] = v
        else:
            raise ValueError(f"bad opcode {op}")

    def emit_b2a(dst: int, src: int) -> None:
        # 1) 64 fresh gf2 bit masks (tape order first, combine.rs:140-151)
        fresh = []
        for _ in range(64):
            v = d2.fresh(0)
            b.emit(0, GF2, G_RANDOM, dst=v, tape=d2.tape)
            d2.tape += 1
            fresh.append(v)
        # 2) z64 mask + correction -> value r
        zr = dz.fresh(1)
        b.emit(1, Z64D, B2A_CORR, dst=zr, tape=dz.tape, bits=list(fresh),
               pre=dz.pre, corr=dz.n_corrs)
        dz.tape += 1
        co_slotsz.append(dz.pre)
        dz.pre += Z64_CORR_EVENT
        dz.n_corrs += 1
        # 3) ripple-carry adder over (fresh, wires[src..src+64])
        a_ids = fresh
        b_ids = [d2.read(src + i) for i in range(64)]

        def gf2_mul(x: int, y: int) -> int:
            lvl = max(d2.val_level[x], d2.val_level[y]) + 1
            v = d2.fresh(lvl)
            b.emit(lvl, GF2, G_MUL, dst=v, a=x, b=y,
                   tape_ab=d2.tape, tape_new=d2.tape + 1,
                   onl=d2.onl, pre=d2.pre, rec=d2.n_recons, corr=d2.n_corrs)
            d2.tape += 2
            co_slots2.append(d2.pre)
            re_slots2.append(d2.onl)
            d2.pre += GF2_EVENT
            d2.onl += GF2_EVENT
            d2.n_corrs += 1
            d2.n_recons += 1
            return v

        def gf2_add(x: int, y: int) -> int:
            lvl = max(d2.val_level[x], d2.val_level[y]) + 1
            v = d2.fresh(lvl)
            b.emit(lvl, GF2, G_ADD, dst=v, a=x, b=y)
            return v

        res = [0] * 64
        carry = gf2_mul(a_ids[0], b_ids[0])
        res[0] = gf2_add(a_ids[0], b_ids[0])
        for i in range(1, 63):
            ac = gf2_add(a_ids[i], carry)
            bc = gf2_add(b_ids[i], carry)
            ac_bc = gf2_mul(ac, bc)
            res[i] = gf2_add(ac, b_ids[i])
            carry = gf2_add(ac_bc, carry)
        res[63] = gf2_add(carry, gf2_add(a_ids[63], b_ids[63]))

        # 4) 64 bit reconstructions + z64 destination
        lvl = max(max(d2.val_level[v] for v in res), dz.val_level[zr]) + 1
        zv = dz.write(dst, lvl)
        b.emit(lvl, Z64D, B2A_OUT, dst=zv, zr=zr, bits=list(res),
               onl=d2.onl, rec=d2.n_recons)
        for _ in range(64):
            re_slots2.append(d2.onl)
            d2.onl += GF2_EVENT
            d2.n_recons += 1

    for cop in program:
        if cop.kind == Kind.GF2:
            emit_gate(GF2, cop.gate)
        elif cop.kind == Kind.Z64:
            emit_gate(Z64D, cop.gate)
        elif cop.kind == Kind.B2A:
            emit_b2a(cop.a, cop.b)
        # SizeHint: no-op for SSA compilation

    if out_val_map is not None:
        out_val_map.update(d2.wire_to_val)
    if out_val_mapz is not None:
        out_val_mapz.update(dz.wire_to_val)

    # materialize levels into numpy column arrays
    levels: List[Dict[int, Dict[str, np.ndarray]]] = []
    for lvl in range(b.max_level + 1):
        table: Dict[int, Dict[str, np.ndarray]] = {}
        for key, rows in b.rows.get(lvl, {}).items():
            cols: Dict[str, np.ndarray] = {}
            for name in rows[0]:
                vals = [r[name] for r in rows]
                if name == "bits":
                    cols[name] = np.asarray(vals, dtype=np.int32)  # (k, 64)
                elif name == "const":
                    cols[name] = np.asarray(vals, dtype=np.uint64)
                else:
                    cols[name] = np.asarray(vals, dtype=np.int32)
            table[key] = cols
        if table:
            levels.append(table)

    cc = CompiledCircuit(
        levels=levels,
        n_vals2=d2.n_vals,
        n_valsz=dz.n_vals,
        m2=d2.tape,
        mz=dz.tape,
        onl2=d2.onl,
        pre2=d2.pre,
        onlz=dz.onl,
        prez=dz.pre,
        n_wit2=d2.wit,
        n_witz=dz.wit,
        n_inputs2=d2.n_inputs,
        n_corrs2=d2.n_corrs,
        n_recons2=d2.n_recons,
        n_inputsz=dz.n_inputs,
        n_corrsz=dz.n_corrs,
        n_reconsz=dz.n_recons,
        input_slots2=np.asarray(in_slots2, dtype=np.int64),
        corr_slots2=np.asarray(co_slots2, dtype=np.int64),
        recon_slots2=np.asarray(re_slots2, dtype=np.int64),
        input_slotsz=np.asarray(in_slotsz, dtype=np.int64),
        corr_slotsz=np.asarray(co_slotsz, dtype=np.int64),
        recon_slotsz=np.asarray(re_slotsz, dtype=np.int64),
    )
    if cpath is not None:
        import os
        import pickle

        try:
            os.makedirs(os.path.dirname(cpath), exist_ok=True)
            tmp = cpath + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(cc, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, cpath)
        except OSError:
            pass
    return cc


# ---------------------------------------------------------------------------
# Program segmentation for streaming execution (beyond-HBM circuits)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Segment:
    """One compiled streaming segment.

    Streams/tape/witness offsets inside `cc` are LOCAL (start at 0); the
    global bases below place them in the whole-circuit streams so transcript
    bytes and challenge derivation are byte-identical to unsegmented proving
    (SURVEY hard-part 5: segment the op list, carry hash states + tape
    counters + live wires).  Cross-segment live wires are carried per domain
    (GF2 arena rows; Z64 mask/corr u64-pair rows)."""

    cc: CompiledCircuit
    carry_in: List[int]  # GF2 wire ids entering (arena slots 1..k, in order)
    carry_out: List[int]  # GF2 wire ids leaving (read by later segments)
    carry_out_vals: np.ndarray  # their value slots in this segment's arena
    # for each carry_in wire (in order): (source segment, row in its
    # carry_out arrays) -- the last segment that wrote the wire before this one
    carry_src: List[tuple]
    tape0: int  # global tape-word base
    wit0: int  # global witness base
    onl0: int  # global online-stream byte base
    pre0: int
    rec0: int  # global record-count bases
    cor0: int
    inp0: int
    # -- z64 domain (mirrors the gf2 fields) --------------------------------
    carry_inz: List[int] = dataclasses.field(default_factory=list)
    carry_outz: List[int] = dataclasses.field(default_factory=list)
    carry_outz_vals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    carry_srcz: List[tuple] = dataclasses.field(default_factory=list)
    tapez0: int = 0
    witz0: int = 0
    onlz0: int = 0
    prez0: int = 0
    recz0: int = 0
    corz0: int = 0
    inpz0: int = 0


def _gate_reads(g: Gate) -> List[int]:
    if g.op in TWO_SRC_OPS:
        return [g.src1, g.src2]
    if g.op in ONE_SRC_OPS or g.op == Op.ASSERT_ZERO:
        return [g.src1]
    return []


def compile_segments(program: Sequence[CombineOp], seg_ops: int) -> List[Segment]:
    """Split a composite program into segments of <= seg_ops ops each and
    compile each with per-domain carry-in/out wire lists (cross-segment live
    wires).  B2A ops read gf2 wires [src, src+64) and write one z64 wire."""
    ops = list(program)
    n = len(ops)
    bounds = [(i, min(i + seg_ops, n)) for i in range(0, n, seg_ops)]
    n_seg = len(bounds)

    # one forward scan per domain: current writer segment per wire
    class _Cross:
        def __init__(self):
            self.writer: Dict[int, int] = {}
            self.in_sets: List[Dict[int, int]] = [dict() for _ in range(n_seg)]
            self.out_sets: List[Dict[int, None]] = [dict() for _ in range(n_seg)]

        def read(self, s: int, w: int) -> None:
            src = self.writer.get(w)
            if src is not None and src != s:
                self.in_sets[s].setdefault(w, src)
                self.out_sets[src].setdefault(w)

        def write(self, s: int, w: Optional[int]) -> None:
            if w is not None:
                self.writer[w] = s

    x2, xz = _Cross(), _Cross()
    for s, (lo, hi) in enumerate(bounds):
        for cop in ops[lo:hi]:
            if cop.kind == Kind.SIZE_HINT:
                continue
            if cop.kind == Kind.B2A:
                for i in range(64):
                    x2.read(s, cop.b + i)
                xz.write(s, cop.a)
                continue
            x = x2 if cop.kind == Kind.GF2 else xz
            g = cop.gate
            for w in _gate_reads(g):
                x.read(s, w)
            x.write(s, g.dst_wire())

    def rows(x: _Cross):
        outs = [sorted(x.out_sets[s]) for s in range(n_seg)]
        return outs, [{w: i for i, w in enumerate(co)} for co in outs]

    carry_outs, out_row = rows(x2)
    carry_outsz, out_rowz = rows(xz)

    segments: List[Segment] = []
    tape0 = wit0 = onl0 = pre0 = rec0 = cor0 = inp0 = 0
    tapez0 = witz0 = onlz0 = prez0 = recz0 = corz0 = inpz0 = 0
    for s, (lo, hi) in enumerate(bounds):
        carry_in = sorted(x2.in_sets[s])
        carry_inz = sorted(xz.in_sets[s])
        final_val: Dict[int, int] = {}
        final_valz: Dict[int, int] = {}
        cc = compile_program(ops[lo:hi], carry_in=carry_in, out_val_map=final_val,
                             carry_inz=carry_inz, out_val_mapz=final_valz)
        segments.append(Segment(
            cc=cc, carry_in=carry_in, carry_out=carry_outs[s],
            carry_out_vals=np.asarray([final_val[w] for w in carry_outs[s]],
                                      dtype=np.int32),
            carry_src=[
                (x2.in_sets[s][w], out_row[x2.in_sets[s][w]][w])
                for w in carry_in
            ],
            tape0=tape0, wit0=wit0, onl0=onl0, pre0=pre0,
            rec0=rec0, cor0=cor0, inp0=inp0,
            carry_inz=carry_inz, carry_outz=carry_outsz[s],
            carry_outz_vals=np.asarray([final_valz[w] for w in carry_outsz[s]],
                                       dtype=np.int32),
            carry_srcz=[
                (xz.in_sets[s][w], out_rowz[xz.in_sets[s][w]][w])
                for w in carry_inz
            ],
            tapez0=tapez0, witz0=witz0, onlz0=onlz0, prez0=prez0,
            recz0=recz0, corz0=corz0, inpz0=inpz0,
        ))
        tape0 += cc.m2
        wit0 += cc.n_wit2
        onl0 += cc.onl2
        pre0 += cc.pre2
        rec0 += cc.n_recons2
        cor0 += cc.n_corrs2
        inp0 += cc.n_inputs2
        tapez0 += cc.mz
        witz0 += cc.n_witz
        onlz0 += cc.onlz
        prez0 += cc.prez
        recz0 += cc.n_reconsz
        corz0 += cc.n_corrsz
        inpz0 += cc.n_inputsz
    return segments


@dataclasses.dataclass
class WaveTable:
    """Uniform (n_waves, W) gate tables for lax.scan execution.

    Every slot carries a unified gate encoding; unused fields point at trash
    rows (dst = n_vals, onl/pre = stream length) so the scan body is fully
    uniform.  Each wave carries W GF2 slots plus (when the circuit has z64 or
    B2A ops) Wz z64-side slots; B2A_CORR/B2A_OUT are z64-side slots that
    additionally index the GF2 arenas/streams through the b* columns.
    """

    op: np.ndarray  # (n, W) int32 opcode (G_*)
    dst: np.ndarray
    a: np.ndarray
    b: np.ndarray
    t0: np.ndarray  # tape index (INPUT/RANDOM mask, MUL mask_ab)
    t1: np.ndarray  # MUL mask_new
    wit: np.ndarray  # witness index (INPUT)
    inrec: np.ndarray  # input record index (INPUT)
    rec: np.ndarray  # recon record index (MUL/ASSERT)
    corr: np.ndarray  # correction record index (MUL)
    onl: np.ndarray  # online byte slot (or trash)
    pre: np.ndarray  # preprocess byte slot (or trash)
    cbit: np.ndarray  # constant bit

    # -- z64-side slot columns; None when the circuit is pure GF2 ----------
    zop: Optional[np.ndarray] = None  # (n, Wz) opcode (G_* | Z_SUB | B2A_*)
    zdst: Optional[np.ndarray] = None  # z64 value slot (trash = n_valsz)
    za: Optional[np.ndarray] = None
    zb: Optional[np.ndarray] = None
    zt0: Optional[np.ndarray] = None  # z64 tape row (INPUT/RANDOM/B2A_CORR/MUL ab)
    zt1: Optional[np.ndarray] = None  # z64 tape row (MUL new)
    zwit: Optional[np.ndarray] = None  # z64 witness index (INPUT)
    zinrec: Optional[np.ndarray] = None  # z64 input record (INPUT)
    zrec: Optional[np.ndarray] = None  # z64 recon record (MUL/ASSERT)
    zcorr: Optional[np.ndarray] = None  # z64 correction record (MUL/B2A_CORR)
    zzr: Optional[np.ndarray] = None  # z64 'r' value slot (B2A_OUT)
    zclo: Optional[np.ndarray] = None  # (n, Wz) uint32 const low word
    zchi: Optional[np.ndarray] = None
    zonl: Optional[np.ndarray] = None  # (n, Wz, 64) onlz byte rows (trash-padded)
    zpre: Optional[np.ndarray] = None  # (n, Wz, 8) prez byte rows
    bbits: Optional[np.ndarray] = None  # (n, Wz, 64) gf2 value slots (B2A bits)
    brec: Optional[np.ndarray] = None  # (n, Wz, 64) gf2 recon records (B2A_OUT)
    bonl: Optional[np.ndarray] = None  # (n, Wz, 64) gf2 onl byte rows (B2A_OUT)

    @property
    def n_waves(self) -> int:
        return self.op.shape[0]

    @property
    def has_z64(self) -> bool:
        return self.zop is not None


_NOP = 127  # opcode for padding slots


_GF2_COLS = ("op", "dst", "a", "b", "t0", "t1", "wit", "inrec", "rec",
             "corr", "onl", "pre", "cbit")
_Z64_SCALAR_COLS = ("zop", "zdst", "za", "zb", "zt0", "zt1", "zwit",
                    "zinrec", "zrec", "zcorr", "zzr", "zclo", "zchi")
_Z64_VEC_COLS = ("zonl", "zpre", "bbits", "brec", "bonl")


def _circuit_has_z64(cc: CompiledCircuit) -> bool:
    for lvl_tables in cc.levels:
        for key in lvl_tables:
            if key // N_KINDS != GF2:
                return True
    return False


def build_waves(cc: CompiledCircuit, W: int = 256, Wz: int = 0) -> WaveTable:
    """Pack the levelized gates into fixed-width waves.

    A gate lands in the first non-full wave strictly after the waves that
    produced its operands (SSA guarantees correctness for any such packing;
    z64/B2A slots additionally wait for their GF2 dependencies).  Each wave
    has W GF2 slots and, when the circuit has z64/B2A ops, Wz z64 slots.
    """
    has_z = _circuit_has_z64(cc)
    if has_z and Wz <= 0:
        nz = sum(
            len(next(iter(cols.values())))
            for lvl in cc.levels
            for key, cols in lvl.items()
            if key // N_KINDS != GF2
        )
        mean = max(1, nz // max(1, cc.depth))
        Wz = 4
        while Wz < min(64, 2 * mean):
            Wz *= 2

    waves: List[Dict[str, List]] = []
    fill: List[int] = []
    fillz: List[int] = []
    wave_of_val = np.full(max(cc.n_vals2, 1), -1, dtype=np.int64)
    wave_of_valz = np.full(max(cc.n_valsz, 1), -1, dtype=np.int64)
    trash_dst = cc.n_vals2
    trash_onl = cc.onl2
    trash_pre = cc.pre2
    trash_dstz = cc.n_valsz
    trash_onlz = cc.onlz
    trash_prez = cc.prez

    def new_wave() -> int:
        waves.append({k: [] for k in
                      _GF2_COLS + _Z64_SCALAR_COLS + _Z64_VEC_COLS})
        fill.append(0)
        fillz.append(0)
        return len(waves) - 1

    def place(w_min: int, z: bool, cols: dict) -> int:
        f = fillz if z else fill
        cap = Wz if z else W
        w = max(w_min, 0)
        while True:
            while w >= len(waves):
                new_wave()
            if f[w] < cap:
                break
            w += 1
        tbl = waves[w]
        names = (_Z64_SCALAR_COLS + _Z64_VEC_COLS) if z else _GF2_COLS
        for k in names:
            tbl[k].append(cols.get(k, 0))
        f[w] += 1
        return w

    for lvl_tables in cc.levels:
        for key, cols in sorted(lvl_tables.items()):
            domain, kind = divmod(key, N_KINDS)
            n = len(next(iter(cols.values())))
            for i in range(n):
                g = {
                    k: (v[i] if k == "bits" else int(v[i]))
                    for k, v in cols.items()
                }
                if domain == GF2:
                    deps = [
                        wave_of_val[g[dk]] for dk in ("a", "b") if dk in g
                    ]
                    w_min = (max(deps) + 1) if deps else 0
                    row = dict(
                        op=kind,
                        dst=g.get("dst", trash_dst),
                        a=g.get("a", 0),
                        b=g.get("b", 0),
                        t0=g.get("tape", g.get("tape_ab", 0)),
                        t1=g.get("tape_new", 0),
                        wit=g.get("wit", 0),
                        inrec=g.get("rec", 0) if kind == G_INPUT else 0,
                        rec=g.get("rec", 0) if kind in (G_MUL, G_ASSERT) else 0,
                        corr=g.get("corr", 0),
                        onl=g.get("onl", trash_onl)
                        if kind in (G_MUL, G_ASSERT, G_INPUT) else trash_onl,
                        pre=g.get("pre", trash_pre) if kind == G_MUL else trash_pre,
                        cbit=int(g.get("const", 0)) & 1,
                    )
                    w = place(w_min, False, row)
                    if "dst" in g:
                        wave_of_val[g["dst"]] = w
                else:
                    deps = [
                        wave_of_valz[g[dk]] for dk in ("a", "b", "zr") if dk in g
                    ]
                    if "bits" in g:
                        deps.extend(wave_of_val[int(v)] for v in g["bits"])
                    w_min = (max(deps) + 1) if deps else 0
                    const = int(g.get("const", 0))
                    # z64 online event rows: MUL/ASSERT share events are 64
                    # bytes, INPUT correction events 8; unused rows -> trash
                    if kind in (G_MUL, G_ASSERT):
                        zonl = list(range(g["onl"], g["onl"] + 64))
                    elif kind == G_INPUT:
                        zonl = list(range(g["onl"], g["onl"] + 8)) + [trash_onlz] * 56
                    else:
                        zonl = [trash_onlz] * 64
                    if kind in (G_MUL, B2A_CORR):
                        zpre = list(range(g["pre"], g["pre"] + 8))
                    else:
                        zpre = [trash_prez] * 8
                    if kind in (B2A_CORR, B2A_OUT):
                        bbits = [int(v) for v in g["bits"]]
                    else:
                        bbits = [trash_dst] * 64
                    if kind == B2A_OUT:
                        brec = list(range(g["rec"], g["rec"] + 64))
                        bonl = list(range(g["onl"], g["onl"] + 64))
                    else:
                        brec = [0] * 64
                        bonl = [trash_onl] * 64
                    row = dict(
                        zop=kind,
                        zdst=g.get("dst", trash_dstz),
                        za=g.get("a", 0),
                        zb=g.get("b", 0),
                        zt0=g.get("tape", g.get("tape_ab", 0)),
                        zt1=g.get("tape_new", 0),
                        zwit=g.get("wit", 0),
                        zinrec=g.get("rec", 0) if kind == G_INPUT else 0,
                        zrec=g.get("rec", 0) if kind in (G_MUL, G_ASSERT) else 0,
                        zcorr=g.get("corr", 0),
                        zzr=g.get("zr", 0),
                        zclo=const & 0xFFFFFFFF,
                        zchi=(const >> 32) & 0xFFFFFFFF,
                        zonl=zonl, zpre=zpre, bbits=bbits, brec=brec, bonl=bonl,
                    )
                    w = place(w_min, True, row)
                    if "dst" in g:
                        wave_of_valz[g["dst"]] = w

    # pad every wave to W / Wz with NOP slots
    for tbl, cnt, cntz in zip(waves, fill, fillz):
        for _ in range(W - cnt):
            tbl["op"].append(_NOP)
            tbl["dst"].append(trash_dst)
            for k in ("a", "b", "t0", "t1", "wit", "inrec", "rec", "corr", "cbit"):
                tbl[k].append(0)
            tbl["onl"].append(trash_onl)
            tbl["pre"].append(trash_pre)
        if has_z:
            for _ in range(Wz - cntz):
                tbl["zop"].append(_NOP)
                tbl["zdst"].append(trash_dstz)
                for k in ("za", "zb", "zt0", "zt1", "zwit", "zinrec", "zrec",
                          "zcorr", "zzr", "zclo", "zchi"):
                    tbl[k].append(0)
                tbl["zonl"].append([trash_onlz] * 64)
                tbl["zpre"].append([trash_prez] * 8)
                tbl["bbits"].append([trash_dst] * 64)
                tbl["brec"].append([0] * 64)
                tbl["bonl"].append([trash_onl] * 64)

    def arr(name, dtype=np.int32):
        return np.asarray([tbl[name] for tbl in waves], dtype=dtype)

    wt = WaveTable(
        op=arr("op"), dst=arr("dst"), a=arr("a"), b=arr("b"),
        t0=arr("t0"), t1=arr("t1"), wit=arr("wit"), inrec=arr("inrec"),
        rec=arr("rec"), corr=arr("corr"), onl=arr("onl"), pre=arr("pre"),
        cbit=arr("cbit"),
    )
    if has_z:
        wt.zop = arr("zop")
        wt.zdst = arr("zdst")
        wt.za = arr("za")
        wt.zb = arr("zb")
        wt.zt0 = arr("zt0")
        wt.zt1 = arr("zt1")
        wt.zwit = arr("zwit")
        wt.zinrec = arr("zinrec")
        wt.zrec = arr("zrec")
        wt.zcorr = arr("zcorr")
        wt.zzr = arr("zzr")
        wt.zclo = arr("zclo", np.uint32)
        wt.zchi = arr("zchi", np.uint32)
        wt.zonl = arr("zonl")
        wt.zpre = arr("zpre")
        wt.bbits = arr("bbits")
        wt.brec = arr("brec")
        wt.bonl = arr("bonl")
    return wt
