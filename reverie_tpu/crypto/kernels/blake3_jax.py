"""Batched BLAKE3 on device (JAX/XLA, vectorized over streams).

Hashes many equal-length byte streams at once: the transcript buffers are
(T, R) uint8 tensors whose columns are the per-repetition streams
(reference absorbs these sequentially into per-rep hashers,
crypto/hash.rs:28-104; here all R streams hash in parallel as vector lanes).

Implementation notes:

  * HOT path (bulk chunk CVs, `lax.scan` over blocks): the 4x4 state is 16
    SEPARATE word tensors -- each G mix is wiring between named variables,
    so the diagonal phase costs zero data movement.  (A (4, ...) row-tensor
    layout pays 4 `rolls` per phase -- 28 relayouts per 64-byte block.)
  * COLD paths (tree reduce, pair hashing, tail chunks) use the row-tensor
    compress with its rounds under a lax.scan: chained unrolled compresses
    dominate compile time (XLA:CPU and XLA:GPU alike), while the rolls and
    the round loop cost little at these small shapes.
  * Blocks chain within a chunk via `lax.scan` with the 8-word CV tuple as
    carry; chunks vectorize as lanes.
  * The left-biased chunk tree reduces with one *batched* compress per tree
    level (level-wise adjacent pairing with odd-last promotion is exactly
    BLAKE3's tree shape) -- not one compress per node.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)
MSG_PERM = np.array([2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8])
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8

# per-round message word indices: round r's j-th G input is m[_MSCHED[r][j]]
_MSCHED = []
_perm = list(range(16))
for _ in range(7):
    _MSCHED.append(tuple(_perm))
    _perm = [_perm[MSG_PERM[i]] for i in range(16)]

# row-phase schedule for the (4, ...) row-tensor compress (cold paths)
_SCHED = []
_permr = np.arange(16)
for _ in range(7):
    _SCHED.append(
        (
            _permr[[0, 2, 4, 6]].copy(),
            _permr[[1, 3, 5, 7]].copy(),
            _permr[[8, 10, 12, 14]].copy(),
            _permr[[9, 11, 13, 15]].copy(),
        )
    )
    _permr = _permr[MSG_PERM]


def _rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _g(a, b, c, d, mx, my):
    a = a + b + mx
    d = _rotr(d ^ a, 16)
    c = c + d
    b = _rotr(b ^ c, 12)
    a = a + b + my
    d = _rotr(d ^ a, 8)
    c = c + d
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _roll(x, k: int):
    return jnp.roll(x, -k, axis=0)


# _SCHED as one (7 rounds, 4 phases, 4 rows) index table for the round scan
_SCHED_TABLE = np.array([[list(ph) for ph in rnd] for rnd in _SCHED], np.int32)


def compress_rows(r0, r1, m, counter_lo, counter_hi, block_len, flags,
                  full: bool = False):
    """One vectorized compression on (4, S) state rows (diagonal phase via
    rolls), m: (16, S) message rows.  Used on the COLD paths (tree reduce,
    pair hashing, tail chunks).  The 7 rounds run as a lax.scan over the
    message schedule table: one round body per compress instead of seven
    keeps XLA's compile time for the hash jits about 3x lower on the GPU,
    at well under a millisecond of extra loop time per hashed stream.  The
    hot bulk-chunk path uses compress_words, unrolled, under its own
    scan."""
    S = r0.shape[1:]
    bc = lambda x: jnp.broadcast_to(jnp.asarray(x, U32), S).astype(U32)
    c = jnp.broadcast_to(jnp.asarray(IV[:4])[(slice(None),) + (None,) * len(S)], (4,) + S).astype(U32)
    d = jnp.stack(
        [bc(counter_lo), bc(counter_hi), bc(block_len), bc(flags)], axis=0
    )

    def rnd(state, sched):
        a, b, c, d = state
        a, b, c, d = _g(a, b, c, d, jnp.take(m, sched[0], axis=0),
                            jnp.take(m, sched[1], axis=0))
        b, c, d = _roll(b, 1), _roll(c, 2), _roll(d, 3)
        a, b, c, d = _g(a, b, c, d, jnp.take(m, sched[2], axis=0),
                            jnp.take(m, sched[3], axis=0))
        b, c, d = _roll(b, 3), _roll(c, 2), _roll(d, 1)
        return (a, b, c, d), None

    (a, b, c, d), _ = jax.lax.scan(rnd, (r0, r1, c, d),
                                   jnp.asarray(_SCHED_TABLE))
    out0 = a ^ c
    out1 = b ^ d
    if full:
        return out0, out1, c ^ r0, d ^ r1
    return out0, out1


def compress_words(cv, m, counter_lo, counter_hi, block_len, flags,
                   full: bool = False):
    """One compression on 16 separate word tensors.

    cv: tuple of 8 u32 tensors of shape S (the chaining value); m: indexable
    of 16 u32 tensors broadcastable to S; counters/len/flags broadcastable to
    S.  Returns the 8 output words (plus words 8..15 ^ cv when `full`).  All
    cross-word routing is Python variable wiring -- no rolls/relayouts."""
    S = cv[0].shape
    bc = lambda x: jnp.broadcast_to(jnp.asarray(x, U32), S).astype(U32)
    v = list(cv) + [bc(int(IV[i])) for i in range(4)] + [
        bc(counter_lo), bc(counter_hi), bc(block_len), bc(flags)
    ]
    for rnd in range(7):
        s = _MSCHED[rnd]
        v[0], v[4], v[8], v[12] = _g(v[0], v[4], v[8], v[12], m[s[0]], m[s[1]])
        v[1], v[5], v[9], v[13] = _g(v[1], v[5], v[9], v[13], m[s[2]], m[s[3]])
        v[2], v[6], v[10], v[14] = _g(v[2], v[6], v[10], v[14], m[s[4]], m[s[5]])
        v[3], v[7], v[11], v[15] = _g(v[3], v[7], v[11], v[15], m[s[6]], m[s[7]])
        v[0], v[5], v[10], v[15] = _g(v[0], v[5], v[10], v[15], m[s[8]], m[s[9]])
        v[1], v[6], v[11], v[12] = _g(v[1], v[6], v[11], v[12], m[s[10]], m[s[11]])
        v[2], v[7], v[8], v[13] = _g(v[2], v[7], v[8], v[13], m[s[12]], m[s[13]])
        v[3], v[4], v[9], v[14] = _g(v[3], v[4], v[9], v[14], m[s[14]], m[s[15]])
    out = tuple(v[i] ^ v[i + 8] for i in range(8))
    if full:
        return out + tuple(v[i + 8] ^ cv[i] for i in range(8))
    return out


def _iv_rows(S):
    shape = (4,) + tuple(S)
    r0 = jnp.broadcast_to(
        jnp.asarray(IV[:4])[(slice(None),) + (None,) * len(S)], shape
    ).astype(U32)
    r1 = jnp.broadcast_to(
        jnp.asarray(IV[4:])[(slice(None),) + (None,) * len(S)], shape
    ).astype(U32)
    return r0, r1


def _bytes_to_words(buf):
    """(T4*4, ...) uint8 -> (T4, ...) u32 little-endian."""
    T = buf.shape[0]
    b = buf.reshape(T // 4, 4, *buf.shape[1:]).astype(U32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _chunk_cvs(words, nblocks: int, block_lens: np.ndarray, counters: np.ndarray,
               last_flags_extra: int = 0):
    """words: (n_chunks, nblocks, 16, R) u32 -> (r0, r1) each (4, n_chunks, R).

    The small tail/one-chunk path: blocks chain through a lax.scan whose body
    is the row-tensor compress."""
    n_chunks, _, _, R = words.shape
    ctr = jnp.asarray(counters, U32).reshape(n_chunks, 1)

    flags = np.zeros(nblocks, np.uint32)
    flags[0] |= CHUNK_START
    flags[-1] |= CHUNK_END | last_flags_extra

    ms = jnp.swapaxes(words, 0, 1)  # (nblocks, n_chunks, 16, R)
    ms = jnp.swapaxes(ms, 1, 2)  # (nblocks, 16, n_chunks, R)
    xs = (ms, jnp.asarray(block_lens, U32), jnp.asarray(flags, U32))
    r0, r1 = _iv_rows((n_chunks, R))

    def body_rows(carry, x):
        r0, r1 = carry
        m, blen, flg = x
        o0, o1 = compress_rows(r0, r1, m, ctr, jnp.zeros_like(ctr), blen, flg)
        return (o0, o1), None

    (r0, r1), _ = jax.lax.scan(body_rows, (r0, r1), xs)
    return r0, r1


def _chunk_cvs_indexed(words, chunk_base):
    """CVs of full chunks WITHOUT the global block-major transpose: the scan
    runs over the block index and dynamic-slices each (n, 16, R) block plane
    out of the natural (n, 16, 16, R) words layout.  _chunk_cvs' swapaxes
    pair would relayout the whole transcript (0.5 GB at the 1M-gate shape)
    before compressing; slicing inside the body reads each plane once with
    contiguous 16*R-word rows."""
    n, R = words.shape[0], words.shape[-1]
    ctr = (jnp.asarray(chunk_base, U32) + jnp.arange(n, dtype=U32)).reshape(n, 1)
    flags = np.zeros(16, np.uint32)
    flags[0] |= CHUNK_START
    flags[-1] |= CHUNK_END
    iv = tuple(
        jnp.broadcast_to(jnp.asarray(int(IV[i]), U32), (n, R)) for i in range(8)
    )

    def body(cv, x):
        j, flg = x
        m3 = jax.lax.dynamic_index_in_dim(words, j, axis=1, keepdims=False)
        out = compress_words(cv, [m3[:, i] for i in range(16)], ctr, 0, 64, flg)
        return out, None

    xs = (jnp.arange(16, dtype=jnp.int32), jnp.asarray(flags, U32))
    cv, _ = jax.lax.scan(body, iv, xs)
    return jnp.stack(cv[:4], axis=0), jnp.stack(cv[4:], axis=0)


def _bulk_cvs_bytes(buf, n_bulk: int, chunk_base):
    """CVs of the first `n_bulk` full (16x64 B) chunks straight from
    transcript bytes: buf (>= n_bulk*1024 rows, R) uint8 in the natural
    layout; chunk_base is the global counter of chunk 0 (int or traced
    scalar)."""
    R = buf.shape[1]
    words = _bytes_to_words(buf[: n_bulk * 1024]).reshape(n_bulk, 16, 16, R)
    return _chunk_cvs_indexed(words, chunk_base)


def _tree_reduce(r0, r1, is_root: bool):
    """r0, r1: (4, n, R) chunk CVs -> (4, R) root output rows.

    Level-wise adjacent pairing (odd last promoted) == BLAKE3's left-biased
    tree.  The levels run as one fixed-shape loop body: every level
    compresses all n//2 pair slots of the full-size buffer (slots past the
    live count compute values that are never read), so the tree compiles
    ONE parent compress instead of one per level -- unrolled levels
    dominated the hash's compile time (about 11 levels at the 1M-gate
    shape)."""
    n = r0.shape[1]
    assert n >= 2
    half = n // 2
    col = jnp.arange(n, dtype=jnp.int32)

    def level(carry):
        r0, r1, cnt = carry
        m = jnp.concatenate(
            [r0[:, 0 : 2 * half : 2], r1[:, 0 : 2 * half : 2],
             r0[:, 1 : 2 * half : 2], r1[:, 1 : 2 * half : 2]],
            axis=0,
        )  # (16, half, R)
        c0, c1 = _iv_rows(m.shape[1:])
        o0, o1 = compress_rows(c0, c1, m, 0, 0, 64, PARENT)
        pairs, odd = cnt // 2, cnt % 2
        # promote the odd last node to slot `pairs`
        last0 = jax.lax.dynamic_index_in_dim(r0, cnt - 1, axis=1)
        last1 = jax.lax.dynamic_index_in_dim(r1, cnt - 1, axis=1)
        keep = ((col == pairs) & (odd == 1))[None, :, None]
        r0 = jnp.where(keep, last0, r0.at[:, :half].set(o0))
        r1 = jnp.where(keep, last1, r1.at[:, :half].set(o1))
        return r0, r1, pairs + odd

    if n > 2:
        r0, r1, _ = jax.lax.while_loop(
            lambda c: c[2] > 2, level, (r0, r1, jnp.int32(n)))
    m = jnp.concatenate([r0[:, 0], r1[:, 0], r0[:, 1], r1[:, 1]], axis=0)
    c0, c1 = _iv_rows(m.shape[1:])
    return compress_rows(c0, c1, m, 0, 0, 64, PARENT | (ROOT if is_root else 0))


def hash_columns(buf, T: int):
    """buf: (>=T, R) uint8 (rows beyond T ignored); returns (R, 32) uint8
    per-column blake3 hashes.  T is static."""
    R = buf.shape[1]
    if T == 0:
        from ..blake3_py import blake3_py

        h = np.frombuffer(blake3_py(b""), dtype=np.uint8)
        return jnp.broadcast_to(jnp.asarray(h)[None, :], (R, 32))

    n_chunks = (T + 1023) // 1024
    buf = buf[:T]

    rem = T - (n_chunks - 1) * 1024
    nb_tail = max(1, (rem + 63) // 64)
    tail_lens = np.full(nb_tail, 64, np.uint32)
    tail_lens[nb_tail - 1] = rem - (nb_tail - 1) * 64

    # only the TAIL chunk ever needs zero padding (<= 1 KiB concat); the bulk
    # chunks read the unpadded buffer directly (padding the whole transcript
    # to a chunk multiple is a 0.5 GB device copy at the 1M-gate shape)
    tail = buf[(n_chunks - 1) * 1024 :]
    if tail.shape[0] != 1024:
        tail = jnp.concatenate(
            [tail, jnp.zeros((1024 - tail.shape[0], R), jnp.uint8)], axis=0
        )
    tail_words = _bytes_to_words(tail).reshape(1, 16, 16, R)

    if n_chunks == 1:
        r0, r1 = _chunk_cvs(tail_words[:, :nb_tail], nb_tail, tail_lens,
                            np.array([0]), last_flags_extra=ROOT)
        out = (r0[:, 0], r1[:, 0])
    else:
        f0, f1 = _bulk_cvs_bytes(buf, n_chunks - 1, 0)
        t0, t1 = _chunk_cvs(tail_words[:, :nb_tail], nb_tail, tail_lens,
                            np.array([n_chunks - 1]))
        r0 = jnp.concatenate([f0, t0], axis=1)
        r1 = jnp.concatenate([f1, t1], axis=1)
        out = _tree_reduce(r0, r1, True)

    return _rows_to_bytes(out[0], out[1])


def _rows_to_bytes(r0, r1):
    """r0, r1: (4, R) u32 -> (R, 32) uint8 little-endian of words 0..7."""
    r0, r1 = jax.lax.optimization_barrier((r0, r1))
    cols = []
    for row in (r0, r1):
        for i in range(4):
            for s in (0, 8, 16, 24):
                cols.append((row[i] >> np.uint32(s)).astype(jnp.uint8))
    return jnp.stack(cols, axis=-1)  # (R, 32)


# ---------------------------------------------------------------------------
# Incremental column hashing (streaming segmented prove, backend/streaming.py)
#
# The transcript streams of a beyond-HBM circuit are produced segment by
# segment; each segment absorbs its (L, R) byte block into per-rep BLAKE3
# chunk CVs on device (reference hashes the same streams sequentially on the
# host, crypto/hash.rs:28-104).  State per stream: cvs0/cvs1 = (4, cap, R)
# chunk CVs (cap = n_chunks_total - 1; the final chunk is always held back in
# `rem` so CHUNK_END/ROOT flags land correctly), rem = (1024, R) whose LAST
# rem_len rows are the pending partial-chunk bytes (right-aligned), plus
# host-tracked rem_len/chunk counters.
# ---------------------------------------------------------------------------


def absorb_columns(cvs0, cvs1, rem, chunk_base, new, rem_len, n_absorb: int):
    """Absorb an (L, R) byte block.  n_absorb is static (chosen by the host
    so absorbed chunks never include the stream's final chunk); rem_len and
    chunk_base are traced i32 scalars, so uniform segments share at most
    two compiles per stream (n_absorb takes two values).  Returns updated
    (cvs0, cvs1, rem)."""
    L = new.shape[0]
    # the pending bytes are buf[1024 - rem_len : 1024 + L], contiguous
    buf = jnp.concatenate([rem, new], axis=0)
    if n_absorb:
        bulk = jax.lax.dynamic_slice_in_dim(buf, 1024 - rem_len,
                                            n_absorb * 1024, axis=0)
        c0, c1 = _bulk_cvs_bytes(bulk, n_absorb, chunk_base)
        cvs0 = jax.lax.dynamic_update_slice(cvs0, c0, (0, chunk_base, 0))
        cvs1 = jax.lax.dynamic_update_slice(cvs1, c1, (0, chunk_base, 0))
    # what is left (< 1024 bytes) ends the buffer: right-aligned already
    return cvs0, cvs1, buf[L:]


def finalize_columns(cvs0, cvs1, rem, total_len: int):
    """cvs0/cvs1: (4, n_chunks-1, R) chunk CVs 0..n_chunks-2; the last
    rows of rem hold the final chunk's bytes.  Returns (R, 32) per-column
    hashes.  total_len > 0 (the caller special-cases the empty stream)."""
    n_chunks = (total_len + 1023) // 1024
    tail_len = total_len - (n_chunks - 1) * 1024
    nb_tail = max(1, (tail_len + 63) // 64)
    tail_lens = np.full(nb_tail, 64, np.uint32)
    tail_lens[nb_tail - 1] = tail_len - (nb_tail - 1) * 64
    R = rem.shape[1]
    tail = jnp.concatenate(
        [rem[1024 - tail_len:], jnp.zeros((1024 - tail_len, R), jnp.uint8)])
    words = _bytes_to_words(tail).reshape(1, 16, 16, R)[:, :nb_tail]
    if n_chunks == 1:
        r0, r1 = _chunk_cvs(words, nb_tail, tail_lens, np.array([0]),
                            last_flags_extra=ROOT)
        return _rows_to_bytes(r0[:, 0], r1[:, 0])
    t0, t1 = _chunk_cvs(words, nb_tail, tail_lens, np.array([n_chunks - 1]))
    r0 = jnp.concatenate([cvs0, t0], axis=1)
    r1 = jnp.concatenate([cvs1, t1], axis=1)
    out = _tree_reduce(r0, r1, True)
    return _rows_to_bytes(out[0], out[1])


_absorb_jit = None
_finalize_jit = None


def _jits():
    global _absorb_jit, _finalize_jit
    if _absorb_jit is None:
        _absorb_jit = jax.jit(absorb_columns, static_argnums=(6,))
        _finalize_jit = jax.jit(finalize_columns, static_argnums=(3,))
    return _absorb_jit, _finalize_jit


class ColumnHasher:
    """Host-side driver for one stream's incremental device hash state.

    The stream's total length is known up front (compile-time segment bases,
    circuit/compile.py:compile_segments), so CV buffers are preallocated and
    every absorb has static shapes.  Usage:

        h = ColumnHasher(total_len, R)
        for seg_bytes in segments: h.absorb(seg_bytes)   # (L, R) device u8
        hashes = h.finalize()                            # (R, 32)
    """

    def __init__(self, total_len: int, R: int):
        self.total_len = total_len
        self.R = R
        self.n_chunks = max(1, (total_len + 1023) // 1024)
        cap = self.n_chunks - 1
        self.cvs0 = jnp.zeros((4, max(cap, 1), R), U32)[:, :cap]
        self.cvs1 = self.cvs0
        self.rem = jnp.zeros((1024, R), jnp.uint8)
        self.rem_len = 0
        self.chunk_base = 0
        self._absorb, self._finalize = _jits()

    def absorb(self, new) -> None:
        L = new.shape[0]
        if L == 0:
            return
        avail = self.rem_len + L
        n_absorb = min(avail // 1024, (self.n_chunks - 1) - self.chunk_base)
        self.cvs0, self.cvs1, self.rem = self._absorb(
            self.cvs0, self.cvs1, self.rem,
            jnp.int32(self.chunk_base), new, jnp.int32(self.rem_len),
            n_absorb,
        )
        self.chunk_base += n_absorb
        self.rem_len = avail - n_absorb * 1024

    def finalize(self):
        if self.total_len == 0:
            from ..blake3_py import blake3_py

            h = np.frombuffer(blake3_py(b""), dtype=np.uint8)
            return jnp.broadcast_to(jnp.asarray(h)[None, :], (self.R, 32))
        assert self.rem_len + self.chunk_base * 1024 == self.total_len
        return self._finalize(self.cvs0, self.cvs1, self.rem, self.total_len)


def hash_pair_columns(a, b):
    """a, b: (R, 32) uint8 -> (R, 32) blake3(a || b) per row (single block)."""
    buf = jnp.concatenate([a, b], axis=1)  # (R, 64)
    m = _bytes_to_words(jnp.moveaxis(buf, 0, 1))  # (16, R)
    r0, r1 = _iv_rows((a.shape[0],))
    out = compress_rows(r0, r1, m, 0, 0, 64, CHUNK_START | CHUNK_END | ROOT)
    return _rows_to_bytes(out[0], out[1])
