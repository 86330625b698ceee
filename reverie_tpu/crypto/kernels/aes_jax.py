"""Bitsliced AES-128-CTR on device (JAX/XLA) -> GF2 mask-tape generation.

The reference's PRG is AES-128-CTR with AES-NI (crypto/prg.rs:13-38); here
the cipher is evaluated as a bitsliced boolean circuit in u32 vector ops:

  * lanes: 32 AES instances per u32 word; key order is rep-major
    (key k = rep*8 + player), so one u32 word holds 4 reps x 8 players --
    exactly one packed tape word for 4 repetitions.
  * state: 8 bit-planes, each a (16 bytes, B blocks, Kw words) u32 tensor;
    SubBytes is the 113-gate Boyar-Peralta circuit vectorized over all
    bytes/blocks/lanes; ShiftRows is a byte-axis permutation; MixColumns a
    handful of plane XORs.
  * round keys differ per lane: bit-planes (11, 16, 8, Kw) broadcast over B.

Output feeds the executor's GF2 tape directly: (B*128, 4*Kw) uint8 where
byte column r is repetition r's 8 player bits (bit 7-p = player p),
byte-identical to the host AES + bit-transpose path (differentially tested).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sbox_circuit import sbox_bitsliced

U32 = jnp.uint32


def _xor(a, b):
    return a ^ b


def _and(a, b):
    return a & b


def _not(a):
    return ~a


def _xtime(bits):
    """x2 in GF(2^8), AES polynomial 0x11B, on 8 LSB-first bit-planes."""
    b = bits
    return [
        b[7],
        b[0] ^ b[7],
        b[1],
        b[2] ^ b[7],
        b[3] ^ b[7],
        b[4],
        b[5],
        b[6],
    ]


def _sub_bytes(planes):
    """planes: list of 8 (16, B, Kw) tensors, LSB-first bit order."""
    msb_first = [planes[7 - i] for i in range(8)]
    out = sbox_bitsliced(msb_first, _xor, _and, _not)
    return [out[7 - i] for i in range(8)]  # back to LSB-first


# byte index 4c+r <- old byte 4((c+r)%4)+r
_SHIFT_ROWS = np.array([4 * ((i // 4 + i % 4) % 4) + (i % 4) for i in range(16)])


def _shift_rows(planes):
    perm = jnp.asarray(_SHIFT_ROWS)
    return [p[perm] for p in planes]


def _mix_columns(planes):
    """planes: 8 x (16, B, Kw).  Byte index = 4*col + row."""
    rows = [[p[r::4] for p in planes] for r in range(4)]  # rows[r][bit] (4, B, Kw)
    xt = [_xtime(rows[r]) for r in range(4)]

    def x5(a, b, c, d, e):
        return a ^ b ^ c ^ d ^ e

    new_rows = [
        [x5(xt[0][i], xt[1][i], rows[1][i], rows[2][i], rows[3][i]) for i in range(8)],
        [x5(rows[0][i], xt[1][i], xt[2][i], rows[2][i], rows[3][i]) for i in range(8)],
        [x5(rows[0][i], rows[1][i], xt[2][i], xt[3][i], rows[3][i]) for i in range(8)],
        [x5(xt[0][i], rows[0][i], rows[1][i], rows[2][i], xt[3][i]) for i in range(8)],
    ]
    out = []
    for i in range(8):
        # byte 4c+r: stack rows on a new axis after the column axis
        stacked = jnp.stack([new_rows[r][i] for r in range(4)], axis=1)  # (4c, 4r, B, Kw)
        out.append(stacked.reshape(16, *stacked.shape[2:]))
    return out


def _add_round_key(planes, rkp_round):
    """rkp_round: (16, 8, Kw) u32."""
    return [p ^ rkp_round[:, i, None, :] for i, p in enumerate(planes)]


def _mid_rounds(planes, rkp_mid):
    """The 9 structurally-identical middle AES rounds as a lax.scan over the
    round-key planes.  The unrolled form (~16k HLO ops: 16 bytes x 113-gate
    S-box x 9 rounds) takes XLA:CPU tens of minutes to compile on small
    hosts; the scan body is one round."""

    def body(pl, rk):
        pl = list(pl)
        pl = _sub_bytes(pl)
        pl = _shift_rows(pl)
        pl = _mix_columns(pl)
        pl = _add_round_key(pl, rk)
        return jax.lax.optimization_barrier(tuple(pl)), None

    pl, _ = jax.lax.scan(body, tuple(planes), rkp_mid)
    return list(pl)


def aes_ctr_tape_gf2(rkp, ctrp, lane_mask):
    """rkp: (11, 16, 8, Kw) u32 round-key planes; ctrp: (16, 8, B) uint8
    counter-block bit values (0/1); lane_mask: (Kw,) u32 (omitted-player
    lanes zeroed).  Returns (B*128, 4*Kw) uint8 GF2 tape."""
    Kw = rkp.shape[-1]
    B = ctrp.shape[-1]

    # initial AddRoundKey: ctr (broadcast over lanes) ^ rk0 (broadcast over B)
    planes = [
        (jnp.where(ctrp[:, i, :, None] != 0, jnp.asarray(0xFFFFFFFF, U32), jnp.asarray(0, U32))
         ^ rkp[0][:, i, None, :])
        for i in range(8)
    ]
    planes = _mid_rounds(planes, rkp[1:10])
    planes = _sub_bytes(planes)
    planes = _shift_rows(planes)
    planes = _add_round_key(planes, rkp[10])
    planes = list(jax.lax.optimization_barrier(tuple(planes)))

    # assemble tape words: m = block*128 + byte*8 + j uses bit (7-j)
    stacked = jnp.stack([planes[7 - j] for j in range(8)], axis=1)  # (16, 8, B, Kw)
    words = jnp.transpose(stacked, (2, 0, 1, 3)).reshape(B * 128, Kw)

    # bit-reverse within each byte: tape wants player p at bit (7-p)
    m1, m2_, m4 = (jnp.asarray(v, U32) for v in (0x55555555, 0x33333333, 0x0F0F0F0F))
    words = ((words & m1) << 1) | ((words >> 1) & m1)
    words = ((words & m2_) << 2) | ((words >> 2) & m2_)
    words = ((words & m4) << 4) | ((words >> 4) & m4)
    words = words & lane_mask[None, :]

    by = jax.lax.bitcast_convert_type(words, jnp.uint8)  # (B*128, Kw, 4)
    return by.reshape(B * 128, Kw * 4)


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------


def round_key_planes(player_keys: np.ndarray) -> np.ndarray:
    """player_keys: (K, 16) uint8, K % 32 == 0 -> (11, 16, 8, K//32) u32."""
    from ..prg import key_expand_batch

    K = player_keys.shape[0]
    assert K % 32 == 0
    rks = key_expand_batch(player_keys)  # (K, 11, 16) uint8
    bits = np.unpackbits(rks[..., None], axis=-1, bitorder="little")  # (K,11,16,8)
    bits = np.transpose(bits, (1, 2, 3, 0))  # (11, 16, 8, K)
    packed = np.packbits(bits, axis=-1, bitorder="little")  # (11,16,8,K/8)
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def key_planes_device(keys):
    """keys: (K, 16) uint8 (K % 32 == 0) -> (16, 8, Kw) u32 bit planes on
    device; bit j of lane word w is key w*32+j (same packing as
    round_key_planes round 0)."""
    K = keys.shape[0]
    Kw = K // 32
    sh = jnp.arange(8, dtype=jnp.uint8)
    bits = (keys[:, :, None] >> sh[None, None, :]) & jnp.asarray(1, jnp.uint8)
    bits = bits.astype(U32).reshape(Kw, 32, 16, 8)
    w = jnp.asarray(1, U32) << jnp.arange(32, dtype=U32)
    packed = jnp.sum(bits * w[None, :, None, None], axis=1, dtype=U32)
    return jnp.transpose(packed, (1, 2, 0))  # (16, 8, Kw)


def round_key_planes_device(keys):
    """Device AES-128 key schedule: keys (K, 16) u8 -> (11, 16, 8, Kw) u32.

    Byte-identical to the host round_key_planes (differential test in
    tests/test_device_tapes.py) but runs on device, so callers upload 16
    bytes per key instead of 11x16 round-key bit-planes (the (11,16,8,Kw)
    tensor is 45x larger than the keys)."""
    kp = key_planes_device(keys)  # (16, 8, Kw)
    Kw = kp.shape[-1]
    # rcon as per-round bit-plane XOR masks so every round's body is
    # identical and the 10 rounds run as a lax.scan (the unrolled schedule's
    # 40 S-box graphs take XLA:CPU many minutes on small hosts; see
    # _mid_rounds)
    rc_xs = jnp.asarray(
        np.array(
            [[0xFFFFFFFF if (rc >> bit) & 1 else 0 for bit in range(8)]
             for rc in _RCON],
            dtype=np.uint32,
        )
    )  # (10, 8)

    def body(st, rc_bits):
        # temp = SubWord(RotWord(w3)) ^ rcon  (FIPS-197 5.2)
        stl = [[st[by, bit] for bit in range(8)] for by in range(16)]
        rot = [stl[13], stl[14], stl[15], stl[12]]
        temp = []
        for b in rot:
            msb = [b[7 - i] for i in range(8)]
            sb = sbox_bitsliced(msb, _xor, _and, _not)
            temp.append([sb[7 - i] for i in range(8)])
        temp[0] = [temp[0][bit] ^ rc_bits[bit] for bit in range(8)]
        new_st = []
        carry = temp
        for wi in range(4):
            word = []
            for bi in range(4):
                old = stl[wi * 4 + bi]
                word.append([old[bit] ^ carry[bi][bit] for bit in range(8)])
            new_st.extend(word)
            carry = word
        out = jnp.stack([jnp.stack(byp, 0) for byp in new_st], 0)
        return out, out

    _, ys = jax.lax.scan(body, kp, rc_xs)
    return jnp.concatenate([kp[None], ys], axis=0)  # (11, 16, 8, Kw)


_RKP_JIT = None


def rkp_on_device(player_keys: np.ndarray):
    """Host (K, 16) u8 keys -> device (11, 16, 8, K//32) u32 round-key
    planes; uploads only the raw keys and expands on device (the plane
    tensor is 45x the key bytes)."""
    global _RKP_JIT
    if _RKP_JIT is None:
        _RKP_JIT = jax.jit(round_key_planes_device)
    return _RKP_JIT(jnp.asarray(np.ascontiguousarray(player_keys)))


def counter_planes_device(n_blocks: int, start_block=0):
    """(16, 8, B) uint8 CTR bit planes computed on device (big-endian u64
    counter, bytes 0-7 zero); equals counter_planes for any start_block +
    n_blocks < 2^32.  start_block may be a traced i32/u32 scalar."""
    ctr = jnp.asarray(start_block, U32) + jnp.arange(n_blocks, dtype=U32)
    planes = jnp.zeros((16, 8, n_blocks), jnp.uint8)
    for by in range(8, 16):
        shift_by = 8 * (15 - by)
        byte = (ctr >> np.uint32(shift_by)).astype(jnp.uint8) if shift_by < 32 \
            else jnp.zeros_like(ctr, dtype=jnp.uint8)
        for bit in range(8):
            planes = planes.at[by, bit].set(
                (byte >> np.uint8(bit)) & jnp.asarray(1, jnp.uint8)
            )
    return planes


def counter_planes(n_blocks: int, start_block: int = 0) -> np.ndarray:
    """(16, 8, B) uint8: bit values of the big-endian CTR blocks."""
    ctr = np.arange(start_block, start_block + n_blocks, dtype=np.uint64)
    blocks = np.zeros((n_blocks, 16), dtype=np.uint8)
    for j in range(8):
        blocks[:, 15 - j] = (ctr >> np.uint64(8 * j)).astype(np.uint8)
    bits = np.unpackbits(blocks[..., None], axis=-1, bitorder="little")  # (B,16,8)
    return np.ascontiguousarray(np.transpose(bits, (1, 2, 0)))


def lane_mask_from_omit(omit: np.ndarray, R: int) -> np.ndarray:
    """omit: (R,) player index (8 = none) -> (R*8//32,) u32 lane mask.

    Built in the POST-bit-reversal layout of the tape words: rep r's byte has
    player p at bit (7-p)."""
    mask = np.full(R * 8, 1, dtype=np.uint8)
    for r in range(R):
        p = int(omit[r])
        if p < 8:
            mask[r * 8 + 7 - p] = 0
    packed = np.packbits(mask, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def _keystream_planes(rkp, ctrp, lane_mask):
    """Shared bitsliced AES-CTR core: returns 8 bit-plane tensors
    (16, B, Kw) u32 of the raw keystream blocks (lane-masked)."""
    planes = [
        (jnp.where(ctrp[:, i, :, None] != 0, jnp.asarray(0xFFFFFFFF, U32), jnp.asarray(0, U32))
         ^ rkp[0][:, i, None, :])
        for i in range(8)
    ]
    planes = _mid_rounds(planes, rkp[1:10])
    planes = _sub_bytes(planes)
    planes = _shift_rows(planes)
    planes = _add_round_key(planes, rkp[10])
    planes = list(jax.lax.optimization_barrier(tuple(planes)))
    return [p & lane_mask[None, None, :] for p in planes]


def aes_ctr_tape_z64(rkp, ctrp, lane_mask):
    """Z64 mask tape: (mz_total, 8, R) u32 pairs (lo, hi), player-major.

    The z64 tape interprets each (rep, player) keystream as consecutive LE
    u64 words (z64/batch.rs:25-30).  Bitsliced output planes are transposed
    back to per-key bytes (8 shift-accumulate passes), then packed into u32
    pairs.  `lane_mask` is in raw key order (bit k%32 = key k); the CALLER
    must order keys player-major (key p*R + r = player p of rep r,
    lane_mask_raw_pm) so the (mz, 8, R) reshape below is free and the
    repetition axis is the minor (contiguous) axis.
    """
    Kw = rkp.shape[-1]
    B = ctrp.shape[-1]
    K = Kw * 32
    R = K // 8
    planes = _keystream_planes(rkp, ctrp, lane_mask)

    # per-key bytes: (16, B, Kw, 32) -> (16, B, K)
    shifts = jnp.arange(32, dtype=U32)
    byte_acc = None
    for bit in range(8):
        bits = ((planes[bit][..., None] >> shifts) & jnp.asarray(1, U32)).astype(jnp.uint8)
        contrib = bits << np.uint8(bit)
        byte_acc = contrib if byte_acc is None else byte_acc | contrib
    by = byte_acc.reshape(16, B, K)  # (byte_pos, block, key)

    # u64 words: word m = block m//2, bytes 8*(m%2)..+8 (LE)
    by = jnp.transpose(by, (1, 0, 2)).reshape(B * 2, 8, K)  # (words, 8 bytes, K)
    b32 = by.astype(U32)
    lo = b32[:, 0] | (b32[:, 1] << 8) | (b32[:, 2] << 16) | (b32[:, 3] << 24)
    hi = b32[:, 4] | (b32[:, 5] << 8) | (b32[:, 6] << 16) | (b32[:, 7] << 24)
    return lo.reshape(B * 2, 8, R), hi.reshape(B * 2, 8, R)


def aes_ctr_tape_z64_chunked(rkp, ctrp, lane_mask, chunk_b: int = 1024):
    """aes_ctr_tape_z64 with a lax.scan over block chunks.

    The unchunked form materializes (16, B, Kw, 32) byte-expansion
    intermediates in device memory; scanning fixed-size chunks keeps the
    working set and the compiled HLO O(chunk).  chunk_b = 1024 was the
    fastest measured on an H100 at 400 W, z64 50k-mul tape (R = 256):
    60.4 ms, vs 70.7 at 2048, 87.5 at 4096 and 126.2 unchunked."""
    Kw = rkp.shape[-1]
    B = ctrp.shape[-1]
    R = Kw * 32 // 8
    if B <= chunk_b:
        return aes_ctr_tape_z64(rkp, ctrp, lane_mask)
    n = (B + chunk_b - 1) // chunk_b
    Bp = n * chunk_b
    if Bp != B:
        ctrp = jnp.concatenate(
            [ctrp, jnp.zeros((16, 8, Bp - B), ctrp.dtype)], axis=-1
        )
    chunks = jnp.moveaxis(ctrp.reshape(16, 8, n, chunk_b), 2, 0)  # (n,16,8,c)

    def body(_, ct):
        lo, hi = aes_ctr_tape_z64(rkp, ct, lane_mask)
        return None, (lo, hi)

    _, (lo, hi) = jax.lax.scan(body, None, chunks)
    lo = lo.reshape(Bp * 2, 8, R)[: B * 2]
    hi = hi.reshape(Bp * 2, 8, R)[: B * 2]
    return lo, hi


def lane_mask_raw_pm(omit: np.ndarray, R: int) -> np.ndarray:
    """(R,) omit -> (R*8//32,) u32 mask for PLAYER-MAJOR key order (the z64
    tape layout: key p*R + r = player p of rep r)."""
    mask = (np.arange(8)[:, None] != np.asarray(omit)[None, :]).astype(np.uint8)
    packed = np.packbits(mask.reshape(-1), bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)
