"""Independent pure-Python BLAKE3 (spec-derived) used to cross-validate the
native C implementation and the device kernel in tests.  Slow; not used on
any hot path."""

from __future__ import annotations

import struct
from typing import List

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
MSG_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK


def _g(v: List[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    v[a] = (v[a] + v[b] + mx) & MASK
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & MASK
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & MASK
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & MASK
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(cv, block_words, counter, block_len, flags):
    v = list(cv) + IV[:4] + [counter & MASK, (counter >> 32) & MASK, block_len, flags]
    m = list(block_words)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[p] for p in MSG_PERM]
    return [v[i] ^ v[i + 8] for i in range(8)] + [v[i + 8] ^ cv[i] for i in range(8)]


def _words(b: bytes) -> List[int]:
    b = b + b"\x00" * (64 - len(b))
    return list(struct.unpack("<16I", b))


def _chunk_cv(data: bytes, counter: int) -> List[int]:
    cv = list(IV)
    blocks = [data[i : i + 64] for i in range(0, max(len(data), 1), 64)] or [b""]
    for i, blk in enumerate(blocks):
        flags = (CHUNK_START if i == 0 else 0) | (CHUNK_END if i == len(blocks) - 1 else 0)
        cv = compress(cv, _words(blk), counter, len(blk), flags)[:8]
    return cv


def _root_state(data: bytes):
    nchunks = max(1, (len(data) + 1023) // 1024)
    if nchunks == 1:
        blocks = [data[i : i + 64] for i in range(0, max(len(data), 1), 64)] or [b""]
        cv = list(IV)
        for blk in blocks[:-1]:
            flags = CHUNK_START if blk is blocks[0] else 0
            cv = compress(cv, _words(blk), 0, 64, flags)[:8]
        last = blocks[-1]
        flags = (CHUNK_START if len(blocks) == 1 else 0) | CHUNK_END | ROOT
        return cv, _words(last), len(last), flags

    def subtree(data: bytes, chunk0: int) -> List[int]:
        n = max(1, (len(data) + 1023) // 1024)
        if n == 1:
            return _chunk_cv(data, chunk0)
        left = 1
        while left * 2 < n:
            left *= 2
        l = subtree(data[: left * 1024], chunk0)
        r = subtree(data[left * 1024 :], chunk0 + left)
        return compress(IV, l + r, 0, 64, PARENT)[:8]

    left = 1
    while left * 2 < nchunks:
        left *= 2
    l = subtree(data[: left * 1024], 0)
    r = subtree(data[left * 1024 :], left)
    return list(IV), l + r, 64, PARENT | ROOT


def blake3_py(data: bytes, outlen: int = 32) -> bytes:
    cv, block, block_len, flags = _root_state(data)
    out = b""
    counter = 0
    while len(out) < outlen:
        words = compress(cv, block, counter, block_len, flags)
        out += struct.pack("<16I", *words)
        counter += 1
    return out[:outlen]
