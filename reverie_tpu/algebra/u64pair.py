"""Wrapping u64 arithmetic as (hi, lo) uint32 pairs.

JAX runs with 64-bit types disabled (`jax_enable_x64` off), so the Z64 ring
(reference src/algebra/z64/) is implemented on pairs of uint32 tensors.  All ops wrap mod 2^64.
Works identically under jax.numpy and plain numpy (pass the namespace).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32


def _u32(x):
    return x.astype(U32)


def add64(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < alo).astype(lo.dtype)
    hi = ahi + bhi + carry
    return lo, hi


def sub64(alo, ahi, blo, bhi):
    lo = alo - blo
    borrow = (alo < blo).astype(alo.dtype)
    hi = ahi - bhi - borrow
    return lo, hi


def neg64(alo, ahi):
    lo = jnp.zeros_like(alo) - alo
    borrow = (alo != 0).astype(alo.dtype)
    hi = jnp.zeros_like(ahi) - ahi - borrow
    return lo, hi


def _mul32_full(a, b):
    """32x32 -> 64 unsigned multiply via 16-bit limbs: returns (lo, hi)."""
    a0 = a & jnp.asarray(0xFFFF, a.dtype)
    a1 = a >> 16
    b0 = b & jnp.asarray(0xFFFF, b.dtype)
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10
    mid_carry = (mid < p01).astype(a.dtype)  # overflow of the 33-bit sum
    lo = p00 + (mid << 16)
    lo_carry = (lo < p00).astype(a.dtype)
    hi = p11 + (mid >> 16) + (mid_carry << 16) + lo_carry
    return lo, hi


def mul64(alo, ahi, blo, bhi):
    """Low 64 bits of the 64x64 product (wrapping mul)."""
    lo, hi = _mul32_full(alo, blo)
    hi = hi + alo * bhi + ahi * blo  # only low-32 contributions to bits 32..63
    return lo, hi


def from_u64(vals: np.ndarray):
    """numpy uint64 array -> (lo, hi) uint32 numpy arrays."""
    vals = np.asarray(vals, dtype=np.uint64)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def to_u64(lo, hi) -> np.ndarray:
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return lo | (hi << np.uint64(32))


def le_bytes(lo, hi):
    """(lo, hi) (...,) -> 8 uint8 arrays, little-endian byte order."""
    out = []
    for word in (lo, hi):
        for s in (0, 8, 16, 24):
            out.append(((word >> s) & jnp.asarray(0xFF, word.dtype)).astype(jnp.uint8))
    return out
