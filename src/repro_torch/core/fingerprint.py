"""Rabin fingerprints over GF(2^64) via Barrett reduction (paper §II, Eq. 4/5).

An SFA state (a vector of DFA state ids) is viewed as a bit-string, i.e. a
polynomial ``A(t)`` over Z_2; its fingerprint is ``A(t) mod P(t)`` for a fixed
irreducible degree-64 polynomial ``P``. Equal fingerprints are *necessary* for
equality of states, so almost all set-membership comparisons reduce to one
64-bit compare (the paper's key construction optimization).

Three implementations live here:

* a pure-Python big-int reference (``clmul_int``/``poly_mod_int``/
  ``fingerprint_int``) — the correctness oracle;
* a NumPy twin on 32-bit words (``fingerprint_words_np``/
  ``fingerprint_states_np``), used on the host for seed fingerprints;
* a PyTorch version on **32-bit limbs carried in int64** (``clmul32`` …
  ``fingerprint_u32``). PyTorch's ``uint32`` lacks shifts, subtraction and
  gather on some builds, so every u32 quantity here is an ``int64`` tensor
  holding a value in ``[0, 2^32)``. These functions are device-agnostic and
  are the plain version of ``kernels/csrc/fingerprint_bank.cu``.

Fingerprint equality is always confirmed by an exact vector comparison before
two states are identified (see ``construction.batched``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

MASK64 = (1 << 64) - 1

# Default degree-64 *irreducible* polynomial over Z_2:
# x^64 + x^4 + x^3 + x + 1 (verified by ``is_irreducible``). ``POLY_LOW`` are
# the low 64 coefficient bits; the x^64 coefficient is implicit. The paper's
# collision bound n^2 m / 2^k requires P irreducible.
DEFAULT_POLY_LOW = 0x000000000000001B


@functools.lru_cache(maxsize=None)
def nth_poly_low(i: int) -> int:
    """Deterministic sequence of irreducible degree-64 polys: index 0 is the
    default; higher indices draw random irreducibles (used to re-randomize on
    a detected fingerprint collision — exactness by detection + retry,
    see repro.construction). Cached: a collision retry in one pattern of a
    bank must not re-run the Rabin irreducibility search for every caller.
    """
    if i == 0:
        return DEFAULT_POLY_LOW
    return random_irreducible_poly64(seed=i) & MASK64


# --------------------------------------------------------------------------
# Pure-integer GF(2) reference
# --------------------------------------------------------------------------


def clmul_int(a: int, b: int) -> int:
    """Carry-less multiply of two GF(2) polynomials given as ints."""
    acc = 0
    while b:
        lsb = b & -b
        acc ^= a * lsb  # multiply by a power of two == shift, carry-free
        b ^= lsb
    return acc


def poly_degree(p: int) -> int:
    return p.bit_length() - 1


def poly_mod_int(a: int, p: int) -> int:
    """Naive polynomial remainder a(t) mod p(t)."""
    dp = poly_degree(p)
    while a.bit_length() - 1 >= dp and a:
        a ^= p << (a.bit_length() - 1 - dp)
    return a


def poly_div_int(a: int, p: int) -> int:
    """Polynomial quotient floor(a(t) / p(t))."""
    q = 0
    dp = poly_degree(p)
    while a.bit_length() - 1 >= dp and a:
        shift = a.bit_length() - 1 - dp
        q ^= 1 << shift
        a ^= p << shift
    return q


def is_irreducible(p: int) -> bool:
    """Rabin's irreducibility test for polynomials over GF(2)."""
    n = poly_degree(p)

    def powmod(base: int, e: int, mod: int) -> int:
        r = 1
        base = poly_mod_int(base, mod)
        while e:
            if e & 1:
                r = poly_mod_int(clmul_int(r, base), mod)
            base = poly_mod_int(clmul_int(base, base), mod)
            e >>= 1
        return r

    # x^(2^n) == x mod p
    h = 2  # the polynomial "x"
    for _ in range(n):
        h = poly_mod_int(clmul_int(h, h), p)
    if h != 2:
        return False
    # gcd(x^(2^(n/q)) - x, p) == 1 for prime divisors q of n
    def prime_divisors(n: int):
        d, out = 2, set()
        while d * d <= n:
            while n % d == 0:
                out.add(d)
                n //= d
            d += 1
        if n > 1:
            out.add(n)
        return out

    def gcd(a: int, b: int) -> int:
        while b:
            a, b = b, poly_mod_int(a, b)
        return a

    for q in prime_divisors(n):
        h = 2
        for _ in range(n // q):
            h = poly_mod_int(clmul_int(h, h), p)
        if gcd(h ^ 2, p) != 1:
            return False
    return True


def random_irreducible_poly64(seed: int) -> int:
    """Draw a random irreducible degree-64 polynomial (paper §II: P(t) is a
    *random* irreducible polynomial)."""
    rng = np.random.default_rng(seed)
    while True:
        low = int(rng.integers(0, 1 << 63, dtype=np.uint64)) << 1 | 1  # odd
        p = (1 << 64) | low
        if is_irreducible(p):
            return p


# --------------------------------------------------------------------------
# Barrett reduction (paper Eq. 4/5)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BarrettConstants:
    """Precomputed constants for reduction mod P(t), degree-64.

    ``poly_low``: low 64 bits of P (x^64 coefficient implicit).
    ``mu_low``:   low 64 bits of M = floor(t^128 / P(t)) (x^64 implicit).
    """

    poly_low: int
    mu_low: int

    @classmethod
    def create(cls, poly_low: int = DEFAULT_POLY_LOW) -> "BarrettConstants":
        p = (1 << 64) | (poly_low & MASK64)
        mu = poly_div_int(1 << 128, p)
        assert mu >> 64 == 1, "M = t^128 / P must have degree exactly 64"
        return cls(poly_low=poly_low & MASK64, mu_low=mu & MASK64)

    @classmethod
    @functools.lru_cache(maxsize=None)
    def cached(cls, poly_low: int = DEFAULT_POLY_LOW) -> "BarrettConstants":
        """Memoized :meth:`create`: collision retries and per-pattern bank
        polynomials share one μ = t^128 / P division per polynomial."""
        return cls.create(poly_low)

    @property
    def poly(self) -> int:
        return (1 << 64) | self.poly_low


def barrett_reduce_int(a: int, consts: BarrettConstants) -> int:
    """A(t) mod P(t) via Barrett reduction; A of degree < 128 (Eq. 5)."""
    p = consts.poly
    mu = (1 << 64) | consts.mu_low
    t1pre = a >> 64                       # floor(A / t^64)
    t1 = clmul_int(t1pre, mu)             # T1pre • M
    t2pre = t1 >> 64                      # floor(T1 / t^64)
    t2 = clmul_int(t2pre, p)              # T2pre • P
    return (a ^ t2) & MASK64              # A ⊕ T2, degree < 64


def fingerprint_int(words: np.ndarray, consts: BarrettConstants) -> int:
    """Fingerprint of a uint32-word stream via the folding method.

    fp = XOR_i barrett(clmul(word_i, x^(32 i) mod P)) — linearity of the
    residue lets the per-word products be folded *before* a single reduction
    round, which is exactly what makes this data-parallel.
    """
    weights = fold_weights_int(len(words), consts)
    acc = 0
    for w, wt in zip(np.asarray(words, dtype=np.uint64).tolist(), weights):
        acc ^= clmul_int(int(w), wt)
    return barrett_reduce_int(acc, consts)


@functools.lru_cache(maxsize=64)
def _fold_weights_cached(n_words: int, poly_low: int) -> tuple:
    p = (1 << 64) | poly_low
    out = []
    w = 1  # x^0 mod P
    for _ in range(n_words):
        out.append(w)
        w = poly_mod_int(w << 32, p)  # advance by x^32
    return tuple(out)


def fold_weights_int(n_words: int, consts: BarrettConstants) -> tuple:
    return _fold_weights_cached(n_words, consts.poly_low)


# --------------------------------------------------------------------------
# PyTorch implementation on 32-bit limbs (int64 tensors holding u32 values)
# --------------------------------------------------------------------------
# 64-bit quantities are (hi, lo) pairs; 128-bit are (l3, l2, l1, l0) with l0
# the least-significant limb.

U32_MASK = 0xFFFFFFFF


def clmul32(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Carry-less 32x32 -> 64-bit multiply.

    ``a``/``b``: int64 tensors of u32 values (broadcastable); with int64 the
    whole 63-bit product fits one accumulator, split into (hi, lo) at the
    end. The product commutes, so the smaller operand (a bank's fold
    weights, not its words) is the one taken apart: a table of its products
    with every 4-bit value, built at its own size; each of the other
    operand's eight nibbles is then one lookup, shifted and XOR-accumulated.
    """
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.numel() < b.numel():
        a, b = b, a
    a = a.expand(shape)   # neither operand need have the broadcast shape
    b = b.reshape((1,) * (len(shape) - b.dim()) + tuple(b.shape))
    x = torch.arange(16, dtype=torch.int64, device=a.device)
    table = torch.zeros(b.shape + (16,), dtype=torch.int64, device=a.device)
    for bit in range(4):
        table ^= (b[..., None] << bit) & -((x >> bit) & 1)
    table = table.expand(shape + (16,))
    acc = torch.zeros(shape, dtype=torch.int64, device=a.device)
    nib = torch.empty(shape + (1,), dtype=torch.int64, device=a.device)
    term = torch.empty_like(nib)
    for j in range(8):
        torch.bitwise_right_shift(a[..., None], 4 * j, out=nib)
        nib &= 15
        torch.gather(table, -1, nib, out=term)
        term <<= 4 * j
        acc ^= term[..., 0]
    return acc >> 32, acc & U32_MASK


def xor64(x: tuple, y: tuple) -> tuple:
    return x[0] ^ y[0], x[1] ^ y[1]


def clmul64(a: tuple, b: tuple) -> tuple:
    """Carry-less 64x64 -> 128-bit multiply from four 32-bit partials."""
    ah, al = a
    bh, bl = b
    ll_h, ll_l = clmul32(al, bl)   # -> limbs 1,0
    lh_h, lh_l = clmul32(al, bh)   # -> limbs 2,1
    hl_h, hl_l = clmul32(ah, bl)   # -> limbs 2,1
    hh_h, hh_l = clmul32(ah, bh)   # -> limbs 3,2
    return hh_h, lh_h ^ hl_h ^ hh_l, ll_h ^ lh_l ^ hl_l, ll_l


def barrett_reduce_u32(a128: tuple, limbs) -> tuple:
    """Barrett reduction of a 128-bit polynomial to 64 bits, limb form.

    ``limbs`` is ``(p_hi, p_lo, mu_hi, mu_lo)`` — Python ints, or int64
    tensors broadcastable against the limbs of ``a128`` (per-pattern
    constants). A :class:`BarrettConstants` is accepted too.
    """
    if isinstance(limbs, BarrettConstants):
        limbs = limbs_of(limbs)
    p_hi, p_lo, mu_hi, mu_lo = limbs
    l3, l2, l1, l0 = a128

    def like(x):
        return torch.as_tensor(x, dtype=torch.int64, device=l0.device)

    t1pre = (l3, l2)  # floor(A / t^64)
    # T1 = clmul(T1pre, M) with M = t^64 + mu  ->  T1>>64 = T1pre ^ hi64(T1pre*mu)
    m3, m2, _, _ = clmul64(t1pre, (like(mu_hi), like(mu_lo)))
    t2pre = xor64(t1pre, (m3, m2))
    # T2 = clmul(T2pre, P) with P = t^64 + p_low; the low 64 result bits come
    # from A_low ^ low64(T2pre * p_low) (the t^64 part cancels A's high limbs).
    _, _, q1, q0 = clmul64(t2pre, (like(p_hi), like(p_lo)))
    return l1 ^ q1, l0 ^ q0


def limbs_of(consts: BarrettConstants) -> tuple:
    """``(p_hi, p_lo, mu_hi, mu_lo)`` of one polynomial, as Python ints."""
    return (
        (consts.poly_low >> 32) & U32_MASK,
        consts.poly_low & U32_MASK,
        (consts.mu_low >> 32) & U32_MASK,
        consts.mu_low & U32_MASK,
    )


def fold_weights_u32(n_words: int, consts: BarrettConstants,
                     device=None) -> torch.Tensor:
    """(n_words, 2) int64 tensor of x^(32 i) mod P constants (hi, lo)."""
    ws = fold_weights_int(n_words, consts)
    rows = [((w >> 32) & U32_MASK, w & U32_MASK) for w in ws]
    return torch.tensor(rows, dtype=torch.int64, device=device).reshape(
        n_words, 2)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (PyTorch has no bitwise reduction)."""
    out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        out ^= x[..., i]
    return out


def fingerprint_u32(words: torch.Tensor, weights: torch.Tensor,
                    limbs) -> tuple:
    """Rabin fingerprint of ``words`` (..., W) -> ((...), (...)) (hi, lo).

    The fold: fp = reduce( XOR_i clmul64((0, word_i), weight_i) ). Each word
    contributes a 96-bit product (32x64); the XOR-accumulated value is
    Barrett-reduced once. ``weights`` is (..., W, 2) broadcastable against
    ``words``; ``limbs`` as in :func:`barrett_reduce_u32`.
    """
    p_lo_h, p_lo_l = clmul32(words, weights[..., 1])   # limbs 1,0
    p_hi_h, p_hi_l = clmul32(words, weights[..., 0])   # limbs 2,1
    l0 = xor_reduce(p_lo_l)
    l1 = xor_reduce(p_lo_h ^ p_hi_l)
    l2 = xor_reduce(p_hi_h)
    return barrett_reduce_u32((torch.zeros_like(l2), l2, l1, l0), limbs)


def pack_states_u32(states: torch.Tensor) -> torch.Tensor:
    """Pack a state-id vector (..., n) into u32 words (..., ceil(n/2)) as
    int64, two 16-bit ids per word (the paper stores FA states as uint16)."""
    states = states.to(torch.int64)
    if states.shape[-1] % 2:
        states = torch.nn.functional.pad(states, (0, 1))
    lo = states[..., 0::2] & 0xFFFF
    hi = states[..., 1::2] & 0xFFFF
    return lo | (hi << 16)


def fingerprint_states(states: torch.Tensor,
                       consts: BarrettConstants) -> torch.Tensor:
    """Fingerprint batched SFA state vectors: (..., n) -> (..., 2) int64
    holding u32 [hi, lo]."""
    words = pack_states_u32(states)
    weights = fold_weights_u32(words.shape[-1], consts, device=states.device)
    hi, lo = fingerprint_u32(words, weights, consts)
    return torch.stack([hi, lo], dim=-1)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same 32 bits (the layout the
    CUDA kernels read)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return x.to(torch.int64) & U32_MASK


# --------------------------------------------------------------------------
# NumPy twins (host-side seed fingerprints and test oracles)
# --------------------------------------------------------------------------


def pack_states_np(states: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """NumPy twin of :func:`pack_states_u32`: (..., n) ids -> (..., ceil(n/2))
    uint32 words, two 16-bit ids per word. ``out`` lets callers reuse one
    scratch buffer across construction tiles and collision-retry attempts
    (packing is polynomial-independent, so the packed words survive a retry
    with a fresh P(t))."""
    states = np.asarray(states, dtype=np.uint32)
    n = states.shape[-1]
    n_words = (n + 1) // 2
    shape = states.shape[:-1] + (n_words,)
    if out is None or out.shape != shape:
        out = np.empty(shape, dtype=np.uint32)
    np.bitwise_and(states[..., 0::2], np.uint32(0xFFFF), out=out)
    out[..., : n // 2] |= (states[..., 1::2] & np.uint32(0xFFFF)) << np.uint32(16)
    return out


def fingerprint_words_np(words: np.ndarray, consts: BarrettConstants) -> np.ndarray:
    """Fold + Barrett-reduce pre-packed words: (..., W) u32 -> (..., 2) u32."""
    ws = fold_weights_int(words.shape[-1], consts)
    w_lo = np.asarray([w & 0xFFFFFFFF for w in ws], dtype=np.uint32)
    w_hi = np.asarray([(w >> 32) & 0xFFFFFFFF for w in ws], dtype=np.uint32)

    p_lo_h, p_lo_l = _clmul32_np(words, w_lo)
    p_hi_h, p_hi_l = _clmul32_np(words, w_hi)
    l0 = _xor_reduce_np(p_lo_l)
    l1 = _xor_reduce_np(p_lo_h ^ p_hi_l)
    l2 = _xor_reduce_np(p_hi_h)
    l3 = np.zeros_like(l2)
    hi, lo = _barrett_np((l3, l2, l1, l0), consts)
    return np.stack([hi, lo], axis=-1)


def fingerprint_states_np(states: np.ndarray, consts: BarrettConstants) -> np.ndarray:
    """NumPy twin of :func:`fingerprint_states` (vectorized; the host-side
    seed fingerprints of construction). Works in 32-bit word space exactly
    as the limb path does. Returns (..., 2) uint32 [hi, lo]."""
    return fingerprint_words_np(pack_states_np(states), consts)


def _clmul32_np(a: np.ndarray, b: np.ndarray) -> tuple:
    a = a.astype(np.uint32)
    b = np.broadcast_to(np.asarray(b, dtype=np.uint32), a.shape)
    hi = np.zeros_like(a)
    lo = np.zeros_like(a)
    for i in range(32):
        bit = (b >> np.uint32(i)) & np.uint32(1)
        mask = np.where(bit != 0, np.uint32(0xFFFFFFFF), np.uint32(0))
        lo ^= (a << np.uint32(i)) & mask
        hi ^= (((a >> np.uint32(31 - i)) >> np.uint32(1)) & mask)
    return hi, lo


def _xor_reduce_np(x: np.ndarray) -> np.ndarray:
    return np.bitwise_xor.reduce(x, axis=-1)


def _barrett_np(a128: tuple, consts: BarrettConstants) -> tuple:
    l3, l2, l1, l0 = a128
    p = (np.uint32(consts.poly_low >> 32), np.uint32(consts.poly_low & 0xFFFFFFFF))
    mu = (np.uint32(consts.mu_low >> 32), np.uint32(consts.mu_low & 0xFFFFFFFF))
    m3, m2, _, _ = _clmul64_np((l3, l2), mu)
    t2 = (l3 ^ m3, l2 ^ m2)
    _, _, q1, q0 = _clmul64_np(t2, p)
    return l1 ^ q1, l0 ^ q0


def _clmul64_np(a: tuple, b: tuple) -> tuple:
    ah, al = a
    bh, bl = np.asarray(b[0], dtype=np.uint32), np.asarray(b[1], dtype=np.uint32)
    ll_h, ll_l = _clmul32_np(al, bl)
    lh_h, lh_l = _clmul32_np(al, np.broadcast_to(bh, al.shape))
    hl_h, hl_l = _clmul32_np(ah, np.broadcast_to(bl, ah.shape))
    hh_h, hh_l = _clmul32_np(ah, np.broadcast_to(bh, ah.shape))
    return hh_h, lh_h ^ hl_h ^ hh_l, ll_h ^ lh_l ^ hl_l, ll_l
