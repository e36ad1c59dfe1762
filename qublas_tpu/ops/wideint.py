"""Exact 64-bit integer emulation on 32-bit lanes.

The device programs run on 32-bit integer lanes (JAX's x64 mode is off
and is no fast path on accelerators), but QuBLAS semantics require *exact* wide intermediates: e.g. a
default-format (8,8) multiply produces a 33-bit product before requantization
(reference widens to ``ArbiInt<N+M>``, QuBLAS.h:1186-1363).  This module
represents such intermediates as ``(hi: int32, lo: uint32)`` pairs and
implements the handful of exact operations the requantization pipeline needs:
widen, add, negate, 32×32→64 multiply, static shifts, masks, compares.

Everything here is pure jnp on 32-bit lanes, so it runs identically inside
Pallas kernels and in plain XLA-fused elementwise code, on the GPU and on
the CPU test backend.  All shift amounts / masks are static Python ints —
no dynamic shapes, nothing blocks XLA fusion.

Width contract: callers must prove (via :mod:`qublas_tpu.ops.widths`) that
the value fits 64 bits; results of requantization must fit int32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..qformat import OverflowMode, QFormat, RoundMode

__all__ = [
    "widen", "pair_const", "pair_add", "pair_neg", "mul32_wide",
    "pair_shl", "pair_shr", "pair_low_bits", "pair_lt", "pair_eq",
    "pair_is_neg", "pair_is_pos", "pair_to_int32",
    "requantize_pair", "requantize_i32",
    "PairArray", "pair_mul", "as_pair", "requantize_pair_keep",
    "pair_div_trunc",
]

_U32 = jnp.uint32
_I32 = jnp.int32


@jax.tree_util.register_pytree_node_class
class PairArray:
    """Device-resident 33..64-bit integer tensor as two 32-bit limb arrays.

    This is the *storage* form of QTensor data for formats whose physical
    width is 33–64 bits (the reference's multiword ``ArbiInt`` territory,
    QuBLAS.h:566-912, stores little-endian uint64 limbs; on device the natural
    limb is the 32-bit lane).  ``hi`` is the signed high limb (int32), ``lo``
    the unsigned low limb (uint32); the logical value is ``hi * 2^32 + lo``.

    Registered as a pytree so it flows through jit/vmap/shard_map inside a
    QTensor like any array.  Only the structural operations QTensor needs are
    implemented; arithmetic lives in the pair_* functions of this module.
    """

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo):
        self.hi = hi
        self.lo = lo

    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def size(self):
        return self.hi.size

    def __getitem__(self, idx):
        return PairArray(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return PairArray(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def swapaxes(self, a, b):
        return PairArray(self.hi.swapaxes(a, b), self.lo.swapaxes(a, b))

    def to_numpy_int64(self) -> "jnp.ndarray":
        """Exact host transfer: values as a NumPy int64 array."""
        import numpy as np

        hi = np.asarray(self.hi).astype(np.int64)
        lo = np.asarray(self.lo).astype(np.uint64).astype(np.int64)
        return (hi << 32) | lo

    def __repr__(self):
        return f"PairArray(shape={tuple(self.shape)})"


def pair_from_int64_np(values) -> PairArray:
    """Host NumPy/object array of Python ints (fitting 64 bits, two's
    complement) -> device PairArray.

    ``int.to_bytes`` does the two's-complement split at C speed, one call
    per element (same technique as limbint.limbs_from_ints) — ~40x the
    nditer loop this replaced."""
    import numpy as np

    if isinstance(values, np.ndarray) and values.dtype != object \
            and np.issubdtype(values.dtype, np.integer):
        v = values.astype(np.int64, copy=False)
        lo = (v & np.int64(0xFFFFFFFF)).astype(np.uint32)
        hi = (v >> np.int64(32)).astype(np.int32)
        return PairArray(jnp.asarray(hi), jnp.asarray(lo))
    arr = np.asarray(values, dtype=object)
    buf = b"".join((int(v) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
                   for v in arr.reshape(-1))
    words = np.frombuffer(buf, dtype="<u4").reshape(-1, 2)
    lo = np.ascontiguousarray(words[:, 0]).reshape(arr.shape)
    hi = np.ascontiguousarray(words[:, 1]).view(np.int32).reshape(arr.shape)
    return PairArray(jnp.asarray(hi), jnp.asarray(lo))


def as_pair(x):
    """Coerce an int32 array or PairArray to a (hi, lo) tuple."""
    if isinstance(x, PairArray):
        return x.hi, x.lo
    return widen(x)


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, _I32)


def _bitcast_u32(x):
    return jax.lax.bitcast_convert_type(x, _U32)


def widen(x):
    """int32 array -> sign-extended (hi, lo) pair."""
    return x >> 31, _bitcast_u32(x)


def pair_const(c: int, shape=(), dtype_like=None):
    """Python int (|c| < 2^63) -> broadcastable constant pair."""
    c &= (1 << 64) - 1
    hi = jnp.full(shape, _to_i32(c >> 32), dtype=_I32)
    lo = jnp.full(shape, c & 0xFFFFFFFF, dtype=_U32)
    return hi, lo


def _to_i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def pair_add(a, b):
    hi1, lo1 = a
    hi2, lo2 = b
    lo = lo1 + lo2  # uint32 wraparound
    carry = _bitcast_i32((lo < lo1).astype(_U32))
    return hi1 + hi2 + carry, lo


def pair_neg(a):
    hi, lo = a
    nlo = (~lo) + _U32(1)
    borrow = _bitcast_i32((nlo == 0).astype(_U32))
    return (~hi) + borrow, nlo


def pair_sub(a, b):
    return pair_add(a, pair_neg(b))


def mul32_wide(a, b):
    """Exact signed 32×32 → 64-bit product as a (hi, lo) pair.

    Unsigned schoolbook on 16-bit halves (Hacker's Delight style) plus the
    signed correction ``hi -= (a<0)*b + (b<0)*a``.
    """
    ua, ub = _bitcast_u32(a), _bitcast_u32(b)
    a0, a1 = ua & _U32(0xFFFF), ua >> 16
    b0, b1 = ub & _U32(0xFFFF), ub >> 16
    ll = a0 * b0
    mid = a0 * b1 + (ll >> 16)
    mid2 = a1 * b0 + (mid & _U32(0xFFFF))
    lo = (mid2 << 16) | (ll & _U32(0xFFFF))
    hi_u = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    hi_u = hi_u - jnp.where(a < 0, ub, _U32(0)) - jnp.where(b < 0, ua, _U32(0))
    return _bitcast_i32(hi_u), lo


def _umul32_wide(ua, ub):
    """Unsigned 32×32 → 64-bit product as (hi: uint32, lo: uint32)."""
    a0, a1 = ua & _U32(0xFFFF), ua >> 16
    b0, b1 = ub & _U32(0xFFFF), ub >> 16
    ll = a0 * b0
    mid = a0 * b1 + (ll >> 16)
    mid2 = a1 * b0 + (mid & _U32(0xFFFF))
    lo = (mid2 << 16) | (ll & _U32(0xFFFF))
    hi = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    return hi, lo


def pair_mul(a, b):
    """Low 64 bits of the product of two 64-bit pairs.

    Exact whenever the true (signed) product fits 64 bits — the caller must
    prove this via interval arithmetic (``widths.route_mul``).  Two's
    complement makes the mod-2^64 result sign-correct:

        (ahi·2³² + alo)(bhi·2³² + blo) ≡ ((ahi·blo + alo·bhi) mod 2³²)·2³²
                                           + alo·blo            (mod 2⁶⁴)
    """
    ahi, alo = a
    bhi, blo = b
    hi_u, lo = _umul32_wide(alo, blo)
    cross = _bitcast_u32(ahi) * blo + alo * _bitcast_u32(bhi)  # mod 2^32
    return _bitcast_i32(hi_u + cross), lo


def pair_shl(a, d: int):
    """Exact static left shift (caller guarantees no overflow past 63 bits)."""
    hi, lo = a
    if d == 0:
        return a
    if d < 32:
        hi2 = (hi << d) | _bitcast_i32(lo >> (32 - d))
        lo2 = lo << d
        return hi2, lo2
    return (_bitcast_i32(lo) << (d - 32) if d > 32 else _bitcast_i32(lo)), jnp.zeros_like(lo)


def pair_shr(a, d: int):
    """Arithmetic (sign-propagating) static right shift."""
    hi, lo = a
    if d == 0:
        return a
    if d < 32:
        lo2 = (lo >> d) | (_bitcast_u32(hi) << (32 - d))
        return hi >> d, lo2
    x = hi >> (d - 32) if d > 32 else hi
    return hi >> 31, _bitcast_u32(x)


def pair_low_bits(a, d: int):
    """val & (2^d - 1) as a (non-negative) pair, 0 <= d < 64."""
    hi, lo = a
    if d == 0:
        return jnp.zeros_like(hi), jnp.zeros_like(lo)
    if d <= 32:
        mask = _U32((1 << d) - 1) if d < 32 else _U32(0xFFFFFFFF)
        return jnp.zeros_like(hi), lo & mask
    return hi & _I32((1 << (d - 32)) - 1), lo


def pair_lt(a, b):
    """Signed a < b."""
    hi1, lo1 = a
    hi2, lo2 = b
    return (hi1 < hi2) | ((hi1 == hi2) & (lo1 < lo2))


def pair_eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def pair_is_neg(a):
    return a[0] < 0


def pair_is_pos(a):
    hi, lo = a
    return (hi > 0) | ((hi == 0) & (lo != 0))


def pair_to_int32(a):
    """Truncate to int32 (caller guarantees the value fits)."""
    return _bitcast_i32(a[1])


# ---------------------------------------------------------------------------
# Requantization epilogues
# ---------------------------------------------------------------------------

def pair_div_trunc(a, b):
    """C++-style truncating division of two signed 64-bit pairs (round 4:
    the device route for pair-regime Qdiv, ``widths.route_div``).

    Restoring long division: both operands reduce to magnitudes (exact —
    the route's ``fits64`` proof leaves the I64_MIN+1 margin, so negation
    never wraps), 64 shift-compare-subtract steps run in a ``fori_loop``
    on unsigned (hi, lo) limbs, then the quotient takes the XOR sign.
    Divide-by-zero returns an all-ones pattern here; the CALLER must mask
    it to the reference's zero wart (QuBLAS.h:3252-3255) — keeping the
    wart at the op layer mirrors ``lax.div``'s role in the i32 route.

    Exactness: the invariant ``R < D`` holds after every restoring step,
    so ``R<<1 | bit < 2*D <= 2^64`` never overflows the pair; the final
    Q is the unique integer with ``|a| = Q*|b| + R, 0 <= R < |b|`` —
    truncation toward zero after the sign fix, exactly C++ ``/``.
    """
    neg_a = pair_is_neg(a)
    neg_b = pair_is_neg(b)
    ua = _pair_select(neg_a, pair_neg(a), a)
    ub = _pair_select(neg_b, pair_neg(b), b)
    nh, nl = _bitcast_u32(ua[0]), ua[1]
    dh, dl = _bitcast_u32(ub[0]), ub[1]
    z = jnp.zeros_like(nl)

    def step(_, st):
        nh, nl, rh, rl, qh, ql = st
        bit = nh >> 31
        nh = (nh << 1) | (nl >> 31)
        nl = nl << 1
        rh = (rh << 1) | (rl >> 31)
        rl = (rl << 1) | bit
        ge = (rh > dh) | ((rh == dh) & (rl >= dl))
        sl = rl - dl
        borrow = (rl < dl).astype(_U32)
        sh = rh - dh - borrow
        rh = jnp.where(ge, sh, rh)
        rl = jnp.where(ge, sl, rl)
        qh = (qh << 1) | (ql >> 31)
        ql = (ql << 1) | ge.astype(_U32)
        return nh, nl, rh, rl, qh, ql

    *_rest, qh, ql = jax.lax.fori_loop(0, 64, step, (nh, nl, z, z, z, z))
    q = (_bitcast_i32(qh), ql)
    return _pair_select(neg_a != neg_b, pair_neg(q), q)


def _carry_mode(mode, xl_gt, xl_ge, xl_eq, is_neg, is_pos, xh_odd):
    """Rounding carry predicate shared by the i32 and pair paths.

    Mirrors reference fracConvert (QuBLAS.h:2002-2159): each RND mode adds a
    mode-specific carry computed from (Xl vs T) and value sign / Xh parity.
    """
    if mode == RoundMode.RND_POS_INF:
        return xl_ge
    if mode == RoundMode.RND_NEG_INF:
        return xl_gt
    if mode == RoundMode.RND_ZERO:
        return xl_gt | (xl_eq & is_neg)
    if mode == RoundMode.RND_INF:
        return xl_gt | (xl_eq & is_pos)
    if mode == RoundMode.RND_CONV:
        return xl_gt | (xl_eq & xh_odd)
    raise AssertionError(mode)


def _overflow_i32(y, fmt: QFormat):
    """int_convert on an int32 value (result width <= 32 by width proof)."""
    w = fmt.storage_bits
    mode = fmt.overflow_mode
    hi_v = (1 << (w - 1)) - 1 if w <= 32 else None
    if mode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                OverflowMode.SAT_SMGN):
        if w > 32:
            return y  # cannot overflow a 32-bit-wide intermediate
        if not fmt.signed:
            lo_v = 0
        elif mode == OverflowMode.SAT_SMGN:
            lo_v = -(1 << (w - 1)) + 1
        else:
            lo_v = -(1 << (w - 1))
        if mode == OverflowMode.SAT_ZERO:
            # single unsigned range compare: (uint32)(y - lo) > (hi - lo)
            # iff y outside [lo, hi] (two's-complement wrap makes y < lo
            # land above the range) — one less integer op than two compares +
            # or, and it sits in every tree-GEMM product and merge
            u = _bitcast_u32(y - _I32(lo_v))
            return jnp.where(u > _U32(hi_v - lo_v), _I32(0), y)
        return jnp.clip(y, _I32(lo_v), _I32(hi_v))
    if mode == OverflowMode.WRP_TCPL:
        if fmt.signed:
            if w >= 32:
                return y
            mask = _I32((1 << w) - 1)
            m = y & mask
            sign = (m >> (w - 1)) & _I32(1)
            return jnp.where(sign == 1, m | ~mask, m)
        wb = w - 1  # unsigned wrap masks to int_bits+frac_bits (QuBLAS.h:2329)
        if wb >= 32:
            return y
        return y & _I32((1 << wb) - 1)
    if mode == OverflowMode.WRP_TCPL_SAT:
        return y  # reference stub (QuBLAS.h:2336-2344)
    raise AssertionError(mode)


def requantize_i32(x, from_frac: int, fmt: QFormat):
    """Bit-exact requantize on int32 lanes (single-limb fast path).

    Caller must have proven (see :mod:`.widths`) that ``x`` and every
    intermediate (left shift, +1 carry) fit int32.
    """
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    if d <= 0:
        y = x << (-d) if d else x
    elif mode == RoundMode.TRN_TCPL:
        y = x >> d
    elif mode == RoundMode.TRN_SMGN:
        # truncate toward zero via bias-add: (x + (2^d - 1)) >> d for
        # negative x.  The naive -((-x) >> d) wraps at x = INT32_MIN
        # (negation overflows the lane) — caught by deep fuzz
        bias = jnp.where(x < 0, _I32((1 << d) - 1), _I32(0))
        y = (x + bias) >> d
    else:
        xh = x >> d
        xl = x & _I32((1 << d) - 1) if d < 32 else x - (xh << d)
        t = _I32(1 << (d - 1)) if d <= 31 else None
        if t is None:
            # d == 32+ cannot happen on the i32 path (width proof rejects it)
            raise AssertionError("shift too wide for i32 path")
        carry = _carry_mode(mode, xl > t, xl >= t, xl == t,
                            x < 0, x > 0, (xh & 1) == 1)
        y = xh + carry.astype(_I32)
    return _overflow_i32(y, fmt)


def requantize_split_mul(a, b, from_frac: int, fmt: QFormat):
    """Bit-exact requantized product on pure int32 lanes via the split-B
    trick, for products wider than 32 bits whose requantization drops
    ``d = from_frac - fmt.frac_bits >= 1`` bits.

    With ``s = d``, ``bh = b >> s`` (arithmetic) and ``bl = b & (2^s - 1)``:

        prod        = (a*bh) << s  +  a*bl
        floor(prod >> d) = a*bh + ((a*bl) >> d)     (exact: s == d)
        prod & (2^d - 1) = (a*bl) & (2^d - 1)
        sign(prod)       = sign(a) ^ sign(b)

    which is everything the rounding-carry predicate needs — ~6 integer ops per
    element instead of the ~25 of ``mul32_wide`` + ``requantize_pair``.
    Caller must prove (see ``widths.route_mul``) that ``a*bl``, ``a*bh``,
    and ``xh + 1`` fit int32.
    """
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    assert 1 <= d <= 30
    mask = _I32((1 << d) - 1)
    bl = b & mask
    bh = b >> d
    albl = a * bl
    xh = a * bh + (albl >> d)          # floor(prod / 2^d)
    if mode == RoundMode.TRN_TCPL:
        y = xh
    else:
        xl = albl & mask
        if mode == RoundMode.TRN_SMGN:
            neg = ((a ^ b) < 0) & (a != 0)
            y = xh + (neg & (xl != 0)).astype(_I32)
        else:
            t = _I32(1 << (d - 1))
            nz = (a != 0) & (b != 0)
            is_neg = ((a ^ b) < 0) & nz
            is_pos = ((a ^ b) >= 0) & nz
            carry = _carry_mode(mode, xl > t, xl >= t, xl == t,
                                is_neg, is_pos, (xh & 1) == 1)
            y = xh + carry.astype(_I32)
    return _overflow_i32(y, fmt)


def _round_pair(p, from_frac: int, fmt: QFormat):
    """Rounding stage (fracConvert, QuBLAS.h:2002-2204) on a 64-bit pair."""
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    if d <= 0:
        return pair_shl(p, -d) if d else p
    if mode == RoundMode.TRN_TCPL:
        return pair_shr(p, d)
    if mode == RoundMode.TRN_SMGN:
        neg = pair_is_neg(p)
        pos_res = pair_shr(p, d)
        neg_res = pair_neg(pair_shr(pair_neg(p), d))
        return (jnp.where(neg, neg_res[0], pos_res[0]),
                jnp.where(neg, neg_res[1], pos_res[1]))
    xh = pair_shr(p, d)
    xl = pair_low_bits(p, d)
    t = pair_const(1 << (d - 1), shape=p[0].shape)
    xl_gt = pair_lt(t, xl)
    xl_eq = pair_eq(xl, t)
    carry = _carry_mode(mode, xl_gt, xl_gt | xl_eq, xl_eq,
                        pair_is_neg(p), pair_is_pos(p),
                        (xh[1] & _U32(1)) == 1)
    cpair = (jnp.zeros_like(p[0]), carry.astype(_U32))
    return pair_add(xh, cpair)


def _pair_select(cond, a, b):
    return jnp.where(cond, a[0], b[0]), jnp.where(cond, a[1], b[1])


def requantize_pair_keep(p, from_frac: int, fmt: QFormat):
    """Bit-exact requantize of a 64-bit pair into a format with **pair
    storage** (33 <= storage_bits <= 64): round, then apply the overflow
    stage entirely in the pair domain.  Returns a (hi, lo) tuple.

    This is the device path for the reference's first multiword-ArbiInt
    regime (QuBLAS.h:566-912): formats too wide for one int32 lane but
    fitting two.  Caller proves (``widths.route_requant``) that the input
    and every rounding intermediate fit 64 bits.
    """
    y = _round_pair(p, from_frac, fmt)
    w = fmt.storage_bits
    omode = fmt.overflow_mode
    if omode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                 OverflowMode.SAT_SMGN):
        hi_b = pair_const((1 << (w - 1)) - 1, shape=y[0].shape)
        if not fmt.signed:
            lo_v = 0
        elif omode == OverflowMode.SAT_SMGN:
            lo_v = -(1 << (w - 1)) + 1
        else:
            lo_v = -(1 << (w - 1))
        lo_b = pair_const(lo_v, shape=y[0].shape)
        over = pair_lt(hi_b, y)
        under = pair_lt(y, lo_b)
        if omode == OverflowMode.SAT_ZERO:
            zero = (jnp.zeros_like(y[0]), jnp.zeros_like(y[1]))
            return _pair_select(over | under, zero, y)
        y = _pair_select(over, hi_b, y)
        return _pair_select(under, lo_b, y)
    if omode == OverflowMode.WRP_TCPL:
        if fmt.signed:
            if w >= 64:
                return y
            if w > 32:
                hw = w - 32  # 1..31 bits live in the high limb
                mask_hi = _I32((1 << hw) - 1)
                m = y[0] & mask_hi
                sign = (m >> (hw - 1)) & _I32(1)
                return jnp.where(sign == 1, m | ~mask_hi, m), y[1]
            if w == 32:
                lo_i = _bitcast_i32(y[1])
                return lo_i >> 31, y[1]
            m32 = _overflow_i32(_bitcast_i32(y[1]), fmt)
            return m32 >> 31, _bitcast_u32(m32)
        wb = w - 1  # unsigned wrap masks to int_bits+frac_bits (QuBLAS.h:2329)
        if wb >= 64:
            return y
        if wb > 32:
            return y[0] & _I32((1 << (wb - 32)) - 1), y[1]
        if wb == 32:
            return jnp.zeros_like(y[0]), y[1]
        mask = _U32((1 << wb) - 1) if wb else _U32(0)
        return jnp.zeros_like(y[0]), y[1] & mask
    if omode == OverflowMode.WRP_TCPL_SAT:
        # identity stub (QuBLAS.h:2336-2344); the 64-bit machine-word wrap
        # at the store is inherent to the mod-2^64 pair representation
        return y
    raise AssertionError(omode)


def requantize_pair(p, from_frac: int, fmt: QFormat):
    """Bit-exact requantize of a 64-bit (hi, lo) pair down to int32.

    The result must fit int32 (guaranteed when ``fmt.storage_bits <= 32``
    and the overflow mode is saturating/wrapping; WRP_TCPL_SAT — the
    reference identity stub — additionally requires the caller to prove the
    unclamped value fits, else the host path is used).
    """
    y = _round_pair(p, from_frac, fmt)

    # overflow stage on the pair, then truncate to int32
    w = fmt.storage_bits
    omode = fmt.overflow_mode
    if omode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                 OverflowMode.SAT_SMGN):
        hi_b = pair_const((1 << (w - 1)) - 1, shape=y[0].shape)
        if not fmt.signed:
            lo_v = 0
        elif omode == OverflowMode.SAT_SMGN:
            lo_v = -(1 << (w - 1)) + 1
        else:
            lo_v = -(1 << (w - 1))
        lo_b = pair_const(lo_v, shape=y[0].shape)
        over = pair_lt(hi_b, y)
        under = pair_lt(y, lo_b)
        if omode == OverflowMode.SAT_ZERO:
            val = pair_to_int32(y)
            return jnp.where(over | under, _I32(0), val)
        val = pair_to_int32(y)
        val = jnp.where(over, pair_to_int32(hi_b), val)
        val = jnp.where(under, pair_to_int32(lo_b), val)
        return val
    if omode == OverflowMode.WRP_TCPL:
        if fmt.signed:
            if w >= 33:
                return pair_to_int32(y)  # low 32 bits, sign-extended by cast
            m32 = pair_to_int32(y)
            return _overflow_i32(m32, fmt) if w < 32 else m32
        wb = w - 1
        m32 = pair_to_int32(y)
        if wb >= 32:
            return m32
        return m32 & _I32((1 << wb) - 1)
    if omode == OverflowMode.WRP_TCPL_SAT:
        # identity stub + machine-word wrap at the store: truncating the
        # pair to its low 32 bits IS the int32 wrap (storage > 32 routes to
        # host before reaching here)
        return pair_to_int32(y)
    raise AssertionError(omode)
