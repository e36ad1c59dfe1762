"""Exact wide integer dot products as int8 matmuls via balanced digits.

Proof-lossless GEMM dots that
outgrow the 64-bit pair domain — wide pair-storage operands (e.g. a
40-bit x 40-bit GEMM has 80-bit products), stacked-limb operands, or
limb-storage outputs — would otherwise run the order-preserving streaming
tree elementwise.  The losslessness proof (:func:`qublas_tpu.ops.gemm.exact_plan`)
makes *any* association and distribution order bit-identical, which admits
a far better device mapping:

1. **Balanced digit decomposition.**  Each operand value is written exactly
   as ``sum_i d_i * 256**i`` with digits ``d_i in [-128, 127]`` (one extra
   digit absorbs the sign).  This is the standard carry-adjusted transform
   of the unsigned base-256 bytes of the two's-complement representation:
   bytes >= 128 borrow 256 and carry +1 into the next byte.  Every digit
   fits an **int8 lane**.

2. **One batched int8 matmul.**  With ``A = sum_i 256**i A_i`` and
   ``B = sum_j 256**j B_j``, the dot decomposes as
   ``dot(A, B) = sum_{i,j} 256**(i+j) dot(A_i, B_j)`` — ``Da * Db``
   int8 x int8 -> int32 dot products, all issued as a single
   ``dot_general`` with a K-segment batch dimension — the integer matmul
   the device's libraries run natively (int8 tensor cores on the GPU).  Per-digit products are bounded by 2**14, so the
   K dimension is split into segments short enough that every per-segment
   accumulation (and the per-scale group sum below) provably fits int32.

3. **Exact limb recombination.**  Per-segment, the ``Da*Db`` dots group by
   scale ``s = i + j`` (int32-exact by the segment bound), then fold into a
   stacked uint32 limb accumulator (:mod:`.limbint`) with static shifts and
   ripple-carry adds; segments fold with exact limb adds.  Working limb
   counts come from exact interval arithmetic (:func:`work_bits`) — the
   same proof discipline as every other device path.

This replaces the reference's arbitrary-width tree dot capability
(``include/QuBLAS.h:4960-4990``) with an integer-matmul program
instead of an elementwise emulation: a 40-bit-operand GEMM becomes ~49 int8 matmuls
(one fused ``dot_general``) rather than per-element 64-bit pair arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import limbint as L
from .widths import Interval

__all__ = ["digits_needed", "balanced_digits", "limb_axis_sum",
           "limb_dot_2d", "work_bits", "to_limbs_any", "i32_to_limbs",
           "digit_matmuls"]

_U32 = jnp.uint32
_I32 = jnp.int32

# per-digit product bound: digits are in [-128, 127]
_DIGIT_PROD_MAX = 128 * 128  # 2^14
_I32_MAX = (1 << 31) - 1


def digits_needed(iv: Interval) -> int:
    """Balanced base-256 digits for every value in ``iv``: the bytes of the
    two's-complement representation plus ONE extra digit that absorbs the
    sign byte / final carry (see :func:`balanced_digits`)."""
    return -(-iv.bits // 8) + 1


def digit_matmuls(iva: Interval, ivb: Interval) -> int:
    """Number of int8 digit-pair matmuls a wide dot of these operands costs
    (the admission gates bound this so compile/compute stay sane)."""
    return digits_needed(iva) * digits_needed(ivb)


def to_limbs_any(x, K: int):
    """Lane array / PairArray / LimbArray -> sign-extended (K, ...) limbs."""
    from .wideint import PairArray, _bitcast_u32

    if isinstance(x, L.LimbArray):
        return L.lext(x.limbs, K)
    if isinstance(x, PairArray):
        return L.lext(jnp.stack([x.lo, _bitcast_u32(x.hi)], axis=0), K)
    x32 = x.astype(_I32)
    return L.lext(jax.lax.bitcast_convert_type(x32, _U32)[None], K)


def i32_to_limbs(x, K: int):
    """Sign-extended (K, ...) limbs of an int32 array."""
    return L.lext(jax.lax.bitcast_convert_type(x, _U32)[None], K)


def balanced_digits(x, nd: int):
    """Exact balanced base-256 digits of a device integer tensor.

    ``x`` is a lane array, PairArray, or LimbArray whose values fit
    ``8 * (nd - 1)`` bits two's complement (``nd = digits_needed(iv)``).
    Returns an int8 array of shape ``(nd, *x.shape)`` with digits in
    ``[-128, 127]`` such that ``value == sum_i digits[i] * 256**i``.

    Correctness: let ``u_0..u_{nd-1}`` be the unsigned bytes of the value
    sign-extended to ``nd`` bytes (byte ``nd-1`` is pure sign fill, 0x00 or
    0xFF).  The transform ``t = u_i + c;  d_i = t - 256*[t >= 128];
    c' = [t >= 128]`` keeps the running identity
    ``sum_{i<j} d_i 256**i + c * 256**j == sum_{i<j} u_i 256**i`` at every
    step.  At the sign byte: non-negative values have ``u = 0, t = c <= 1``
    so ``d = c`` closes with no carry; negative values have ``u = 255``,
    ``t in {255, 256}``, and the dropped final carry ``c' = 1`` exactly
    cancels the ``-2**(8*nd)`` excess of the unsigned-byte reading of the
    two's-complement pattern.
    """
    K = -(-nd // 4)
    limbs = to_limbs_any(x, K)
    c = jnp.zeros(limbs.shape[1:], dtype=_I32)
    out = []
    for i in range(nd):
        u = ((limbs[i // 4] >> _U32(8 * (i % 4))) & _U32(0xFF)).astype(_I32)
        t = u + c
        ge = t >= 128
        out.append((t - 256 * ge.astype(_I32)).astype(jnp.int8))
        c = ge.astype(_I32)
    return jnp.stack(out, axis=0)


def limb_axis_sum(limbs, axis: int):
    """Log-depth exact limb summation over element axis ``axis`` (the
    stacked array's axis ``axis + 1``), zero-padded to even at each level.
    Valid under a losslessness proof (any order yields identical bits) with
    every partial bounded to the limb working width by the caller."""
    ax = axis + 1 if axis >= 0 else axis  # stacked layout: limb axis leads
    while limbs.shape[ax] > 1:
        if limbs.shape[ax] % 2:
            pad = [(0, 0)] * limbs.ndim
            pad[ax if ax >= 0 else limbs.ndim + ax] = (0, 1)
            limbs = jnp.pad(limbs, pad)

        def take(s):
            idx = [slice(None)] * limbs.ndim
            idx[ax if ax >= 0 else limbs.ndim + ax] = slice(s, None, 2)
            return limbs[tuple(idx)]

        limbs = L.ladd(take(0), take(1))
    idx = [slice(None)] * limbs.ndim
    idx[ax if ax >= 0 else limbs.ndim + ax] = 0
    return limbs[tuple(idx)]


def _seg_len(k: int, gmax: int) -> int:
    """Largest K-segment such that every per-digit-pair segment dot AND
    every per-scale group sum (<= gmax terms) provably fits int32."""
    return max(min(_I32_MAX // (_DIGIT_PROD_MAX * gmax), k), 1)


def work_bits(iva: Interval, ivb: Interval, k: int) -> int:
    """Exact working width (bits) of the limb accumulator: covers the dot
    (and by subset-sum every partial — :func:`.gemm.dot_partial_interval`),
    every per-scale recombination partial, and one bit of negation
    headroom."""
    from .gemm import dot_partial_interval

    da, db = digits_needed(iva), digits_needed(ivb)
    gmax = min(da, db)
    seg = _seg_len(k, gmax)
    # per-scale columns are bounded by seg * gmax * 2^14; the recombination
    # partial after scale s is bounded by sum_{t<=s} |col| * 256^t
    col = seg * gmax * _DIGIT_PROD_MAX
    part = 0
    worst = 0
    for s in range(da + db - 1):
        part += col << (8 * s)
        worst = max(worst, part)
    dot_iv = dot_partial_interval(iva * ivb, k)
    return max(Interval(-worst, worst).bits, dot_iv.bits)


def limb_dot_2d(ad, bd, iva: Interval, ivb: Interval, Kw: int):
    """Exact ``(Kw, m, n)`` stacked-limb dot of ``[m, k] @ [k, n]``.

    Operands may be lane arrays, PairArrays, or LimbArrays; ``iva``/``ivb``
    bound their raw values (format storage intervals); ``Kw`` must cover
    :func:`work_bits` — the caller's admission gate proves this.  Valid
    only under a losslessness proof: the digit decomposition is exact per
    element, every int32 segment/group accumulation is exact by the segment
    bound, and the limb recombination is exact mod nothing because every
    partial fits ``32 * Kw`` bits.
    """
    k = ad.shape[-1]
    da, db = digits_needed(iva), digits_needed(ivb)
    gmax = min(da, db)
    seg = _seg_len(k, gmax)
    nseg = -(-k // seg)
    pad = nseg * seg - k

    a_dig = balanced_digits(ad, da)                     # (da, m, k) int8
    b_dig = balanced_digits(bd, db)                     # (db, k, n) int8
    if pad:
        a_dig = jnp.pad(a_dig, ((0, 0), (0, 0), (0, pad)))
        b_dig = jnp.pad(b_dig, ((0, 0), (0, pad), (0, 0)))
    m, n = a_dig.shape[1], b_dig.shape[2]
    a_r = a_dig.reshape(da, m, nseg, seg)
    b_r = b_dig.reshape(db, nseg, seg, n)
    # ONE fused int8 dot_general: batch dim s (K-segments), contraction l,
    # free digit dims x/y — the whole wide dot as one int8 matmul
    dots = jnp.einsum("xmsl,ysln->xysmn", a_r, b_r,
                      preferred_element_type=_I32)      # (da, db, nseg, m, n)

    acc = None
    for s in range(da + db - 1):
        cols = [dots[i, s - i] for i in range(max(0, s - db + 1),
                                              min(da - 1, s) + 1)]
        col = cols[0]
        for c in cols[1:]:
            col = col + c                               # int32-exact by seg
        term = L.lshl(i32_to_limbs(col, Kw), 8 * s)     # (Kw, nseg, m, n)
        acc = term if acc is None else L.ladd(acc, term)
    return limb_axis_sum(acc, 0)                        # (Kw, m, n)
