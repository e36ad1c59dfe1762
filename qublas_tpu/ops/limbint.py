"""Exact N-limb integer emulation on 32-bit lanes (beyond 64 bits).

Generalizes :mod:`.wideint`'s (hi, lo) pair to K uint32 limbs so formats with
65..384-bit physical storage — the reference's deep multiword ``ArbiInt``
territory (reference ``include/QuBLAS.h:566-912``; its generated test grids
go to 200-bit formats, ``test/ArbiInt/``) — are **device-resident** instead of
host-side Python ints.  Values are two's complement over ``32*K`` bits,
little-endian limbs, stacked on a **leading** axis ``(K, *elem_shape)`` so the
element dims stay the minor (contiguous) dims on device.

Everything is pure jnp on uint32 lanes with static limb counts, static shift
amounts and static loop bounds — XLA sees straight-line code it can fuse; the
ops run identically on the GPU and the CPU test backend, inside jit/vmap/
shard_map.

Width contract: callers prove via :mod:`.widths` (exact interval arithmetic)
that every value and intermediate fits the working limb count ``K``; the
requantize epilogue then proves its own output fits the destination storage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..qformat import OverflowMode, QFormat, RoundMode
from .wideint import _carry_mode

__all__ = [
    "LimbArray", "limbs_from_ints", "ints_from_limbs",
    "lext", "ladd", "lsub", "lneg", "lmul", "lshl", "lshr", "llow_bits",
    "llt", "lltu", "ldiv_trunc", "leq", "lis_neg", "lis_pos", "lconst",
    "lto_i32", "lselect",
    "lbroadcast_elem", "requantize_limb", "store_limbs", "bits_to_limbs",
]

_U32 = jnp.uint32
_I32 = jnp.int32


def bits_to_limbs(bits: int) -> int:
    """Limbs needed for a signed two's-complement value of ``bits`` bits."""
    return max((bits + 31) // 32, 1)


@jax.tree_util.register_pytree_node_class
class LimbArray:
    """Device-resident >64-bit integer tensor: (K, *shape) uint32 limbs.

    Storage form of QTensor data for formats with 65..384-bit physical
    width.  Mirrors :class:`.wideint.PairArray`'s structural API; arithmetic
    lives in this module's ``l*`` functions, which operate on the stacked
    ``(K, ...)`` uint32 array directly.
    """

    __slots__ = ("limbs",)

    def __init__(self, limbs):
        self.limbs = limbs

    def tree_flatten(self):
        return (self.limbs,), None

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(children[0])

    @property
    def nlimbs(self):
        return self.limbs.shape[0]

    @property
    def shape(self):
        return self.limbs.shape[1:]

    @property
    def ndim(self):
        return self.limbs.ndim - 1

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return LimbArray(self.limbs[(slice(None),) + idx])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        k = self.limbs.shape[0]
        return LimbArray(self.limbs.reshape((k,) + tuple(shape)))

    def swapaxes(self, a, b):
        nd = self.ndim
        a, b = a % nd, b % nd
        return LimbArray(self.limbs.swapaxes(a + 1, b + 1))

    def to_numpy_ints(self):
        """Exact host transfer: object ndarray of signed Python ints."""
        return ints_from_limbs(self.limbs)

    def __repr__(self):
        return (f"LimbArray(nlimbs={self.limbs.shape[0]}, "
                f"shape={tuple(self.shape)})")


def limbs_from_ints(values, K: int):
    """Host object array of Python ints -> (K, *shape) uint32 stacked limbs.

    Values must fit ``32*K`` bits signed two's complement (raises
    OverflowError otherwise — callers pre-check with bit_length).
    ``int.to_bytes`` does the split at C speed, one call per element.
    """
    import numpy as np

    arr = np.asarray(values, dtype=object)
    nbytes = 4 * K
    buf = b"".join(int(v).to_bytes(nbytes, "little", signed=True)
                   for v in arr.reshape(-1))
    flat = np.frombuffer(buf, dtype=np.uint32).reshape(-1, K)
    stacked = np.ascontiguousarray(flat.T).reshape((K,) + arr.shape)
    return jnp.asarray(stacked)


def ints_from_limbs(limbs):
    """(K, *shape) uint32 limbs -> object ndarray of signed Python ints."""
    import numpy as np

    arr = np.asarray(limbs)
    K = arr.shape[0]
    shape = arr.shape[1:]
    flat = np.ascontiguousarray(arr.reshape(K, -1).T)
    raw = flat.tobytes()
    nbytes = 4 * K
    n = flat.shape[0]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little",
                                signed=True)
    return out.reshape(shape)


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, _I32)


def _bitcast_u32(x):
    return jax.lax.bitcast_convert_type(x, _U32)


def _top_i32(x):
    return _bitcast_i32(x[-1])


def _sign_fill(x):
    """All-ones limb where negative, zero where non-negative."""
    return _bitcast_u32(_top_i32(x) >> 31)


def lext(x, K: int):
    """Sign-extend (or truncate) stacked limbs to exactly K limbs."""
    kin = x.shape[0]
    if K == kin:
        return x
    if K < kin:
        return x[:K]
    fill = jnp.broadcast_to(_sign_fill(x)[None], (K - kin,) + x.shape[1:])
    return jnp.concatenate([x, fill], axis=0)


def lconst(c: int, K: int, shape=()):
    """Python int -> broadcast constant limbs (mod 2^(32K))."""
    c &= (1 << (32 * K)) - 1
    rows = [jnp.full(shape, (c >> (32 * i)) & 0xFFFFFFFF, dtype=_U32)
            for i in range(K)]
    return jnp.stack(rows, axis=0)


def ladd(a, b):
    """Exact add mod 2^(32K) (ripple carry; K is static and small)."""
    K = a.shape[0]
    out = []
    c = None
    for i in range(K):
        t = a[i] + b[i]
        c1 = t < a[i]
        if c is None:
            u, cout = t, c1
        else:
            u = t + c.astype(_U32)
            cout = c1 | (u < t)
        out.append(u)
        c = cout
    return jnp.stack(out, axis=0)


def lneg(a):
    """Two's-complement negation mod 2^(32K)."""
    K = a.shape[0]
    out = []
    c = None  # incoming +1 carry (starts as literal 1)
    for i in range(K):
        inv = ~a[i]
        if c is None:
            u = inv + _U32(1)
            cout = u == 0
        else:
            u = inv + c.astype(_U32)
            cout = c & (u == 0)
        out.append(u)
        c = cout
    return jnp.stack(out, axis=0)


def lsub(a, b):
    return ladd(a, lneg(b))


def lselect(cond, a, b):
    """Per-element select between two stacked-limb arrays."""
    return jnp.where(cond[None], a, b)


def lbroadcast_elem(x, shape):
    """Broadcast the element dims of stacked limbs to ``shape`` (the limb
    axis leads, so plain jnp right-aligned broadcasting can't be used
    between stacked arrays of different element ranks)."""
    K = x.shape[0]
    pad = len(shape) - (x.ndim - 1)
    x = x.reshape((K,) + (1,) * pad + x.shape[1:])
    return jnp.broadcast_to(x, (K,) + tuple(shape))


def lshl(x, d: int):
    """Static left shift mod 2^(32K)."""
    if d == 0:
        return x
    K = x.shape[0]
    D, b = d // 32, d % 32
    zero = jnp.zeros_like(x[0])
    out = []
    for i in range(K):
        if i < D:
            out.append(zero)
            continue
        v = x[i - D] << b if b else x[i - D]
        if b and i - D - 1 >= 0:
            v = v | (x[i - D - 1] >> (32 - b))
        out.append(v)
    return jnp.stack(out, axis=0)


def lshr(x, d: int):
    """Static arithmetic (sign-propagating) right shift."""
    if d == 0:
        return x
    K = x.shape[0]
    D, b = d // 32, d % 32
    fill = _sign_fill(x)
    out = []
    for i in range(K):
        src = i + D
        v = x[src] if src < K else fill
        nxt = x[src + 1] if src + 1 < K else fill
        out.append(((v >> b) | (nxt << (32 - b))) if b else v)
    return jnp.stack(out, axis=0)


def llow_bits(x, d: int):
    """val & (2^d - 1) as (non-negative) stacked limbs, 0 <= d < 32K."""
    K = x.shape[0]
    D, b = d // 32, d % 32
    zero = jnp.zeros_like(x[0])
    out = []
    for i in range(K):
        if i < D:
            out.append(x[i])
        elif i == D and b:
            out.append(x[i] & _U32((1 << b) - 1))
        else:
            out.append(zero)
    return jnp.stack(out, axis=0)


def lltu(a, b):
    """Unsigned a < b (lexicographic over uint32 limbs)."""
    K = a.shape[0]
    res = a[K - 1] < b[K - 1]
    eq = a[K - 1] == b[K - 1]
    for i in range(K - 2, -1, -1):
        res = res | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return res


def ldiv_trunc(a, b, nbits: int):
    """C++-style truncating division of signed stacked-limb values (round 4:
    the limb route for Qdiv, ``widths.route_div`` — completes device division
    across every storage kind; reference Qdiv semantics per REFERENCE_DEFECTS
    D1 since the reference's own Qdiv is uninstantiable, QuBLAS.h:3252).

    Restoring long division on magnitudes: the numerator's magnitude is
    proven ``< 2**nbits`` by the caller's width proof.  ``Interval.bits``
    includes one bit of negation headroom, so (a) ``lneg`` never wraps and
    (b) with K covering ``den.bits`` the shifted remainder
    ``R<<1 | bit < 2*|b| < 2^den.bits <= 2^(32K)`` never overflows the
    limbs (the compare/subtract are fully unsigned, so the top bit of the
    working width carries no sign meaning here).
    ``nbits`` shift-compare-subtract steps run in a ``fori_loop``; each step
    is straight-line limb code with static shifts.  The quotient takes the
    XOR sign — truncation toward zero, exactly C++ ``/``.

    Division by zero returns an all-ones magnitude pattern (every restoring
    compare succeeds); the CALLER masks it to the reference's zero wart,
    mirroring ``wideint.pair_div_trunc``.
    """
    K = a.shape[0]
    assert 0 < nbits <= 32 * K
    neg_a = lis_neg(a)
    neg_b = lis_neg(b)
    ua = lselect(neg_a, lneg(a), a)
    ub = lselect(neg_b, lneg(b), b)
    # pre-align the numerator so its nbits window sits at the top: each
    # step then shifts left and consumes the MSB, all shifts static
    x0 = lshl(ua, 32 * K - nbits)
    z = jnp.zeros_like(ua)

    def step(_, st):
        x, r, q = st
        bit = x[K - 1] >> 31
        x = lshl(x, 1)
        r = lshl(r, 1)
        r = jnp.concatenate([(r[0] | bit)[None], r[1:]], axis=0)
        ge = ~lltu(r, ub)
        r = lselect(ge, lsub(r, ub), r)
        q = lshl(q, 1)
        q = jnp.concatenate([(q[0] | ge.astype(_U32))[None], q[1:]], axis=0)
        return x, r, q

    _x, _r, q = jax.lax.fori_loop(0, nbits, step, (x0, z, z))
    return lselect(neg_a != neg_b, lneg(q), q)


def llt(a, b):
    """Signed a < b (top limb signed, lower limbs unsigned lexicographic)."""
    K = a.shape[0]
    res = _bitcast_i32(a[K - 1]) < _bitcast_i32(b[K - 1])
    eq = a[K - 1] == b[K - 1]
    for i in range(K - 2, -1, -1):
        res = res | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return res


def leq(a, b):
    K = a.shape[0]
    res = a[0] == b[0]
    for i in range(1, K):
        res = res & (a[i] == b[i])
    return res


def lis_neg(a):
    return _top_i32(a) < 0


def lis_pos(a):
    nz = a[0] != 0
    for i in range(1, a.shape[0]):
        nz = nz | (a[i] != 0)
    return nz & ~lis_neg(a)


def lto_i32(a):
    """Truncate to int32 (caller guarantees the value fits)."""
    return _bitcast_i32(a[0])


def lmul(a, b, K: int):
    """Exact signed product mod 2^(32K) of two stacked-limb values.

    Sign-extends both operands to K limbs, then unsigned schoolbook over
    16-bit digits (each 16x16 partial product fits uint32; column sums stay
    far below 2^32 for K <= 32), one carry-propagate pass at the end.  Exact
    two's-complement product whenever the true product fits 32K bits —
    which the caller proves via interval arithmetic.
    """
    a = lext(a, K)
    b = lext(b, K)
    D = 2 * K
    m16 = _U32(0xFFFF)
    da = []
    db = []
    for i in range(K):
        da.append(a[i] & m16)
        da.append(a[i] >> 16)
        db.append(b[i] & m16)
        db.append(b[i] >> 16)
    zero = jnp.zeros_like(a[0])
    cols = [None] * D
    for i in range(D):
        for j in range(D - i):
            p = da[i] * db[j]
            lo, hi = p & m16, p >> 16
            c = i + j
            cols[c] = lo if cols[c] is None else cols[c] + lo
            if c + 1 < D:
                cols[c + 1] = hi if cols[c + 1] is None else cols[c + 1] + hi
    digits = []
    carry = zero
    for j in range(D):
        s = (cols[j] if cols[j] is not None else zero) + carry
        digits.append(s & m16)
        carry = s >> 16
    out = [digits[2 * i] | (digits[2 * i + 1] << 16) for i in range(K)]
    return jnp.stack(out, axis=0)


# ---------------------------------------------------------------------------
# Requantization epilogue (fracConvert + intConvert on stacked limbs)
# ---------------------------------------------------------------------------

def _round_limb(x, from_frac: int, fmt: QFormat):
    """Rounding stage (reference fracConvert, QuBLAS.h:2002-2204) on stacked
    limbs.  Caller sizes ``x`` so the value, the shifted value, and (for RND
    modes) the 2^(d-1) tie threshold all fit the limb count."""
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    if d <= 0:
        return lshl(x, -d) if d else x
    K = x.shape[0]
    # the route sizes K so the value (+1 negation headroom) and the
    # 2^(d-1) tie threshold both fit — see widths.route_requant
    assert d < 32 * K, "working limb count must cover the shift"
    if mode == RoundMode.TRN_TCPL:
        return lshr(x, d)
    if mode == RoundMode.TRN_SMGN:
        neg = lis_neg(x)
        pos_res = lshr(x, d)
        neg_res = lneg(lshr(lneg(x), d))
        return lselect(neg, neg_res, pos_res)
    xh = lshr(x, d)
    xl = llow_bits(x, d)
    t = lconst(1 << (d - 1), K, x.shape[1:])
    xl_gt = llt(t, xl)
    xl_eq = leq(xl, t)
    carry = _carry_mode(mode, xl_gt, xl_gt | xl_eq, xl_eq,
                        lis_neg(x), lis_pos(x), (xh[0] & _U32(1)) == 1)
    cl = [carry.astype(_U32)] + [jnp.zeros_like(xh[0])] * (K - 1)
    return ladd(xh, jnp.stack(cl, axis=0))


def _overflow_limb(y, fmt: QFormat):
    """intConvert (QuBLAS.h:2206-2344) on stacked limbs."""
    K = y.shape[0]
    w = fmt.storage_bits
    omode = fmt.overflow_mode
    shape = y.shape[1:]
    if omode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                 OverflowMode.SAT_SMGN):
        hi_b = lconst((1 << (w - 1)) - 1, K, shape)
        if not fmt.signed:
            lo_v = 0
        elif omode == OverflowMode.SAT_SMGN:
            lo_v = -(1 << (w - 1)) + 1
        else:
            lo_v = -(1 << (w - 1))
        lo_b = lconst(lo_v, K, shape)
        over = llt(hi_b, y)
        under = llt(y, lo_b)
        if omode == OverflowMode.SAT_ZERO:
            return lselect(over | under, jnp.zeros_like(y), y)
        y = lselect(over, hi_b, y)
        return lselect(under, lo_b, y)
    if omode == OverflowMode.WRP_TCPL:
        wb = w if fmt.signed else w - 1  # unsigned wraps at int+frac bits
        # widths.requant_work_bits sizes K to storage_bits+2, so the mask
        # and the -(2^wb) sign-extension addend always fit the working width
        assert wb < 32 * K, "working limb count must cover the wrap width"
        m = llow_bits(y, wb) if wb else jnp.zeros_like(y)
        if not fmt.signed:
            return m
        # sign-extend bit wb-1 over the limbs above
        sign = (m[(wb - 1) // 32] >> ((wb - 1) % 32)) & _U32(1)
        ext = ladd(m, lconst(-(1 << wb), K, shape))
        return lselect(sign == 1, ext, m)
    if omode == OverflowMode.WRP_TCPL_SAT:
        # reference identity stub (QuBLAS.h:2336-2344); the machine-word
        # wrap happens at the store truncation (storage limb count is the
        # 64-bit-multiple word, see widths.limb_count)
        return y
    raise AssertionError(omode)


def requantize_limb(x, from_frac: int, fmt: QFormat):
    """Bit-exact requantize of stacked limbs into ``fmt``'s storage form.

    Returns the destination's natural storage:

    * ``"lane"`` formats -> int32 array (value proven to fit by the route),
    * ``"pair"`` formats -> (hi: int32, lo: uint32) tuple,
    * ``"limb"`` formats -> stacked (K_store, ...) uint32 limbs.
    """
    y = _overflow_limb(_round_limb(x, from_frac, fmt), fmt)
    return store_limbs(y, fmt)


def store_limbs(y, fmt: QFormat):
    """Truncate stacked limbs into ``fmt``'s storage form (the value is
    proven to fit, or the format's machine-word wrap is the truncation)."""
    from .widths import limb_count, storage_kind

    kind = storage_kind(fmt)
    if kind == "lane":
        return lto_i32(y)
    if kind == "pair":
        y = lext(y, 2)
        return _bitcast_i32(y[1]), y[0]
    return lext(y, limb_count(fmt))
