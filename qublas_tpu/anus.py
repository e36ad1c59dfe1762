"""ANUS — Advanced Nonlinear Universal Subprograms.

Device re-design of the reference's ``ANUS`` namespace ("the operations
like lookup table, linear/polynomial fitting, etc. used to implement the
non-linear operation in asic", reference ``include/QuBLAS.h:4829-4897``)
plus the readme-documented LUTs (``readme.md:66-78`` — absent from the header
at this snapshot; see SURVEY.md §0/§2.15).

* :func:`qpoly` — Horner-form polynomial where **each level's add and
  multiply quantize to that level's leading coefficient format**
  (``Qadd<decltype(a0)>(a0, Qmul<decltype(a0)>(x, Qpoly<a1,...>(x)))``,
  QuBLAS.h:4836-4851).
* :func:`qapprox` — segmented polynomial fit: segment selected by comparing
  the input's *double* value against breakpoints, result requantized into
  the input's format (``decltype(x){...}`` converting ctor,
  QuBLAS.h:4854-4884).  The double compare is resolved exactly on integer
  raws via a host-side rational threshold, so the device path is a chain of
  integer selects — no floats touch the device.
* :func:`qtable` / :class:`QTable` — exact LUTs: every input bit pattern maps
  through a Python-double function and requantizes into the output format —
  precisely what an ASIC ROM does.  Tables are built host-side with the
  exact conversion pipeline and applied on device as a fused select tree
  (or a gather for large tables).
  Predefined functions: :data:`rsqrt_func`, :data:`reciprocal_func`,
  :data:`sqrt_func` (``readme.md:66-75``); non-finite outputs store 0,
  matching ``loadFromDouble``'s non-finite handling (QuBLAS.h:451-455).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

from . import hostint, hostops
from .qformat import QFormat
from .qtensor import QTensor, from_raw
from .ops import elementwise as ew
from .ops.widths import dtype_for

__all__ = [
    "qpoly", "qapprox", "Segment", "qtable", "QTable", "build_table",
    "rsqrt_func", "reciprocal_func", "sqrt_func",
]


# ---------------------------------------------------------------------------
# Polynomial fitting
# ---------------------------------------------------------------------------

def qpoly(x: QTensor, coeffs: Sequence[QTensor]) -> QTensor:
    """Horner evaluation ``a0 + x*(a1 + x*(a2 + ...))`` with per-level
    quantization typed by each level's leading coefficient
    (QuBLAS.h:4836-4851).

    ``coeffs`` are scalar QTensors ``[a0, a1, ..., an]`` (build with
    :func:`qublas_tpu.qtensor.scalar`).  Each level computes
    ``qadd(a_i, qmul(x, inner, to=a_i.fmt), to=a_i.fmt)``.
    """
    coeffs = list(coeffs)
    if not coeffs:
        raise ValueError("qpoly needs at least one coefficient")
    acc = coeffs[-1]
    for a in reversed(coeffs[:-1]):
        acc = ew.qadd(a, ew.qmul(x, acc, to=a.fmt), to=a.fmt)
    return acc


class Segment:
    """A breakpoint + polynomial coefficients (reference ``ANUS::Segment``,
    QuBLAS.h:4855-4866): applies while ``x.toDouble() < breakpoint``; the
    last segment also covers everything above its breakpoint."""

    def __init__(self, breakpoint: float, coeffs: Sequence[QTensor]):
        self.breakpoint = float(breakpoint)
        self.coeffs = list(coeffs)


def _raw_threshold(breakpoint: float, fmt: QFormat, word_bits: int):
    """Largest storable raw r whose ROUNDED double value satisfies
    ``raw_to_double(r, fmt) < breakpoint``, or None when no storable raw
    does.

    The reference selects segments by ``input.toDouble() < breakpoint``
    (QuBLAS.h:4878), so the comparison sees the double-ROUNDED value: for
    raws with more than 53 significant bits, float(raw) rounding can cross
    the breakpoint, and an exact-rational threshold would disagree with the
    oracle.  ``raw_to_double`` is monotone non-decreasing in the raw, so
    the predicate is a prefix — bisect its edge (<= word_bits exact float
    comparisons, trace-time only)."""
    lo = -(1 << (word_bits - 1))
    hi = (1 << (word_bits - 1)) - 1
    if not (hostint.raw_to_double(lo, fmt) < breakpoint):
        return None
    if hostint.raw_to_double(hi, fmt) < breakpoint:
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if hostint.raw_to_double(mid, fmt) < breakpoint:
            lo = mid
        else:
            hi = mid
    return lo


def qapprox(x: QTensor, segments: Sequence[Segment]) -> QTensor:
    """Segmented polynomial fit (reference ``ANUS::Qapprox``,
    QuBLAS.h:4868-4884).

    Per element: the first segment whose breakpoint exceeds the value
    applies (the last segment catches the rest), and the segment's
    :func:`qpoly` result is requantized into **x's format** (the
    ``decltype(x){...}`` converting construction).
    """
    import jax.numpy as jnp

    segments = list(segments)
    if not segments:
        raise ValueError("qapprox needs at least one segment")

    def _bcast(br: QTensor) -> QTensor:
        # a constant segment (single coefficient) evaluates to a scalar —
        # broadcast it to x's shape so per-element selection works
        if tuple(br.shape) == tuple(x.shape):
            return br
        if br.is_host:
            return QTensor(np.broadcast_to(br.data, x.shape), br.fmt)
        if br.is_pair:
            from .ops.wideint import PairArray

            return QTensor(PairArray(jnp.broadcast_to(br.data.hi, x.shape),
                                     jnp.broadcast_to(br.data.lo, x.shape)),
                           br.fmt)
        if br.is_limb:
            from .ops.limbint import LimbArray, lbroadcast_elem

            return QTensor(LimbArray(lbroadcast_elem(br.data.limbs, x.shape)),
                           br.fmt)
        return QTensor(jnp.broadcast_to(br.data, x.shape), br.fmt)

    # evaluate every segment's polynomial requantized into x's format
    branches = [_bcast(ew.qcast(qpoly(x, s.coeffs), x.fmt))
                for s in segments]
    if x.is_host:
        raws = np.asarray(x.raw(), dtype=object).reshape(-1)
        # fetch each branch once (qcast may have re-deviced a branch; a
        # per-element .raw() would round-trip the whole array every time)
        flats = [np.asarray(br.raw(), dtype=object).reshape(-1)
                 for br in branches]
        out = []
        for i, r in enumerate(raws):
            val = hostint.raw_to_double(int(r), x.fmt)
            for s, flat in zip(segments, flats):
                if val < s.breakpoint:
                    out.append(int(flat[i]))
                    break
            else:
                out.append(int(flats[-1][i]))
        return from_raw(np.array(out, dtype=object).reshape(x.shape), x.fmt)

    if x.is_pair:
        # 33..64-bit storage: integer select chain in the pair domain
        from .ops import wideint as W

        xp = (x.data.hi, x.data.lo)
        result = branches[-1].data
        for s, br in zip(reversed(segments[:-1]), reversed(branches[:-1])):
            thr = _raw_threshold(s.breakpoint, x.fmt, 64)
            if thr is None:
                continue  # breakpoint below every storable x: never taken
            tp = W.pair_const(thr, shape=x.data.hi.shape)
            take = W.pair_lt(xp, tp) | W.pair_eq(xp, tp)  # x <= thr
            result = W.PairArray(jnp.where(take, br.data.hi, result.hi),
                                 jnp.where(take, br.data.lo, result.lo))
        return QTensor(result, x.fmt)

    if x.is_limb:
        # 65..384-bit storage: the same select chain in the limb domain
        from .ops import limbint as L

        K = x.data.nlimbs
        xl = x.data.limbs
        result = branches[-1].data.limbs
        for s, br in zip(reversed(segments[:-1]), reversed(branches[:-1])):
            thr = _raw_threshold(s.breakpoint, x.fmt, 32 * K)
            if thr is None:
                continue  # breakpoint below every storable x: never taken
            tl = L.lconst(thr, K, x.shape)
            take = L.llt(xl, tl) | L.leq(xl, tl)  # x <= thr
            result = L.lselect(take, br.data.limbs, result)
        from .ops.limbint import LimbArray

        return QTensor(LimbArray(result), x.fmt)

    result = branches[-1].data
    # walk breakpoints from the last-but-one down, selecting earlier segments
    for s, br in zip(reversed(segments[:-1]), reversed(branches[:-1])):
        thr = _raw_threshold(s.breakpoint, x.fmt, 32)
        if thr is None:
            continue  # breakpoint below every storable x: never taken
        take = x.data.astype(jnp.int32) <= jnp.int32(thr)
        result = jnp.where(take, br.data, result)
    return QTensor(result, x.fmt)


# ---------------------------------------------------------------------------
# Lookup tables (ASIC ROMs)
# ---------------------------------------------------------------------------

def rsqrt_func(v: float) -> float:
    """1/sqrt(x) (readme.md:68)."""
    return 1.0 / math.sqrt(v) if v > 0 else math.inf if v == 0 else math.nan


def reciprocal_func(v: float) -> float:
    """1/x (readme.md:71)."""
    return 1.0 / v if v != 0 else math.inf


def sqrt_func(v: float) -> float:
    """sqrt(x) (readme.md:74)."""
    return math.sqrt(v) if v >= 0 else math.nan


MAX_TABLE_BITS = 20  # 1M int32 entries = 4 MB


class QTable:
    """A precomputed exact LUT: input bit pattern -> output raw value.

    ``table[p]`` holds the output for the input whose **logical-width bit
    pattern** is ``p``: the pattern is sign-interpreted per the input format
    (two's complement when signed), mapped through ``func`` in double, and
    converted with the output format's exact pipeline (non-finite -> 0).
    """

    def __init__(self, func: Callable[[float], float], in_fmt: QFormat,
                 out_fmt: Optional[QFormat] = None):
        self.func = func
        self.in_fmt = in_fmt
        self.out_fmt = out_fmt or in_fmt
        w = in_fmt.width
        if w > MAX_TABLE_BITS:
            raise ValueError(
                f"LUT over a {w}-bit input needs 2^{w} entries; cap is "
                f"2^{MAX_TABLE_BITS}.  Use qapprox for wide formats.")
        n = 1 << max(w, 0)
        raws = []
        for p in range(n):
            raw_in = p - (1 << w) if (in_fmt.signed and w > 0
                                      and p >= (1 << (w - 1))) else p
            val = hostint.raw_to_double(raw_in, in_fmt)
            try:
                out_val = float(func(val))
            except (ValueError, ZeroDivisionError, OverflowError):
                out_val = math.nan
            raws.append(hostint.double_to_raw(out_val, self.out_fmt))
        self._raws = raws
        self._mask = (1 << w) - 1 if w > 0 else 0
        dt = dtype_for(self.out_fmt)
        self._device_table = None
        if dt is not None:
            self._np_table = np.array(raws, dtype=np.int32)

    def table_array(self):
        import jax.numpy as jnp

        if self._device_table is None:
            self._device_table = jnp.asarray(self._np_table)
        return self._device_table

    # value semantics: two tables with the same formats and entries are the
    # same ROM — lets compiled-program caches (parallel/sharding.py) hit
    # across separately-built instances instead of keying on identity
    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, QTable):
            return NotImplemented
        return (self.in_fmt == other.in_fmt and self.out_fmt == other.out_fmt
                and self._raws == other._raws)

    def __hash__(self):
        h = getattr(self, "_hash", None)
        if h is None:
            h = self._hash = hash((self.in_fmt, self.out_fmt,
                                   tuple(self._raws)))
        return h

    # Beyond this many entries the balanced select tree's trace gets large;
    # gather (O(1) trace) takes over.
    SELECT_TREE_MAX = 1 << 10

    def _select_tree(self, idx):
        """Balanced binary select tree over the table: a chain of jnp.where
        with constant leaves.  It fuses into the surrounding elementwise
        epilogue, where a small-table gather would be a separate kernel.

        When every entry fits one byte (or two), four (two) entries pack
        into each int32 leaf, quartering (halving) the select count: the
        tree walks ``idx >> 2`` over packed words, then a per-element
        variable shift + mask + sign-extend extracts the entry — ~66 integer
        ops per element for a 256-entry ROM instead of 255."""
        import jax.numpy as jnp

        raws = self._np_table
        n = len(raws)
        # pack by the ACTUAL entry range, not the declared width: a
        # WRP_TCPL_SAT output format's identity stub stores values beyond
        # its width (wrapped only at the machine word), so declared-width
        # packing would truncate them (round-2 review fix)
        vmin = int(raws.min()) if n else 0
        vmax = int(raws.max()) if n else 0

        def _fits(bits):
            return vmin >= -(1 << (bits - 1)) and vmax < (1 << (bits - 1))

        per = 4 if (_fits(8) and n % 4 == 0 and n >= 4) else \
            2 if (_fits(16) and n % 2 == 0 and n >= 2) else 1
        if per == 1:
            def build(lo, hi):
                if hi - lo == 1:
                    return jnp.int32(int(raws[lo]))
                mid = (lo + hi) // 2
                return jnp.where(idx < mid, build(lo, mid), build(mid, hi))

            return build(0, n)

        bits = 32 // per
        mask = (1 << bits) - 1
        words = []
        for i in range(n // per):
            v = 0
            for j in range(per):
                v |= (int(raws[per * i + j]) & mask) << (bits * j)
            words.append(v - (1 << 32) if v >= (1 << 31) else v)
        hi_idx = idx >> (per.bit_length() - 1)  # per=4 -> >>2, per=2 -> >>1

        def build(lo, hi):
            if hi - lo == 1:
                return jnp.int32(words[lo])
            mid = (lo + hi) // 2
            return jnp.where(hi_idx < mid, build(lo, mid), build(mid, hi))

        word = build(0, len(words))
        shift = (idx & jnp.int32(per - 1)) * jnp.int32(bits)
        v = (word >> shift) & jnp.int32(mask)
        sign = jnp.int32(1 << (bits - 1))
        return (v ^ sign) - sign  # sign-extend the extracted entry

    def __call__(self, x: QTensor) -> QTensor:
        # Full-format check: signedness (and int_bits) change how a bit
        # pattern is *interpreted* — signed (3,4) and unsigned (4,4) share
        # width 8 / frac 4 but fold the sign bit differently, so a table
        # built for one would silently misread the other's patterns.
        # Round/overflow modes don't affect interpretation, so they may vary.
        f = x.fmt
        t = self.in_fmt
        if (f.int_bits, f.frac_bits, f.signed) != (t.int_bits, t.frac_bits,
                                                   t.signed):
            raise ValueError(f"QTable built for {self.in_fmt}, got {x.fmt}")
        if x.is_host or dtype_for(self.out_fmt) is None:
            raws = [self._raws[int(r) & self._mask]
                    for r in np.asarray(x.raw(), dtype=object).reshape(-1)]
            return from_raw(np.array(raws, dtype=object).reshape(x.shape),
                            self.out_fmt)
        import jax.numpy as jnp

        idx = x.data.astype(jnp.int32) & jnp.int32(self._mask)
        if len(self._raws) <= self.SELECT_TREE_MAX:
            # backend-agnostic: fuses into epilogues and traces fine under
            # shard_map, where gather/take is unsupported
            raw = self._select_tree(idx)
        else:
            raw = jnp.take(self.table_array(), idx, axis=0)
        return QTensor(raw.astype(dtype_for(self.out_fmt)), self.out_fmt)


def build_table(func, in_fmt: QFormat, out_fmt: Optional[QFormat] = None) -> QTable:
    return QTable(func, in_fmt, out_fmt)


def qtable(x: QTensor, func, out_fmt: Optional[QFormat] = None) -> QTensor:
    """One-shot LUT application (reference ``ANUS::Qtable<func>(q)``,
    readme.md:66-78).  For repeated use build a :class:`QTable` once."""
    return QTable(func, x.fmt, out_fmt)(x)
