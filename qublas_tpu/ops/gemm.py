"""Quantized GEMM / GEMV (Qgemul / Qgemv) — the centerpiece op.

The reference documents this API in its readme only (``readme.md:80-87``,
absent from the header at this snapshot — see SURVEY.md §0/§2.14): each
scalar product is quantized per ``QgemulMulArgs``, each dot product
accumulates through the Qreduce *vector-path* tree with per-layer
``QgemulAddArgs`` formats, and the result requantizes into C's element type
(a converting assignment).  The semantic oracle is
:func:`qublas_tpu.hostops.qgemul`.

Device design — two strategies chosen by a static exactness proof (trace
time, free at runtime):

* **Integer-matmul fast path.**  If every step of the product-quantize + tree-accumulate
  pipeline is provably lossless (no rounding: fractional precision never
  drops; no saturation: exact interval arithmetic keeps every intermediate
  inside its format's identity range), then *any* association order yields
  identical bits, so the whole dot collapses to an integer
  ``lax.dot_general`` with int32 accumulation plus ONE fused
  shift-round-saturate epilogue (``requantize_i32``).  This covers the
  headline INT8 config (BASELINE.json config 1) and every FullPrec-style
  config — the ones that matter for throughput.

* **General tree path.**  When intermediate layers round or saturate, the
  result is association-order-sensitive; we replicate the exact balanced-tree
  pairing incl. the odd-tail converting assignment (QuBLAS.h:4977-4980) as a
  log-depth vectorized program: quantized outer products ``[..., m, k, n]``
  reduced over ``k`` by :func:`qublas_tpu.ops.reduce.qreduce`.  Wide
  (pair/limb) configs at scale use :func:`_stream_gemm_wide` instead — the
  same tree as a binary-carry stream of k-chunks, peak memory
  ``[.., m, chunk, n]``, which admits shapes whose full product tensor
  cannot fit device memory.

Formats too wide for device lanes fall back to the exact host golden model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import hostops
from ..qformat import OverflowMode, QFormat, add_merge, mul_merge
from ..qtensor import QTensor, from_raw
from . import elementwise as ew
from . import wideint as W
from .reduce import layer_format, qreduce
from .widths import Interval, dtype_for, fmt_interval, route_requant

__all__ = ["qgemul", "qgemv", "exact_plan", "ExactPlan"]


# ---------------------------------------------------------------------------
# Benchmark/testing dispatch overrides (supported API — replaces ad-hoc
# module monkeypatching of the tier functions, ADVICE r3 item 2: an A/B
# arm enters a context; any retrace inside it sees a consistent dispatch)
# ---------------------------------------------------------------------------

from contextlib import contextmanager

_TIERS_OFF: frozenset = frozenset()   # subset of {"wide", "limb"}
_STREAM_GATE_OVERRIDE: Optional[int] = None


@contextmanager
def force_tiers_off(*tiers: str):
    """Disable named fast-dispatch tiers ("limb": balanced-digit int8 dot;
    "wide": pair-domain dot) within the context.  Trace-time static."""
    global _TIERS_OFF
    saved = _TIERS_OFF
    _TIERS_OFF = saved | frozenset(tiers)
    try:
        yield
    finally:
        _TIERS_OFF = saved


@contextmanager
def stream_gate(min_elems: int):
    """Override the streaming-path admission gate (``_STREAM_MIN_ELEMS``)
    within the context — e.g. 0 forces small GEMMs onto the stream."""
    global _STREAM_GATE_OVERRIDE
    saved = _STREAM_GATE_OVERRIDE
    _STREAM_GATE_OVERRIDE = min_elems
    try:
        yield
    finally:
        _STREAM_GATE_OVERRIDE = saved


# ---------------------------------------------------------------------------
# Exactness proof
# ---------------------------------------------------------------------------

def _identity_range(fmt: QFormat):
    """Raw interval on which ``int_convert`` + the store are the identity.

    WRP_TCPL_SAT is the reference's identity STUB (QuBLAS.h:2336-2344),
    but the subsequent store wraps at the MACHINE WORD (int32 / int64 /
    64-aligned multiword — hostint.int_convert, verified by probe), so
    its identity range is the signed word interval, not unbounded: a
    product whose upshifted value exceeds the word wraps per element, and
    an integer dot of the unwrapped values would diverge from the oracle
    (caught by differential fuzz)."""
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        w = fmt.storage_bits
        word = 32 if w <= 32 else 64 if w <= 64 else 64 * ((w + 63) // 64)
        return -(1 << (word - 1)), (1 << (word - 1)) - 1
    hi = fmt.raw_max
    if not fmt.signed:
        lo = 0
    elif fmt.overflow_mode == OverflowMode.SAT_SMGN:
        lo = fmt.raw_min + 1
    else:
        lo = fmt.raw_min
    return lo, hi


def _lossless_requant(iv: Interval, from_frac: int, fmt: QFormat):
    """Interval after a provably-lossless requantize into ``fmt``; None if
    the requantize can round (frac drops) or saturate/wrap (leaves the
    identity range)."""
    d = fmt.frac_bits - from_frac
    if d < 0:
        return None  # precision drops -> rounding may occur
    out = iv << d
    rng = _identity_range(fmt)
    if rng is not None and not (out.lo >= rng[0] and out.hi <= rng[1]):
        return None
    return out


@dataclass(frozen=True)
class ExactPlan:
    """Proof artifact: the dot is lossless, so int32 accumulation at the
    product's fractional scale + one epilogue reproduces the tree bit-exactly."""

    prod_frac: int        # fa.frac + fb.frac — scale of the raw dot product
    final_fmt: QFormat    # format of the tree's final value
    dot_interval: Interval  # bound on every partial sum of raw products
    prod_interval: Interval  # bound on one raw product (consumers: the
    #                          pair-domain dot's segment-length proof)


def tree_exact(value_iv: Interval, value_fmt: QFormat, add_formats,
               k: int) -> Optional[QFormat]:
    """Prove the tree accumulation of k per-product values lossless.

    Walks the exact layer structure of the vector-path reducer
    (QuBLAS.h:4960-4990) with interval arithmetic: every layer add (incl.
    odd-tail pass-through conversions) must neither round nor saturate.
    Returns the tree's final format, or None.
    """
    iv, cur_fmt, cur_frac = value_iv, value_fmt, value_fmt.frac_bits
    n, layer = k, 0
    while n > 1:
        lf = layer_format(add_formats, layer)
        if lf is None:
            lf = add_merge(cur_fmt, cur_fmt)
        pair = _lossless_requant(iv + iv, cur_frac, lf)
        if pair is None:
            return None
        if n % 2:
            tail = _lossless_requant(iv, cur_frac, lf)
            if tail is None:
                return None
            iv = Interval(min(pair.lo, tail.lo), max(pair.hi, tail.hi))
        else:
            iv = pair
        cur_fmt, cur_frac = lf, lf.frac_bits
        n = (n + 1) // 2
        layer += 1
    return cur_fmt


def dot_partial_interval(prod_iv: Interval, k: int) -> Interval:
    """Bound on every partial sum of j in 1..k products, each in prod_iv."""
    lo, hi = prod_iv.lo, prod_iv.hi
    return Interval(min(k * lo, lo), max(k * hi, hi))


def exact_plan(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
               k: int) -> Optional[ExactPlan]:
    """Prove the product-quantize + tree-accumulate pipeline lossless.

    When every step provably neither rounds nor saturates, integer addition
    is associative and ``lax.dot_general`` int32 accumulation is
    bit-identical to the tree.
    """
    pf = fa.frac_bits + fb.frac_bits
    prod_iv = fmt_interval(fa) * fmt_interval(fb)
    iv = _lossless_requant(prod_iv, pf, mul_fmt)
    if iv is None:
        return None
    final_fmt = tree_exact(iv, mul_fmt, add_formats, k)
    if final_fmt is None:
        return None
    return ExactPlan(pf, final_fmt, dot_partial_interval(prod_iv, k),
                     prod_iv)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
           add_formats=(), transpose_a: bool = False,
           transpose_b: bool = False, mul_full_prec: bool = False,
           use_pallas: Optional[bool] = None,
           epilogue_lut=None) -> QTensor:
    """C = op(A) @ op(B) with per-product and per-layer quantization.

    Readme-parity API (``readme.md:80-87``): ``mul_to`` ~ QgemulMulArgs,
    ``add_formats`` ~ QgemulAddArgs TypeList, ``transpose_a/b`` ~
    QgemulTransposedA/B.  Leading batch dimensions broadcast (an extension —
    the reference has no batching).  ``use_pallas=False`` keeps the
    order-sensitive tree off the hand-written GPU kernel
    (:func:`~.tree_gemm.tree_gemm_tiled`) and on the portable scan; the
    default allows the kernel whenever the default backend is the GPU.

    ``epilogue_lut`` fuses an ANUS ROM lookup into the GEMM epilogue
    (BASELINE.json config 4): a :class:`~qublas_tpu.anus.QTable` built for
    ``out_fmt`` maps every output element after the converting assignment —
    bit-identical to ``table(qgemul(...))``, with the gather fused by XLA
    into the epilogue on device.
    """
    if isinstance(out_fmt, QTensor):
        # readme-style call shape `Qgemul(C, A, B)`: C supplies the output
        # element type (we return a new tensor — jax arrays are immutable)
        out_fmt = out_fmt.fmt
    if epilogue_lut is not None:
        c = qgemul(a, b, out_fmt, mul_to, add_formats, transpose_a,
                   transpose_b, mul_full_prec, use_pallas)
        return epilogue_lut(c)
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    add_formats = tuple(add_formats)
    a = _transpose(a, transpose_a)
    b = _transpose(b, transpose_b)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    k = a.shape[-1]
    mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)

    if a.is_host or b.is_host:
        return _host_gemm(a, b, out_fmt, mul_to, add_formats, mul_full_prec)

    plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats, k)
    if plan is not None and _device_epilogue_ok(plan, out_fmt):
        return _fast_gemm(a, b, out_fmt, plan)
    if plan is not None:
        # proof-lossless but the dot outgrows int32.  Try the balanced-digit
        # int8 dot FIRST: its digit matmuls are int8 matmuls whatever the
        # operand width, while the pair-domain dot's segment dots shrink
        # with it.  Both are bit-exact by the losslessness proof, so the
        # order is purely a performance choice.
        res = None if "limb" in _TIERS_OFF else \
            _fast_gemm_limb(a, b, out_fmt, plan)
        if res is not None:
            return res
        # pair-domain fallback for configs outside the digit-dot envelope
        # (oversized digit grids / dot tensors, host-route epilogues)
        res = None if "wide" in _TIERS_OFF else \
            _fast_gemm_wide(a, b, out_fmt, plan)
        if res is not None:
            return res

    # general path: order-sensitive quantized accumulation.  Prefer the
    # streaming binary-carry evaluation (no [m, k, n] intermediate); on the
    # GPU the tiled kernel keeps each output tile's slot stack in registers.
    from . import tree_gemm

    if not (a.is_pair or b.is_pair or a.is_limb or b.is_limb):
        # prefix-lossless hybrid: when the product quantize and the first
        # L >= 3 tree layers are provably exact, 2^L-element partial dots
        # run as block integer matmuls and only the lossy tail folds
        # elementwise — bit-identical to the full tree by the proof
        hplan = tree_gemm.plan_hybrid(a.fmt, b.fmt, mul_fmt, add_formats,
                                      k, out_fmt)
        if hplan is not None:
            raw = tree_gemm.tree_gemm_hybrid(a.data, b.data, hplan, out_fmt)
            return QTensor(raw, out_fmt)

    tplan = None
    if not (a.is_pair or b.is_pair
            or a.is_limb or b.is_limb):  # tree kernels assume lane storage
        tplan = tree_gemm.plan_tree(a.fmt, b.fmt, mul_fmt, add_formats, k,
                                    out_fmt)
    if tplan is not None:
        import jax

        m, n = a.shape[-2], b.shape[-1]
        tiled = jax.default_backend() == "gpu" and use_pallas is not False
        if tiled and a.ndim == 2 and b.ndim == 2:
            raw = tree_gemm.tree_gemm_tiled(a.data, b.data, tplan, out_fmt)
        elif tiled and a.ndim == b.ndim and a.ndim > 2 \
                and a.shape[:-2] == b.shape[:-2]:
            # batched: flatten leading dims and vmap the kernel (Pallas lifts
            # the batch into an extra grid dimension)
            batch = a.shape[:-2]
            ad = a.data.reshape((-1,) + a.shape[-2:])
            bd = b.data.reshape((-1,) + b.shape[-2:])
            raw = jax.vmap(lambda x, y: tree_gemm.tree_gemm_tiled(
                x, y, tplan, out_fmt))(ad, bd)
            raw = raw.reshape(batch + (m, n))
        else:
            raw = tree_gemm.tree_gemm_scan(a.data, b.data, tplan, out_fmt)
        return QTensor(raw, out_fmt)

    # streaming wide path: binary-carry over k-chunks at the QTensor level
    # (pair/limb values) — peak memory [.., m, chunk, n] instead of the
    # layered [.., m, k, n], which enables large wide GEMMs that cannot
    # materialize the full product tensor in device memory
    res = _stream_gemm_wide(a, b, out_fmt, mul_to, add_formats,
                            mul_full_prec)
    if res is not None:
        return res

    # layered fallback: materialized quantized products + explicit tree
    prod = ew.qmul(QTensor(a.data[..., :, :, None], a.fmt),
                   QTensor(b.data[..., None, :, :], b.fmt),
                   to=mul_to, full_prec=mul_full_prec)
    if prod.is_host:
        return _host_gemm(a, b, out_fmt, mul_to, add_formats, mul_full_prec)
    acc = qreduce(prod, add_formats, axis=-2)
    return ew.qcast(acc, out_fmt)


# ---------------------------------------------------------------------------
# Wide fast path: exact 64-bit pair dots (proof-lossless, dot > int32)
# ---------------------------------------------------------------------------

_PAIR_SEG_MIN = 8        # matmul segment path only if >= this many products
#                          accumulate exactly in one int32 segment dot
_PAIR_CHUNK = 64         # elementwise path: products materialize [m, chunk, n]


def pair_axis_sum(ph, pl, axis: int):
    """Log-depth exact pair summation over ``axis`` (zero-padded to even at
    each level — the caller's losslessness proof makes any order exact)."""
    import jax.numpy as jnp

    while ph.shape[axis] > 1:
        if ph.shape[axis] % 2:
            pad = [(0, 0)] * ph.ndim
            pad[axis] = (0, 1)
            ph, pl = jnp.pad(ph, pad), jnp.pad(pl, pad)

        def take(x, s):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(s, None, 2)
            return x[tuple(idx)]

        ph, pl = W.pair_add((take(ph, 0), take(pl, 0)),
                            (take(ph, 1), take(pl, 1)))
    idx = [slice(None)] * ph.ndim
    idx[axis] = 0
    return ph[tuple(idx)], pl[tuple(idx)]


def pair_dot_2d(ad, bd, prod_iv: Interval):
    """Exact [m, n] (hi, lo) pair dot of ``[m, k] @ [k, n]``.

    Matmul path: when every product fits an int32 lane, split K into
    segments short enough that each segment's dot provably fits int32, run
    them as one batched integer matmul, and fold the per-segment dots with
    exact pair adds — a >32-bit integer dot from 32-bit accumulators.  Otherwise (pair operands / >32-bit products) the
    products compute directly in the 64-bit pair domain, chunked so only
    ``[m, chunk, n]`` materializes.  Valid only under a losslessness proof
    (any association order yields identical bits); callers prove the dot
    and every partial fit the signed 64-bit pair domain.
    """
    import jax.numpy as jnp

    from .widths import I32_MAX

    a_pair = isinstance(ad, W.PairArray)
    b_pair = isinstance(bd, W.PairArray)
    k_loc = ad.shape[-1]
    if not a_pair and not b_pair and prod_iv.fits32:
        mx = max(abs(prod_iv.lo), abs(prod_iv.hi))
        # clamp to k: a small product interval would otherwise zero-pad
        # the operands out to ~I32_MAX // mx elements (multi-GB arrays of
        # zeros for narrow formats — round-3 review finding)
        seg = k_loc if mx == 0 else max(min(I32_MAX // mx, k_loc), 1)
        if seg >= _PAIR_SEG_MIN:
            a32 = ad.astype(jnp.int32)
            b32 = bd.astype(jnp.int32)
            nseg = -(-k_loc // seg)
            pad = nseg * seg - k_loc
            if pad:
                a32 = jnp.pad(a32, ((0, 0), (0, pad)))
                b32 = jnp.pad(b32, ((0, pad), (0, 0)))
            m, n = a32.shape[0], b32.shape[1]
            dots = jnp.einsum(
                "msl,sln->smn",
                a32.reshape(m, nseg, seg), b32.reshape(nseg, seg, n),
                preferred_element_type=jnp.int32)     # [nseg, m, n]
            hi, lo = W.widen(dots)
            return pair_axis_sum(hi, lo, 0)

    def col(sl):
        if a_pair:
            return ad.hi[:, sl, None], ad.lo[:, sl, None]
        return ad[:, sl, None].astype(jnp.int32), None   # lane marker

    def row(sl):
        if b_pair:
            return bd.hi[sl, :], bd.lo[sl, :]
        return bd[sl, :].astype(jnp.int32), None

    acc = None
    for t in range(0, k_loc, _PAIR_CHUNK):
        sl = slice(t, min(t + _PAIR_CHUNK, k_loc))
        ch, cl = col(sl)
        rh, rl = row(sl)
        if cl is None and rl is None:
            ph, pl = W.mul32_wide(ch, rh)             # [m, c, n]
        else:
            cp = (ch, cl) if cl is not None else W.widen(ch)
            rp = (rh, rl) if rl is not None else W.widen(rh)
            ph, pl = W.pair_mul(cp, rp)
        sh, sv = pair_axis_sum(ph, pl, -2)            # [m, n]
        acc = (sh, sv) if acc is None else W.pair_add(acc, (sh, sv))
    return acc


def wide_dot_ok(a: QTensor, b: QTensor, out_fmt: QFormat,
                plan: ExactPlan) -> bool:
    """Shared admission gate for the pair-domain wide dot — the single
    source for both the single-chip fast path and the sharded ``k_wide``
    strategy (they must never de-synchronize): 2-D lane/pair operands,
    the dot (and by inclusion every partial and product) in the signed
    64-bit domain, and an epilogue that runs there too."""
    from .widths import route_requant, storage_kind

    if a.ndim != 2 or b.ndim != 2:
        return False
    if a.is_limb or b.is_limb or a.is_host or b.is_host:
        return False
    if not plan.dot_interval.fits64:
        return False
    if storage_kind(out_fmt) not in ("lane", "pair"):
        return False
    return route_requant(plan.dot_interval, plan.prod_frac, out_fmt) \
        in ("i32", "pair")


def pair_sum_1d(data, val_iv: Interval):
    """Exact (hi, lo) pair sum of a 1-D vector of lane or pair values.

    Same regime as :func:`pair_dot_2d`: valid only under a losslessness
    proof, with the total (and by subset-sum every partial) bounded to the
    signed 64-bit domain.  Lane values whose interval fits int32 sum in
    int32 segments first (one vectorized reduction per segment), then the
    per-segment sums fold with exact pair adds.
    """
    import jax.numpy as jnp

    from .widths import I32_MAX

    if isinstance(data, W.PairArray):
        return pair_axis_sum(data.hi, data.lo, 0)
    d32 = data.astype(jnp.int32)
    n_loc = d32.shape[0]
    if val_iv.fits32 and n_loc:
        mx = max(abs(val_iv.lo), abs(val_iv.hi))
        seg = n_loc if mx == 0 else max(min(I32_MAX // mx, n_loc), 1)
        if seg >= _PAIR_SEG_MIN:
            nseg = -(-n_loc // seg)
            pad = nseg * seg - n_loc
            if pad:
                d32 = jnp.pad(d32, (0, pad))
            sums = jnp.sum(d32.reshape(nseg, seg), axis=1)
            hi, lo = W.widen(sums)
            return pair_axis_sum(hi, lo, 0)
    hi, lo = W.widen(d32)
    return pair_axis_sum(hi, lo, 0)


# ---------------------------------------------------------------------------
# Limb fast path: exact wide dots beyond 64 bits (balanced-digit int8 matmul)
# ---------------------------------------------------------------------------

# admission caps for the digit-decomposition dot (static, from formats and
# shapes): the number of int8 digit-pair matmuls inside the fused
# dot_general, and the materialized [da, db, nseg, m, n] int32 dot tensor
_LIMBDOT_MAX_MATMULS = 2500          # 384-bit x 384-bit operands = 49*49
_LIMBDOT_MAX_DOT_ELEMS = 1 << 28     # 1 GiB of int32 digit dots


def limb_dot_plan(a_fmt: QFormat, b_fmt: QFormat, out_fmt: QFormat,
                  plan: ExactPlan, k: int, m: int, n: int):
    """Working limb count for the digit-domain wide dot, or None when the
    config is outside its envelope.  Single source for the single-chip fast
    path and the sharded ``k_limb`` strategy (mirrors :func:`wide_dot_ok` /
    ``_k_wide_plan`` for the pair regime)."""
    from . import limbdot as D
    from .limbint import bits_to_limbs
    from .widths import (LIMB_INTER_MAX_BITS, requant_work_bits,
                         route_requant, storage_kind)

    if storage_kind(out_fmt) is None:
        return None
    iva, ivb = fmt_interval(a_fmt), fmt_interval(b_fmt)
    if D.digit_matmuls(iva, ivb) > _LIMBDOT_MAX_MATMULS:
        return None
    da, db = D.digits_needed(iva), D.digits_needed(ivb)
    nseg = -(-k // D._seg_len(k, min(da, db)))
    if da * db * nseg * m * n > _LIMBDOT_MAX_DOT_ELEMS:
        return None
    if route_requant(plan.dot_interval, plan.prod_frac, out_fmt) == "host":
        return None
    need = max(D.work_bits(iva, ivb, k),
               requant_work_bits(plan.dot_interval, plan.prod_frac,
                                 out_fmt))
    if need > LIMB_INTER_MAX_BITS:
        return None
    return bits_to_limbs(need)


def _fast_gemm_limb(a: QTensor, b: QTensor, out_fmt: QFormat,
                    plan: ExactPlan) -> Optional[QTensor]:
    """Proof-lossless dots beyond the 64-bit pair domain: balanced-digit
    int8 matmul + exact stacked-limb recombination + ONE limb
    requantize from the raw-product scale (:mod:`.limbdot`).  Bit-exact by
    the same argument as :func:`_fast_gemm`: the losslessness proof makes
    every association and distribution order produce identical bits.
    Covers wide pair operands (e.g. 40x40-bit GEMMs, 80-bit products),
    limb-storage operands, and limb-storage outputs — configs that
    previously ran the order-preserving stream.  Returns None outside the
    envelope (caller falls through)."""
    from . import limbdot as D
    from . import limbint as L
    from .widths import storage_kind

    if a.ndim != 2 or b.ndim != 2 or a.is_host or b.is_host:
        return None
    Kw = limb_dot_plan(a.fmt, b.fmt, out_fmt, plan, a.shape[-1],
                       a.shape[-2], b.shape[-1])
    if Kw is None:
        return None
    acc = D.limb_dot_2d(a.data, b.data, fmt_interval(a.fmt),
                        fmt_interval(b.fmt), Kw)
    raw = L.requantize_limb(acc, plan.prod_frac, out_fmt)
    kind = storage_kind(out_fmt)
    if kind == "lane":
        return QTensor(raw.astype(dtype_for(out_fmt)), out_fmt)
    if kind == "pair":
        return QTensor(W.PairArray(raw[0], raw[1]), out_fmt)
    return QTensor(L.LimbArray(raw), out_fmt)


def _fast_gemm_wide(a: QTensor, b: QTensor, out_fmt: QFormat,
                    plan: ExactPlan) -> Optional[QTensor]:
    """Single-chip analogue of the sharded wide-K strategy: when the
    accumulation is proof-lossless but the dot outgrows int32 (so the
    int32 fast path refused), compute the exact dot in the 64-bit pair
    domain — segment matmuls for lane operands, chunked pair products
    otherwise — and requantize once from the raw-product scale.  Bit-exact
    by the same argument as :func:`_fast_gemm`; replaces the slower
    order-preserving streaming tree for these configs.  Returns None when
    the config is outside the pair regime (caller falls through).
    """
    from .widths import storage_kind

    if not wide_dot_ok(a, b, out_fmt, plan):
        return None
    kind = storage_kind(out_fmt)
    hi, lo = pair_dot_2d(a.data, b.data, plan.prod_interval)
    if kind == "lane":
        raw = W.requantize_pair((hi, lo), plan.prod_frac, out_fmt)
        return QTensor(raw.astype(dtype_for(out_fmt)), out_fmt)
    h2, l2 = W.requantize_pair_keep((hi, lo), plan.prod_frac, out_fmt)
    return QTensor(W.PairArray(h2, l2), out_fmt)


# ---------------------------------------------------------------------------
# Streaming wide GEMM (binary-carry over k-chunks, QTensor values)
# ---------------------------------------------------------------------------

# stream only when the layered [.., m, k, n] materialization would be large
# enough to matter (device-memory pressure / log-k full-tensor passes); small eager
# cases stay layered (fewer dispatches).  Tests lower this to force the path.
_STREAM_MIN_ELEMS = 1 << 22
_STREAM_CHUNK = 64
# trace-size bound: each chunk unrolls its subtree into the program; past
# this many chunks (k > 64Ki with chunk 64) the layered path takes over
_STREAM_MAX_CHUNKS = 1024


def _stream_gemm_wide(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to,
                      add_formats, mul_full_prec) -> Optional[QTensor]:
    """Evaluate the order-sensitive tree GEMM as a stream of k-chunks.

    Same binary-counter schedule as :mod:`.tree_gemm` (each merge combines
    two adjacent complete subtrees, so the add sequence is exactly the
    reference's balanced-tree pairing, QuBLAS.h:4960-4990), but the values
    are whole :class:`QTensor`\\ s — the elementwise ops route each merge to
    the right storage (lane / 64-bit pair / N-limb), so this is the
    production path for wide formats.  Each chunk's products materialize at
    ``[.., m, chunk, n]`` and fold through the chunk's complete subtree via
    :func:`qreduce` (layers ``0..log2(chunk)-1``); chunk results then merge
    at layers ``log2(chunk)+j`` with the same ``TypeAt`` layer formats.

    Any k is admitted (matching the reference's scalar tree, odd tails at
    QuBLAS.h:4977-4980): ``nfull = k // chunk`` complete power-of-two
    subtrees stream through the binary counter, and the remaining
    ``r = k % chunk`` products form one *ragged tail subtree*.  The tail
    region starts at a multiple of ``chunk``, so at every tree layer below
    the chunk level its pairing is self-contained (its layer-l start index
    ``nfull * 2^(L-l)`` is even) and its value count carries the global
    layer's parity — :func:`qreduce`'s odd-tail rules therefore reproduce
    the global tree's behavior inside the tail, and once the tail is a
    single value it converts at each remaining layer up to the chunk level
    (globally unpaired: the complete chunks contribute an even count below
    level L).  The tail value then enters the binary-carry stream as chunk
    value ``nfull``.

    Returns None when streaming is not applicable/profitable (k < 16, a
    single chunk covers k, or the product tensor is small enough that the
    layered path is cheaper to dispatch).
    """
    from .tree_gemm import drain_ops

    k = a.shape[-1]
    # largest power-of-two chunk with at least two full chunks, capped
    chunk = min(1 << (max(k // 2, 1).bit_length() - 1), _STREAM_CHUNK)
    nfull = k // chunk
    r = k % chunk
    nchunks = nfull + (1 if r else 0)
    m = a.shape[-2]
    n = b.shape[-1]
    batch = 1
    for d in np.broadcast_shapes(a.shape[:-2], b.shape[:-2]):
        batch *= d
    gate = _STREAM_MIN_ELEMS if _STREAM_GATE_OVERRIDE is None \
        else _STREAM_GATE_OVERRIDE
    if chunk < 8 or nfull < 2 or nchunks > _STREAM_MAX_CHUNKS \
            or batch * m * k * n < gate:
        return None
    in_levels = chunk.bit_length() - 1

    def products(t):
        lo = t * chunk
        hi = min(lo + chunk, k)
        ca = QTensor(a.data[..., :, lo:hi, None], a.fmt)
        rb = QTensor(b.data[..., None, lo:hi, :], b.fmt)
        return ew.qmul(ca, rb, to=mul_to, full_prec=mul_full_prec)

    def merge_fmt(carry_fmt: QFormat, j: int):
        lf = layer_format(add_formats, in_levels + j)
        return lf if lf is not None else add_merge(carry_fmt, carry_fmt)

    def layer_fmt_at(cur_fmt: QFormat, l: int):
        lf = layer_format(add_formats, l)
        return lf if lf is not None else add_merge(cur_fmt, cur_fmt)

    slots = {}

    def push(t, v):
        j = 0
        while t & (1 << j):
            left = slots.pop(j)
            v = ew.qadd(left, v, to=layer_format(add_formats, in_levels + j))
            j += 1
        slots[j] = v

    for t in range(nchunks):
        prod = products(t)
        if prod.is_host:
            return _host_gemm(a, b, out_fmt, mul_to, add_formats,
                              mul_full_prec)
        v = qreduce(prod, add_formats, axis=-2)   # (sub)tree of this chunk
        if t == nfull:  # ragged tail: r products folded through
            # layers 0..ceil(log2 r)-1; globally unpaired from there to the
            # chunk level, so it converts at each remaining layer
            applied = max(r - 1, 0).bit_length()
            for l in range(applied, in_levels):
                v = ew.qcast(v, layer_fmt_at(v.fmt, l))
        push(t, v)

    carry = None
    for op, l in drain_ops(nchunks, max(nchunks.bit_length(), 1)):
        if op == "seed":
            carry = slots[l]
        elif op == "convert":
            carry = ew.qcast(carry, merge_fmt(carry.fmt, l))
        else:  # add: slot l is the earlier (left) subtree
            carry = ew.qadd(slots[l], carry,
                            to=layer_format(add_formats, in_levels + l))
    return ew.qcast(carry, out_fmt)


def qgemv(a: QTensor, x: QTensor, out_fmt: QFormat, mul_to=None,
          add_formats=(), transpose_a: bool = False,
          mul_full_prec: bool = False) -> QTensor:
    """y = op(A) @ x — matrix-vector case (BASELINE.json north star names
    Qgemv alongside Qgemul)."""
    col = QTensor(x.data[..., :, None], x.fmt)
    y = qgemul(a, col, out_fmt, mul_to, add_formats,
               transpose_a=transpose_a, mul_full_prec=mul_full_prec)
    return QTensor(y.data[..., 0], y.fmt)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

def _transpose(t: QTensor, flag: bool) -> QTensor:
    if not flag:
        return t
    if t.ndim < 2:
        raise ValueError("transpose flag needs a >=2-D operand")
    return QTensor(np.swapaxes(t.data, -1, -2) if t.is_host
                   else t.data.swapaxes(-1, -2), t.fmt)


def _device_epilogue_ok(plan: ExactPlan, out_fmt: QFormat) -> bool:
    if dtype_for(out_fmt) is None:
        return False
    if not plan.dot_interval.fits32:
        return False
    return route_requant(plan.dot_interval, plan.prod_frac, out_fmt) == "i32"


def _fast_gemm(a: QTensor, b: QTensor, out_fmt: QFormat,
               plan: ExactPlan) -> QTensor:
    """Lossless-accumulation path: one integer matmul with int32
    accumulation + one requantize epilogue that XLA fuses after it.
    Bit-exact by :func:`exact_plan`'s proof."""
    import jax.numpy as jnp

    x, y = a.data, b.data
    if x.dtype != jnp.int8 or y.dtype != jnp.int8:
        # accumulate exactly in int32 either way (proof holds); keep the
        # OPERANDS in the narrowest common lane
        narrow = jnp.int16 if all(
            d in (jnp.int8, jnp.int16) for d in (x.dtype, y.dtype)) \
            else jnp.int32
        x = x.astype(narrow)
        y = y.astype(narrow)
    dot = jnp.matmul(x, y, preferred_element_type=jnp.int32)
    raw = W.requantize_i32(dot, plan.prod_frac, out_fmt)
    return QTensor(raw.astype(dtype_for(out_fmt)), out_fmt)


def _host_gemm(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to, add_formats,
               mul_full_prec) -> QTensor:
    """Exact host golden model, batched over leading dims.  2-D cases go
    through the native C++ engine when formats fit its 64-bit envelope."""
    if a.ndim == 2 and b.ndim == 2:
        from .. import native

        mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
        got = native.tree_gemm_host(a.raw(), b.raw(), a.fmt, b.fmt, mul_fmt,
                                    tuple(add_formats), out_fmt)
        if got is not None:
            return from_raw(got, out_fmt)
    A = np.asarray(a.raw(), dtype=object)
    B = np.asarray(b.raw(), dtype=object)
    batch = np.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = np.broadcast_to(A, batch + A.shape[-2:])
    B = np.broadcast_to(B, batch + B.shape[-2:])
    m, k = A.shape[-2:]
    _, n = B.shape[-2:]
    out = np.empty(batch + (m, n), dtype=object)
    for idx in np.ndindex(*batch) if batch else [()]:
        a_rows = [[(int(A[idx + (i, p)]), a.fmt) for p in range(k)]
                  for i in range(m)]
        b_rows = [[(int(B[idx + (p, j)]), b.fmt) for j in range(n)]
                  for p in range(k)]
        c = hostops.qgemul(a_rows, b_rows, out_fmt, mul_to, add_formats,
                           mul_full_prec=mul_full_prec)
        for i in range(m):
            for j in range(n):
                out[idx + (i, j)] = c[i][j][0]
    return from_raw(out, out_fmt)
