"""Complex quantized GEMM (TFComplexMul / BasicComplexMul per product).

BASELINE.json config 5 names "Qcomplex TFComplexMul complex GEMM"; the
reference itself has no GEMM at all (SURVEY.md §2.14), so the semantics
compose the two capabilities it *does* define exactly as the real GEMM
does:

* each scalar product A[i,p] * B[p,j] is a complex multiply — Basic
  4-mul/2-add (QuBLAS.h:3376-3446) or TF 3-mul/5-add (:3448-3535) — with the
  same per-step quantization tags (incl. the tag-default quirks);
* each dot product accumulates through the vector-path tree per part.
  Per-layer formats are (real_fmt, imag_fmt) pairs — a single QFormat
  applies to both parts.  (In the reference a complex ``Qadd<t>`` with a
  single bare format is uninstantiable, REFERENCE_DEFECTS.md D6; pairs map
  to its ``TypeList<Qu1, Qu2>`` → realT/imagT form, QuBLAS.h:3564-3567.)
* the result requantizes into C's per-part element formats (converting
  assignment).
"""

from __future__ import annotations

from typing import Optional

from ..qformat import QFormat, add_merge, mul_merge
from ..qtensor import QTensor
from . import elementwise as ew
from . import wideint as W
from .gemm import _lossless_requant, dot_partial_interval, tree_exact
from .reduce import qreduce
from .widths import Interval, dtype_for, fmt_interval, route_requant

__all__ = ["cgemul", "cgemv"]

# supported benchmark/testing override (ADVICE r3 item 2: replaces bench's
# module monkeypatch of _fast_cgemul with an explicit context)
_FAST_OFF = False


from contextlib import contextmanager


@contextmanager
def force_fast_off():
    """Context manager disabling the complex fast path (both domains) so
    A/B arms can time the layered order-preserving path."""
    global _FAST_OFF
    saved = _FAST_OFF
    _FAST_OFF = True
    try:
        yield
    finally:
        _FAST_OFF = saved


# ---------------------------------------------------------------------------
# Integer-matmul fast path: when every per-product step and both accumulation trees are
# provably lossless, the complex GEMM collapses to 4 (basic) or 3 (TF)
# integer matmuls plus exact shift/combine epilogues.
# ---------------------------------------------------------------------------

class _Step:
    """Lossless symbolic value: interval + format + proof flag."""

    def __init__(self, iv: Interval, fmt: QFormat):
        self.iv = iv
        self.fmt = fmt


def _s_mul(x: _Step, y: _Step, to) -> Optional[_Step]:
    out = mul_merge(x.fmt, y.fmt, to)
    iv = _lossless_requant(x.iv * y.iv, x.fmt.frac_bits + y.fmt.frac_bits,
                           out)
    return None if iv is None else _Step(iv, out)


def _s_addsub(x: _Step, y: _Step, to, sub: bool) -> Optional[_Step]:
    out = add_merge(x.fmt, y.fmt, to)
    f = max(x.fmt.frac_bits, y.fmt.frac_bits)
    xv = x.iv << (f - x.fmt.frac_bits)
    yv = y.iv << (f - y.fmt.frac_bits)
    iv = _lossless_requant(xv - yv if sub else xv + yv, f, out)
    return None if iv is None else _Step(iv, out)


def _single_default(*specs):
    """Delegates to the oracle's tag-quirk rule (single source)."""
    from .. import hostops

    return hostops.single_tag_default(*specs)


def _tf_int8_distributed(a, b, k, fal1, fal2, w1, w2, w3, fin_r, fin_i,
                         fA, fB, fC):
    """Lower TF's three matmuls to the FOUR elementary int8 matmuls.

    TF's multiplies take 9-bit operand SUMS (a_r+a_i etc.), which int8
    matmuls cannot represent, and integer tensor cores take int8 operands
    only.  But under the fast path's losslessness proof every intermediate
    requantize is an exact shift, so the dots DISTRIBUTE:

        dA = S1*br = (ar<<p1 + ai<<p2)*br = (ar*br)<<p1 + (ai*br)<<p2
        dB = ai*S2 =                        (ai*br)<<p3 + (ai*bi)<<p4
        dC = S3*bi =                        (ai*bi)<<p5 - (ar*bi)<<p6

    i.e. 4 elementary int8 matmuls (the Basic algorithm's products) +
    exact int32 shift/add recombination — bit-identical to the three-sum
    form by the proof.  Returns (dA, dB, dC) or None when operands are not
    int8 lanes / any int32 bound fails (caller falls back to the 3-matmul
    int16 form).
    """
    import jax.numpy as jnp

    ops = (a.real.data, a.imag.data, b.real.data, b.imag.data)
    if any(d.dtype != jnp.int8 for d in ops):
        return None
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    p1 = fal1 - far.frac_bits + w1
    p2 = fal1 - fai.frac_bits + w1
    p3 = fal2 - fbr.frac_bits + w2
    p4 = fal2 - fbi.frac_bits + w2
    p5 = fal1 - fai.frac_bits + w3
    p6 = fal1 - far.frac_bits + w3
    Drr = dot_partial_interval(fmt_interval(far) * fmt_interval(fbr), k)
    Dir_ = dot_partial_interval(fmt_interval(fai) * fmt_interval(fbr), k)
    Dii = dot_partial_interval(fmt_interval(fai) * fmt_interval(fbi), k)
    Dri = dot_partial_interval(fmt_interval(far) * fmt_interval(fbi), k)
    terms = [Drr << p1, Dir_ << p2, Dir_ << p3, Dii << p4,
             Dii << p5, Dri << p6]
    ivA = terms[0] + terms[1]
    ivB = terms[2] + terms[3]
    ivC = terms[4] - terms[5]
    post = [ivA << (fin_r.frac_bits - fA),
            ivB << (fin_r.frac_bits - fB),
            ivB << (fin_i.frac_bits - fB),
            ivC << (fin_i.frac_bits - fC)]
    if not all(iv.fits32 for iv in terms + [ivA, ivB, ivC] + post):
        return None

    def P(x, y):
        return jnp.matmul(x, y, preferred_element_type=jnp.int32)

    prr = P(a.real.data, b.real.data)
    pir = P(a.imag.data, b.real.data)
    pii = P(a.imag.data, b.imag.data)
    pri = P(a.real.data, b.imag.data)
    dA = (prr << p1) + (pir << p2)
    dB = (pir << p3) + (pii << p4)
    dC = (pii << p5) - (pri << p6)
    return dA, dB, dC


def _fast_cgemul(a, b, orf, oif, algo, r_layers, i_layers, mul_tags,
                 dot_reduce=None, k_total=None, limb_dot_reduce=None,
                 cap_mn=None, info=None):
    """Return the fast-path result, or None when the proof fails.

    ``dot_reduce`` (optional) is applied to each integer dot product before
    the combine/epilogue — the K-sharding hook: with operands holding a
    K-slice and ``dot_reduce=lambda d: jax.lax.psum(d, "tp")`` the partial
    int32 dots sum over the mesh, which is bit-exact because the proof (run
    against ``k_total``, the *global* contraction length) guarantees
    lossless integer accumulation in any order.

    When the pipeline is proven lossless but outgrows int32 lanes — wide
    dots, pair/limb operands, pair/limb output formats — the dots compute
    in the stacked-limb domain instead (balanced-digit int8 matmuls,
    :func:`~qublas_tpu.ops.limbdot.limb_dot_2d`) with exact limb
    shift/combine epilogues: the complex side of the wide-dot
    capability.  ``limb_dot_reduce`` is that path's K-sharding hook (a
    carry-correct limb psum); ``cap_mn`` overrides the output dims used in
    the limb envelope caps so a 1×1 sharding probe decides identically to
    the full-shape trace.
    """
    import jax.numpy as jnp

    if a.real.ndim != 2 or b.real.ndim != 2:
        return None
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    if any(t.is_host for t in (a.real, a.imag, b.real, b.imag)):
        return None
    lane_ops = not any(t.is_pair or t.is_limb
                       for t in (a.real, a.imag, b.real, b.imag))
    k = k_total if k_total is not None else a.shape[-1]
    ar = _Step(fmt_interval(far), far)
    ai = _Step(fmt_interval(fai), fai)
    br = _Step(fmt_interval(fbr), fbr)
    bi = _Step(fmt_interval(fbi), fbi)

    if algo == "tf":
        t = {n: mul_tags.get(n) for n in
             ("ab", "cd", "ba", "abc", "cdb", "bad", "AB", "BC")}
        fb = _single_default(*t.values())
        g = {n: (v if v is not None else fb) for n, v in t.items()}
        g["ba"] = t["ba"]  # baT never inherits the fallback
        s_ab = _s_addsub(ar, ai, g["ab"], sub=False)
        s_cd = _s_addsub(br, bi, g["cd"], sub=False)
        s_ba = _s_addsub(ai, ar, g["ba"], sub=True)
        if None in (s_ab, s_cd, s_ba):
            return None
        A = _s_mul(s_ab, br, g["abc"])
        B = _s_mul(s_cd, ai, g["bad"])
        C = _s_mul(s_ba, bi, g["cdb"])
        if None in (A, B, C):
            return None
        re_p = _s_addsub(A, B, g["AB"], sub=True)
        im_p = _s_addsub(B, C, g["BC"], sub=True)
    else:
        t = {n: mul_tags.get(n) for n in
             ("ac", "bd", "ad", "bc", "acbd", "adbc")}
        fb = _single_default(*t.values())
        g = {n: (v if v is not None else fb) for n, v in t.items()}
        ac = _s_mul(ar, br, g["ac"])
        bd = _s_mul(ai, bi, g["bd"])
        ad = _s_mul(ar, bi, g["ad"])
        bc = _s_mul(ai, br, g["bc"])
        if None in (ac, bd, ad, bc):
            return None
        re_p = _s_addsub(ac, bd, g["acbd"], sub=True)
        im_p = _s_addsub(ad, bc, g["adbc"], sub=False)
    if re_p is None or im_p is None:
        return None

    fin_r = tree_exact(re_p.iv, re_p.fmt, r_layers, k)
    fin_i = tree_exact(im_p.iv, im_p.fmt, i_layers, k)
    if fin_r is None or fin_i is None:
        return None
    orf = orf or fin_r
    oif = oif or fin_i
    from .widths import storage_kind

    if storage_kind(orf) is None or storage_kind(oif) is None:
        return None                       # host-storage outputs
    re_tot = dot_partial_interval(re_p.iv, k)
    im_tot = dot_partial_interval(im_p.iv, k)
    # final values at tree frac: lossless layers only shift left
    re_tot = re_tot << (fin_r.frac_bits - re_p.fmt.frac_bits)
    im_tot = im_tot << (fin_i.frac_bits - im_p.fmt.frac_bits)

    from ..complex import QComplexTensor

    def i32_path():
        """int32-lane compute: lane operands, int32-provable dots and
        epilogues.  Returns None on any WIDTH gate (the proof already
        passed) — the caller falls through to the limb domain."""
        if not lane_ops:
            return None
        if dtype_for(orf) is None or dtype_for(oif) is None:
            return None
        if not (re_tot.fits32 and im_tot.fits32):
            return None
        if route_requant(re_tot, fin_r.frac_bits, orf) != "i32":
            return None
        if route_requant(im_tot, fin_i.frac_bits, oif) != "i32":
            return None

        def shifted(x, pre_shift):
            y = x.data.astype(jnp.int32)
            return y << pre_shift if pre_shift else y

        def dot(x, y, iv_x, iv_y, post_shift):
            # every shifted dot term must itself fit int32, not just the
            # combined difference
            iv = dot_partial_interval(iv_x * iv_y, k)
            if not iv.fits32 or not (iv << post_shift).fits32:
                return None
            xd, yd = x, y
            if xd.dtype != jnp.int8 or yd.dtype != jnp.int8:
                # narrowest common lane by DTYPE (value-preserving for
                # fill(int)-wart raws, which legally exceed their format
                # range — an interval-based downcast wrapped them, r5
                # review repro).  Measured neutral vs int32 casts on the
                # current toolchain; kept as the explicit form
                narrow = jnp.int16 if all(
                    d in (jnp.int8, jnp.int16)
                    for d in (xd.dtype, yd.dtype)) else jnp.int32
                xd = xd.astype(narrow)
                yd = yd.astype(narrow)
            return jnp.matmul(xd, yd, preferred_element_type=jnp.int32)

        if algo == "tf":
            # precomputed elementwise operands must fit int32 lanes
            if not (s_ab.iv.fits32 and s_cd.iv.fits32 and s_ba.iv.fits32):
                return None
            fal1 = max(far.frac_bits, fai.frac_bits)
            w1 = s_ab.fmt.frac_bits - fal1
            fal2 = max(fbr.frac_bits, fbi.frac_bits)
            w2 = s_cd.fmt.frac_bits - fal2
            w3 = s_ba.fmt.frac_bits - fal1
            fA = s_ab.fmt.frac_bits + fbr.frac_bits
            fB = s_cd.fmt.frac_bits + fai.frac_bits
            fC = s_ba.fmt.frac_bits + fbi.frac_bits
            # the epilogue applies fin_r-fB AND fin_i-fB individually to
            # dB (and fin_r-fA / fin_i-fC to dA/dC) — every static shift
            # must be non-negative, not just the max-side one
            if min(fin_r.frac_bits - fA, fin_r.frac_bits - fB,
                   fin_i.frac_bits - fB, fin_i.frac_bits - fC) < 0:
                return None
            dd = _tf_int8_distributed(a, b, k, fal1, fal2, w1, w2, w3,
                                      fin_r, fin_i, fA, fB, fC)
            if info is not None:
                info["tf"] = "int8" if dd is not None else "sums"
            if dd is not None:
                dA, dB, dC = dd
            else:
                # the lossless elementwise sums at their step formats
                S1 = (shifted(a.real, fal1 - far.frac_bits + w1)
                      + shifted(a.imag, fal1 - fai.frac_bits + w1))
                S2 = (shifted(b.real, fal2 - fbr.frac_bits + w2)
                      + shifted(b.imag, fal2 - fbi.frac_bits + w2))
                S3 = (shifted(a.imag, fal1 - fai.frac_bits + w3)
                      - shifted(a.real, fal1 - far.frac_bits + w3))
                dA = dot(S1, b.real.data.astype(jnp.int32), s_ab.iv,
                         fmt_interval(fbr), fin_r.frac_bits - fA)
                dB = dot(a.imag.data.astype(jnp.int32), S2,
                         fmt_interval(fai), s_cd.iv,
                         max(fin_r.frac_bits, fin_i.frac_bits) - fB)
                dC = dot(S3, b.imag.data.astype(jnp.int32), s_ba.iv,
                         fmt_interval(fbi), fin_i.frac_bits - fC)
                if dA is None or dB is None or dC is None:
                    return None
            if dot_reduce is not None:
                dA, dB, dC = dot_reduce(dA), dot_reduce(dB), dot_reduce(dC)
            re = ((dA << (fin_r.frac_bits - fA))
                  - (dB << (fin_r.frac_bits - fB)))
            im = ((dB << (fin_i.frac_bits - fB))
                  - (dC << (fin_i.frac_bits - fC)))
        else:
            dac = dot(a.real.data, b.real.data, fmt_interval(far),
                      fmt_interval(fbr),
                      fin_r.frac_bits - far.frac_bits - fbr.frac_bits)
            dbd = dot(a.imag.data, b.imag.data, fmt_interval(fai),
                      fmt_interval(fbi),
                      fin_r.frac_bits - fai.frac_bits - fbi.frac_bits)
            dad = dot(a.real.data, b.imag.data, fmt_interval(far),
                      fmt_interval(fbi),
                      fin_i.frac_bits - far.frac_bits - fbi.frac_bits)
            dbc = dot(a.imag.data, b.real.data, fmt_interval(fai),
                      fmt_interval(fbr),
                      fin_i.frac_bits - fai.frac_bits - fbr.frac_bits)
            if dac is None or dbd is None or dad is None or dbc is None:
                return None
            if dot_reduce is not None:
                dac, dbd = dot_reduce(dac), dot_reduce(dbd)
                dad, dbc = dot_reduce(dad), dot_reduce(dbc)
            re = ((dac << (fin_r.frac_bits - far.frac_bits - fbr.frac_bits))
                  - (dbd << (fin_r.frac_bits - fai.frac_bits
                             - fbi.frac_bits)))
            im = ((dad << (fin_i.frac_bits - far.frac_bits - fbi.frac_bits))
                  + (dbc << (fin_i.frac_bits - fai.frac_bits
                             - fbr.frac_bits)))

        raw_r = W.requantize_i32(re, fin_r.frac_bits, orf)
        raw_i = W.requantize_i32(im, fin_i.frac_bits, oif)
        return QComplexTensor(QTensor(raw_r.astype(dtype_for(orf)), orf),
                              QTensor(raw_i.astype(dtype_for(oif)), oif))

    def limb_path():
        """Stacked-limb compute for proof-lossless configs beyond int32:
        each integer dot runs as a balanced-digit int8 matmul recombined
        into ``Kw`` uint32 limbs (:func:`~qublas_tpu.ops.limbdot.limb_dot_2d`),
        the shift/combine epilogue is exact limb arithmetic, and ONE limb
        requantize per part lands the result in any device storage.
        Bit-exact by the losslessness proof (identical to the real GEMM's
        limb fast-path argument, `ops/gemm.py:_fast_gemm_limb`).  Returns
        None outside the limb envelope."""
        from . import limbdot as D
        from . import limbint as L
        from .gemm import _LIMBDOT_MAX_DOT_ELEMS, _LIMBDOT_MAX_MATMULS
        from .widths import LIMB_INTER_MAX_BITS, requant_work_bits

        if dot_reduce is not None and limb_dot_reduce is None:
            # a K-sharding caller that cannot psum limb stacks must not
            # silently get unreduced partials
            return None
        if route_requant(re_tot, fin_r.frac_bits, orf) == "host":
            return None
        if route_requant(im_tot, fin_i.frac_bits, oif) == "host":
            return None
        cm, cn = cap_mn if cap_mn is not None else (a.real.shape[0],
                                                    b.real.shape[1])
        iv_ar, iv_ai = fmt_interval(far), fmt_interval(fai)
        iv_br, iv_bi = fmt_interval(fbr), fmt_interval(fbi)

        if algo == "tf":
            fal1 = max(far.frac_bits, fai.frac_bits)
            fal2 = max(fbr.frac_bits, fbi.frac_bits)
            w1 = s_ab.fmt.frac_bits - fal1
            w2 = s_cd.fmt.frac_bits - fal2
            w3 = s_ba.fmt.frac_bits - fal1
            fA = s_ab.fmt.frac_bits + fbr.frac_bits
            fB = s_cd.fmt.frac_bits + fai.frac_bits
            fC = s_ba.fmt.frac_bits + fbi.frac_bits
            dspecs = [(s_ab.iv, iv_br, fin_r.frac_bits - fA),
                      (iv_ai, s_cd.iv,
                       max(fin_r.frac_bits, fin_i.frac_bits) - fB),
                      (s_ba.iv, iv_bi, fin_i.frac_bits - fC)]
            align = [fal1 - far.frac_bits + w1, fal1 - fai.frac_bits + w1,
                     fal2 - fbr.frac_bits + w2, fal2 - fbi.frac_bits + w2,
                     fal1 - fai.frac_bits + w3, fal1 - far.frac_bits + w3]
            extra_bits = [s_ab.iv.bits, s_cd.iv.bits, s_ba.iv.bits]
        else:
            dspecs = [(iv_ar, iv_br,
                       fin_r.frac_bits - far.frac_bits - fbr.frac_bits),
                      (iv_ai, iv_bi,
                       fin_r.frac_bits - fai.frac_bits - fbi.frac_bits),
                      (iv_ar, iv_bi,
                       fin_i.frac_bits - far.frac_bits - fbi.frac_bits),
                      (iv_ai, iv_br,
                       fin_i.frac_bits - fai.frac_bits - fbr.frac_bits)]
            align = []
            extra_bits = []
        if any(s < 0 for _, _, s in dspecs) or any(s < 0 for s in align):
            return None                   # shift invariant violated
        if algo == "tf" and (fin_r.frac_bits < fB or fin_i.frac_bits < fB):
            # epilogue L.lshl's dB by fin_r-fB AND fin_i-fB individually;
            # dspecs only checked max(fin_r,fin_i)-fB (ADVICE r4)
            return None

        need = max(requant_work_bits(re_tot, fin_r.frac_bits, orf),
                   requant_work_bits(im_tot, fin_i.frac_bits, oif),
                   re_tot.bits, im_tot.bits, *([1] + extra_bits))
        for ivx, ivy, sh in dspecs:
            if D.digit_matmuls(ivx, ivy) > _LIMBDOT_MAX_MATMULS:
                return None
            nd_x, nd_y = D.digits_needed(ivx), D.digits_needed(ivy)
            nseg = -(-k // D._seg_len(k, min(nd_x, nd_y)))
            if nd_x * nd_y * nseg * cm * cn > _LIMBDOT_MAX_DOT_ELEMS:
                return None
            need = max(need, D.work_bits(ivx, ivy, k),
                       (dot_partial_interval(ivx * ivy, k) << sh).bits)
        if need > LIMB_INTER_MAX_BITS:
            return None
        Kw = L.bits_to_limbs(need)

        def tolimb(x, shift):
            l = D.to_limbs_any(x, Kw)
            return L.lshl(l, shift) if shift else l

        if algo == "tf":
            S1 = L.ladd(tolimb(a.real.data, align[0]),
                        tolimb(a.imag.data, align[1]))
            S2 = L.ladd(tolimb(b.real.data, align[2]),
                        tolimb(b.imag.data, align[3]))
            S3 = L.lsub(tolimb(a.imag.data, align[4]),
                        tolimb(a.real.data, align[5]))
            dA = D.limb_dot_2d(L.LimbArray(S1), b.real.data,
                               s_ab.iv, iv_br, Kw)
            dB = D.limb_dot_2d(a.imag.data, L.LimbArray(S2),
                               iv_ai, s_cd.iv, Kw)
            dC = D.limb_dot_2d(L.LimbArray(S3), b.imag.data,
                               s_ba.iv, iv_bi, Kw)
            if limb_dot_reduce is not None:
                dA, dB, dC = (limb_dot_reduce(dA), limb_dot_reduce(dB),
                              limb_dot_reduce(dC))
            re = L.lsub(L.lshl(dA, fin_r.frac_bits - fA),
                        L.lshl(dB, fin_r.frac_bits - fB))
            im = L.lsub(L.lshl(dB, fin_i.frac_bits - fB),
                        L.lshl(dC, fin_i.frac_bits - fC))
        else:
            dac = D.limb_dot_2d(a.real.data, b.real.data, iv_ar, iv_br, Kw)
            dbd = D.limb_dot_2d(a.imag.data, b.imag.data, iv_ai, iv_bi, Kw)
            dad = D.limb_dot_2d(a.real.data, b.imag.data, iv_ar, iv_bi, Kw)
            dbc = D.limb_dot_2d(a.imag.data, b.real.data, iv_ai, iv_br, Kw)
            if limb_dot_reduce is not None:
                dac, dbd = limb_dot_reduce(dac), limb_dot_reduce(dbd)
                dad, dbc = limb_dot_reduce(dad), limb_dot_reduce(dbc)
            re = L.lsub(L.lshl(dac, dspecs[0][2]),
                        L.lshl(dbd, dspecs[1][2]))
            im = L.ladd(L.lshl(dad, dspecs[2][2]),
                        L.lshl(dbc, dspecs[3][2]))

        def wrap(raw, fmt):
            kind = storage_kind(fmt)
            if kind == "lane":
                return QTensor(raw.astype(dtype_for(fmt)), fmt)
            if kind == "pair":
                return QTensor(W.PairArray(raw[0], raw[1]), fmt)
            return QTensor(L.LimbArray(raw), fmt)

        raw_r = L.requantize_limb(re, fin_r.frac_bits, orf)
        raw_i = L.requantize_limb(im, fin_i.frac_bits, oif)
        return QComplexTensor(wrap(raw_r, orf), wrap(raw_i, oif))

    res = i32_path()
    if res is not None:
        if info is not None:
            info["domain"] = "i32"
        return res
    res = limb_path()
    if res is not None and info is not None:
        info["domain"] = "limb"
    return res


def _part_formats(spec):
    if spec is None:
        return None, None
    if isinstance(spec, QFormat):
        return spec, spec
    real, imag = spec
    return real, imag


def _split_layers(add_formats):
    """Per-layer specs: each entry is a QFormat (both parts) or an inner
    ``(real_fmt, imag_fmt)`` pair.  A bare tuple of QFormats is a list of
    LAYERS (matching qgemul's add_formats and the hostops.cgemul oracle) —
    a single per-part layer must be written ``((r, i),)``."""
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    reals, imags = [], []
    for spec in add_formats:
        r, i = _part_formats(spec)
        reals.append(r)
        imags.append(i)
    return tuple(reals), tuple(imags)


def cgemul(a, b, out_fmt, algo: str = "basic", add_formats=(),
           transpose_a: bool = False, transpose_b: bool = False,
           **mul_tags):
    """C = op(A) @ op(B) over complex fixed-point tensors.

    ``out_fmt`` is a QFormat (both parts) or a (real_fmt, imag_fmt) pair.
    ``algo`` selects the per-product multiply: ``"basic"`` or ``"tf"``;
    ``mul_tags`` are its per-step formats (``ac``/``bd``/... or
    ``ab``/``cd``/``ba``/...; tag-default propagation quirks included).
    """
    from ..complex import QComplexTensor, cmul, cmul_tf

    a = _ctranspose(a, transpose_a)
    b = _ctranspose(b, transpose_b)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    orf, oif = _part_formats(out_fmt)
    r_layers, i_layers = _split_layers(add_formats)

    fast = None if _FAST_OFF else \
        _fast_cgemul(a, b, orf, oif, algo, r_layers, i_layers, mul_tags)
    if fast is not None:
        return fast

    # batched fast path: the lossless proof is shape-independent, so probe
    # it on one batch element's 1-row x 1-col slice, then vmap the 2-D
    # fast path over the flattened batch (3-4 integer matmuls per element
    # instead of the layered [.., m, k, n] program)
    if (not _FAST_OFF and a.real.ndim == b.real.ndim > 2
            and a.real.shape[:-2] == b.real.shape[:-2]
            and not any(t.is_host or t.is_pair or t.is_limb
                        for t in (a.real, a.imag, b.real, b.imag))):
        import jax

        batch = a.real.shape[:-2]
        m, k = a.real.shape[-2:]
        n = b.real.shape[-1]
        idx0 = (0,) * len(batch)
        probe = _fast_cgemul(
            QComplexTensor(
                QTensor(a.real.data[idx0][:1, :], a.real.fmt),
                QTensor(a.imag.data[idx0][:1, :], a.imag.fmt)),
            QComplexTensor(
                QTensor(b.real.data[idx0][:, :1], b.real.fmt),
                QTensor(b.imag.data[idx0][:, :1], b.imag.fmt)),
            orf, oif, algo, r_layers, i_layers, mul_tags, k_total=k)
        if probe is not None and not (probe.real.is_pair or probe.real.is_limb
                                      or probe.imag.is_pair
                                      or probe.imag.is_limb):
            # vmap composes with lane-array results only: a batched
            # PairArray/LimbArray leaf would put the batch dim ahead of
            # the limb axis and the storage wrapper would misread it
            def one(ar, ai, br, bi):
                c = _fast_cgemul(
                    QComplexTensor(QTensor(ar, a.real.fmt),
                                   QTensor(ai, a.imag.fmt)),
                    QComplexTensor(QTensor(br, b.real.fmt),
                                   QTensor(bi, b.imag.fmt)),
                    orf, oif, algo, r_layers, i_layers, mul_tags)
                return c.real.data, c.imag.data

            rr, ri = jax.vmap(one)(
                a.real.data.reshape((-1, m, k)),
                a.imag.data.reshape((-1, m, k)),
                b.real.data.reshape((-1, k, n)),
                b.imag.data.reshape((-1, k, n)))
            return QComplexTensor(
                QTensor(rr.reshape(batch + (m, n)), probe.real.fmt),
                QTensor(ri.reshape(batch + (m, n)), probe.imag.fmt))

    pa = QComplexTensor(QTensor(a.real.data[..., :, :, None], a.real.fmt),
                        QTensor(a.imag.data[..., :, :, None], a.imag.fmt))
    pb = QComplexTensor(QTensor(b.real.data[..., None, :, :], b.real.fmt),
                        QTensor(b.imag.data[..., None, :, :], b.imag.fmt))
    mulfn = cmul_tf if algo == "tf" else cmul
    prod = mulfn(pa, pb, **mul_tags)
    real = qreduce(prod.real, r_layers, axis=-2)
    imag = qreduce(prod.imag, i_layers, axis=-2)
    return QComplexTensor(ew.qcast(real, orf or real.fmt),
                          ew.qcast(imag, oif or imag.fmt))


def cgemv(a, x, out_fmt, algo: str = "basic", add_formats=(),
          transpose_a: bool = False, **mul_tags):
    """y = op(A) @ x, complex matrix-vector."""
    from ..complex import QComplexTensor

    col = QComplexTensor(QTensor(x.real.data[..., :, None], x.real.fmt),
                         QTensor(x.imag.data[..., :, None], x.imag.fmt))
    y = cgemul(a, col, out_fmt, algo, add_formats,
               transpose_a=transpose_a, **mul_tags)
    return QComplexTensor(QTensor(y.real.data[..., 0], y.real.fmt),
                          QTensor(y.imag.data[..., 0], y.imag.fmt))


def _ctranspose(c, flag: bool):
    if not flag:
        return c
    from ..complex import QComplexTensor

    def t(q: QTensor) -> QTensor:
        import numpy as np

        data = (np.swapaxes(q.data, -1, -2) if q.is_host
                else q.data.swapaxes(-1, -2))
        return QTensor(data, q.fmt)

    return QComplexTensor(t(c.real), t(c.imag))
