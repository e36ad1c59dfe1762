"""Limb-domain wide fast GEMM (round 4): proof-lossless configs whose dot
outgrows the signed 64-bit pair domain — wide pair operands (e.g. 40x40-bit
GEMMs with 80-bit products), limb-storage operands, limb-storage outputs —
compute a balanced-digit int8 dot + exact stacked-limb recombination
(:mod:`qublas_tpu.ops.limbdot`) instead of the order-preserving streaming
tree.  Bit-exactness pins: the host golden model, and the pre-round-4 route
(same qgemul call with the limb fast path disabled).
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qublas_tpu import from_raw, hostops, qformat
from qublas_tpu.ops import gemm, limbdot, limbint
from qublas_tpu.ops.widths import Interval, fmt_interval
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge
from qublas_tpu.qtensor import QTensor


def rand_raws(fmt, n, seed):
    rng = random.Random(f"fgl:{seed}:{fmt.storage_bits}")
    return np.array([rng.randint(fmt.raw_min, fmt.raw_max)
                     for _ in range(n)], dtype=object)


def _assert_same(got, ref):
    assert got.fmt == ref.fmt
    g = np.asarray(got.raw(), dtype=object)
    w = np.asarray(ref.raw(), dtype=object)
    assert g.shape == w.shape
    assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)]


def _without_fast_limb(fn):
    """Reference result with the limb fast path disabled (the pre-round-4
    route: streaming / layered tree / host)."""
    saved = gemm._fast_gemm_limb
    gemm._fast_gemm_limb = lambda *a, **k: None
    try:
        return fn()
    finally:
        gemm._fast_gemm_limb = saved


def _vs_oracle(ta, tb, out, kw, A, B):
    got = gemm.qgemul(ta, tb, out, **kw)
    m, k = A.shape
    n = B.shape[1]
    ho = hostops.qgemul(
        [[(int(A[i, j]), ta.fmt) for j in range(k)] for i in range(m)],
        [[(int(B[i, j]), tb.fmt) for j in range(n)] for i in range(k)],
        out, kw.get("mul_to"), kw.get("add_formats", ()))
    g = np.asarray(got.raw(), dtype=object)
    assert all(int(g[i][j]) == ho[i][j][0]
               for i in range(m) for j in range(n))
    return got


def _plan(ta, tb, kw, k):
    mul_fmt = mul_merge(ta.fmt, tb.fmt, kw.get("mul_to"),
                        kw.get("mul_full_prec", False))
    return gemm.exact_plan(ta.fmt, tb.fmt, mul_fmt,
                           tuple(kw.get("add_formats", ())), k)


def _taken(ta, tb, out, kw):
    """Assert the limb fast path actually takes this config (and the pair
    wide path does not — no overlap)."""
    k = ta.shape[-1]
    plan = _plan(ta, tb, kw, k)
    assert plan is not None
    assert gemm._fast_gemm_wide(ta, tb, out, plan) is None
    assert gemm._fast_gemm_limb(ta, tb, out, plan) is not None
    return plan


# 40-bit x 40-bit: 80-bit products, far beyond the pair domain
WIDE_KW = dict(mul_to=qformat(51, 30), add_formats=(qformat(57, 30),))


def test_wide_pair_operands_limb_output_vs_oracle_and_prev():
    fa = qformat(25, 15)
    fb = qformat(25, 15)
    out = qformat(60, 20, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_TCPL)   # limb storage
    m, k, n = 3, 21, 2     # odd k: ragged segment tail
    A = rand_raws(fa, m * k, 1).reshape(m, k)
    B = rand_raws(fb, k * n, 2).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    assert ta.is_pair and tb.is_pair
    _taken(ta, tb, out, WIDE_KW)
    got = _vs_oracle(ta, tb, out, WIDE_KW, A, B)
    assert got.is_limb
    ref = _without_fast_limb(lambda: gemm.qgemul(ta, tb, out, **WIDE_KW))
    _assert_same(got, ref)


def test_limb_operand_lane_output_vs_oracle_and_prev():
    fa = qformat(40, 30)   # 70-bit limb storage
    fb = qformat(10, 8)
    out = qformat(30, 10, overflow_mode=OverflowMode.SAT_ZERO)
    kw = dict(mul_to=qformat(51, 38), add_formats=(qformat(57, 38),))
    m, k, n = 2, 17, 3
    A = rand_raws(fa, m * k, 3).reshape(m, k)
    B = rand_raws(fb, k * n, 4).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    assert ta.is_limb
    _taken(ta, tb, out, kw)
    got = _vs_oracle(ta, tb, out, kw, A, B)
    ref = _without_fast_limb(lambda: gemm.qgemul(ta, tb, out, **kw))
    _assert_same(got, ref)


def test_pair_output_keep():
    fa = qformat(25, 15)
    fb = qformat(25, 15)
    out = qformat(40, 20, round_mode=RoundMode.RND_NEG_INF,
                  overflow_mode=OverflowMode.SAT_TCPL)   # pair storage
    m, k, n = 2, 12, 3
    A = rand_raws(fa, m * k, 5).reshape(m, k)
    B = rand_raws(fb, k * n, 6).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    _taken(ta, tb, out, WIDE_KW)
    got = gemm.qgemul(ta, tb, out, **WIDE_KW)
    assert got.is_pair
    ref = _without_fast_limb(lambda: gemm.qgemul(ta, tb, out, **WIDE_KW))
    _assert_same(got, ref)
    _vs_oracle(ta, tb, out, WIDE_KW, A, B)


@pytest.mark.parametrize("omode", [OverflowMode.SAT_SMGN,
                                   OverflowMode.WRP_TCPL,
                                   OverflowMode.WRP_TCPL_SAT])
def test_epilogue_modes_vs_oracle(omode):
    fa = qformat(25, 15)
    fb = qformat(25, 15)
    out = qformat(24, 8, round_mode=RoundMode.TRN_SMGN, overflow_mode=omode)
    m, k, n = 2, 9, 2
    A = rand_raws(fa, m * k, 7 + int(omode)).reshape(m, k)
    B = rand_raws(fb, k * n, 8 + int(omode)).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    _taken(ta, tb, out, WIDE_KW)
    _vs_oracle(ta, tb, out, WIDE_KW, A, B)


def test_jit_compatible():
    fa = qformat(25, 15)
    fb = qformat(25, 15)
    out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    m, k, n = 2, 16, 2
    ta = from_raw(rand_raws(fa, m * k, 9).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 10).reshape(k, n), fb)

    def f(ah, al, bh, bl):
        a = QTensor(gemm.W.PairArray(ah, al), fa)
        b = QTensor(gemm.W.PairArray(bh, bl), fb)
        return gemm.qgemul(a, b, out, **WIDE_KW).data.limbs

    got = QTensor(limbint.LimbArray(jax.jit(f)(
        ta.data.hi, ta.data.lo, tb.data.hi, tb.data.lo)), out)
    eager = gemm.qgemul(ta, tb, out, **WIDE_KW)
    _assert_same(got, eager)


def test_balanced_digits_roundtrip():
    """Digit decomposition is exact: sum_i d_i 256^i == value, digits in
    [-128, 127], for lane, pair, and limb inputs across the value range."""
    rng = random.Random("bd")
    for bits in (8, 17, 31, 40, 64, 70, 130):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        vals = [lo, hi, 0, -1, 1] + [rng.randint(lo, hi) for _ in range(11)]
        arr = np.array(vals, dtype=object)
        fmt = qformat(bits, 0)
        t = from_raw(arr, fmt)
        iv = fmt_interval(fmt)
        nd = limbdot.digits_needed(iv)
        dig = np.asarray(limbdot.balanced_digits(t.data, nd)).astype(object)
        assert dig.min() >= -128 and dig.max() <= 127
        rec = sum(dig[i] * (256 ** i) for i in range(nd))
        assert [int(v) for v in rec] == vals


def test_work_bits_covers_actual_accumulator():
    """The Kw from limb_dot_plan covers the true dot (spot check: the raw
    limb accumulator equals the exact integer dot before the epilogue)."""
    fa = qformat(25, 15)
    fb = qformat(25, 15)
    m, k, n = 2, 21, 2
    A = rand_raws(fa, m * k, 11).reshape(m, k)
    B = rand_raws(fb, k * n, 12).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    iva, ivb = fmt_interval(fa), fmt_interval(fb)
    Kw = limbint.bits_to_limbs(limbdot.work_bits(iva, ivb, k))
    acc = limbdot.limb_dot_2d(ta.data, tb.data, iva, ivb, Kw)
    got = limbint.ints_from_limbs(acc)
    want = A @ B
    assert [int(v) for v in got.reshape(-1)] \
        == [int(v) for v in want.reshape(-1)]


def test_gate_rejects_oversized_configs(monkeypatch):
    """Admission caps: too many digit matmuls or too large a dot tensor must
    return None (falls through to the stream)."""
    fa = qformat(25, 15)
    fb = qformat(25, 15)
    out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    k = 16
    plan = _plan(QTensor(None, fa), QTensor(None, fb), WIDE_KW, k)

    monkeypatch.setattr(gemm, "_LIMBDOT_MAX_MATMULS", 8)
    assert gemm.limb_dot_plan(fa, fb, out, plan, k, 2, 2) is None
    monkeypatch.undo()
    monkeypatch.setattr(gemm, "_LIMBDOT_MAX_DOT_ELEMS", 8)
    assert gemm.limb_dot_plan(fa, fb, out, plan, k, 2, 2) is None
    monkeypatch.undo()
    assert gemm.limb_dot_plan(fa, fb, out, plan, k, 2, 2) is not None


def test_int32_dot_configs_not_taken():
    """Configs the int32 matmul path already covers must not reach the limb
    gate (dispatch order), and order-sensitive configs have no plan."""
    f8 = qformat(4, 4)
    out = qformat(16, 8)
    kw = dict(mul_to=qformat(9, 8), add_formats=(qformat(15, 8),))
    k = 16
    plan = _plan(QTensor(None, f8), QTensor(None, f8), kw, k)
    assert plan is not None and plan.dot_interval.fits32
    # order-sensitive: default merges round/saturate -> no plan at all
    f = qformat(30, 9)
    mul_fmt = mul_merge(f, f, None, False)
    assert gemm.exact_plan(f, f, mul_fmt, (), k) is None


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_vs_prev_route(trial):
    """Random proof-lossless beyond-64-bit configs: limb fast path == the
    pre-round-4 route (stream/layered/host), and == the oracle."""
    rng = np.random.RandomState(6200 + trial)
    ia = int(rng.randint(20, 34))
    fa = qformat(ia, int(rng.randint(8, 20)))
    fb = qformat(int(rng.randint(20, 34)), int(rng.randint(8, 20)))
    pf = fa.frac_bits + fb.frac_bits
    k = int(rng.randint(5, 40))
    mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf)
    layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 2, pf),)
    out = qformat(int(rng.randint(20, 50)), int(rng.randint(0, 12)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(int(rng.choice([0, 1, 2, 3]))))
    m, n = 2, 3
    mul_fmt = mul_merge(fa, fb, mul_to, False)
    plan = gemm.exact_plan(fa, fb, mul_fmt, layers, k)
    if plan is None or plan.dot_interval.fits64:
        pytest.skip("config not in the limb fast-path regime")
    if gemm.limb_dot_plan(fa, fb, out, plan, k, m, n) is None:
        pytest.skip("outside the limb gate")
    A = rand_raws(fa, m * k, 300 + trial).reshape(m, k)
    B = rand_raws(fb, k * n, 400 + trial).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    kw = dict(mul_to=mul_to, add_formats=layers)
    got = _vs_oracle(ta, tb, out, kw, A, B)
    ref = _without_fast_limb(lambda: gemm.qgemul(ta, tb, out, **kw))
    _assert_same(got, ref)


def test_seg_len_small_products_clamps_to_k():
    """Narrow digit products must clamp the segment to k (mirrors the
    round-3 pair-path finding): no multi-GB zero padding."""
    iv = Interval(-4, 3)
    assert limbdot._seg_len(12, limbdot.digits_needed(iv)) == 12


def test_limb_axis_sum_odd_and_ones():
    rng = np.random.RandomState(77)
    vals = [int(v) for v in rng.randint(-(10 ** 12), 10 ** 12, size=7)]
    limbs = limbint.limbs_from_ints(np.array(vals, dtype=object), 3)
    got = limbint.ints_from_limbs(limbdot.limb_axis_sum(limbs, 0))
    assert int(got) == sum(vals)
    one = limbint.limbs_from_ints(np.array([42], dtype=object), 2)
    assert int(limbint.ints_from_limbs(limbdot.limb_axis_sum(one, 0))) == 42


def test_limb_dispatch_preferred_over_pair(monkeypatch):
    """Late-round-4 dispatch reorder: where BOTH wide fast paths admit a
    config, qgemul must take the balanced-digit int8 dot first (device-trace
    measured 28-672x the pair-domain dot across lane widths)."""
    import numpy as np

    import jax.numpy as jnp

    from qublas_tpu import hostops
    from qublas_tpu.qformat import mul_merge, qformat
    from qublas_tpu.qtensor import QTensor

    fa = qformat(13, 0)
    out = qformat(25, 0)
    kw = dict(mul_to=qformat(27, 0), add_formats=(qformat(40, 0),))
    m, k, n = 4, 96, 4
    plan = gemm.exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                           kw["add_formats"], k)
    assert plan is not None and not plan.dot_interval.fits32

    rng = np.random.RandomState(5)
    A = rng.randint(fa.raw_min, fa.raw_max + 1, (m, k)).astype(np.int64)
    B = rng.randint(fa.raw_min, fa.raw_max + 1, (k, n)).astype(np.int64)
    ta = QTensor(jnp.asarray(A.astype(np.int16)), fa)
    tb = QTensor(jnp.asarray(B.astype(np.int16)), fa)

    # the overlap is real: the pair path would also admit this config
    assert gemm.wide_dot_ok(ta, tb, out, plan)
    assert gemm.limb_dot_plan(fa, fa, out, plan, k, m, n) is not None

    taken = []
    orig_l, orig_w = gemm._fast_gemm_limb, gemm._fast_gemm_wide
    monkeypatch.setattr(gemm, "_fast_gemm_limb",
                        lambda *a, **kk: taken.append("limb")
                        or orig_l(*a, **kk))
    monkeypatch.setattr(gemm, "_fast_gemm_wide",
                        lambda *a, **kk: taken.append("wide")
                        or orig_w(*a, **kk))
    r = gemm.qgemul(ta, tb, out, **kw)
    assert taken == ["limb"], taken  # wide never consulted

    want = hostops.qgemul(
        [[(int(A[i, p]), fa) for p in range(k)] for i in range(m)],
        [[(int(B[p, j]), fa) for j in range(n)] for p in range(k)],
        out, kw["mul_to"], kw["add_formats"])
    g = np.asarray(r.data)
    for i in range(m):
        for j in range(n):
            assert int(g[i, j]) == want[i][j][0]
