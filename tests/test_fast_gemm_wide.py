"""Single-chip wide fast GEMM (round 3): proof-lossless configs whose dot
outgrows int32 compute an exact 64-bit pair dot (matmul segment decomposition
for lane operands, chunked pair products otherwise) + one pair epilogue,
instead of the order-preserving streaming tree.  Bit-exactness pins:
host golden model (breaks any common-mode bug with the sharded wide-K
path, which shares pair_dot_2d) and the streaming tree with the fast path
disabled.
"""

import random

import numpy as np
import pytest

import jax

from qublas_tpu import from_raw, hostops, qformat
from qublas_tpu.ops import gemm
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge
from qublas_tpu.qtensor import QTensor


def rand_raws(fmt, n, seed):
    rng = random.Random(f"fgw:{seed}:{fmt.storage_bits}")
    return np.array([rng.randint(fmt.raw_min, fmt.raw_max)
                     for _ in range(n)], dtype=object)


def _assert_same(got, ref):
    assert got.fmt == ref.fmt
    g = np.asarray(got.raw(), dtype=object)
    w = np.asarray(ref.raw(), dtype=object)
    assert g.shape == w.shape
    assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)]


def _without_fast_wide(monkeypatch, fn):
    """Reference result with the wide fast path disabled (streaming/layered
    tree — the pre-round-3 route)."""
    saved = gemm._fast_gemm_wide
    gemm._fast_gemm_wide = lambda *a, **k: None
    try:
        return fn()
    finally:
        gemm._fast_gemm_wide = saved


PAIR_KW = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))


def _taken(ta, tb, out, **kw):
    """Assert the fast path actually takes this config."""
    mul_fmt = mul_merge(ta.fmt, tb.fmt, kw.get("mul_to"),
                        kw.get("mul_full_prec", False))
    plan = gemm.exact_plan(ta.fmt, tb.fmt, mul_fmt,
                           tuple(kw.get("add_formats", ())), ta.shape[-1])
    assert plan is not None and not plan.dot_interval.fits32
    assert gemm._fast_gemm_wide(ta, tb, out, plan) is not None
    return plan


def test_pair_operand_vs_oracle_and_stream(monkeypatch):
    fa = qformat(30, 9)
    fb = qformat(8, 8)
    out = qformat(20, 6, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_ZERO)
    m, k, n = 3, 21, 2     # odd k: segment/chunk tails
    A = rand_raws(fa, m * k, 1).reshape(m, k)
    B = rand_raws(fb, k * n, 2).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    assert ta.is_pair
    _taken(ta, tb, out, **PAIR_KW)
    got = gemm.qgemul(ta, tb, out, **PAIR_KW)
    ho = hostops.qgemul(
        [[(int(A[i, j]), fa) for j in range(k)] for i in range(m)],
        [[(int(B[i, j]), fb) for j in range(n)] for i in range(k)],
        out, PAIR_KW["mul_to"], PAIR_KW["add_formats"])
    g = np.asarray(got.raw(), dtype=object)
    assert all(int(g[i][j]) == ho[i][j][0]
               for i in range(m) for j in range(n))
    ref = _without_fast_wide(
        monkeypatch, lambda: gemm.qgemul(ta, tb, out, **PAIR_KW))
    _assert_same(got, ref)


def test_lane_segment_path_vs_oracle():
    """(13,0) lane operands: products fit int32, dot does not — the matmul
    segment decomposition."""
    fa = qformat(13, 0)
    out = qformat(25, 0, overflow_mode=OverflowMode.SAT_TCPL)
    # layer format sized for the proof's per-layer doubling (needs headroom
    # to 128 = 2^ceil(log2 70) products, not 70)
    kw = dict(mul_to=qformat(27, 0), add_formats=(qformat(34, 0),))
    m, k, n = 2, 70, 2     # 70 % seg(31) != 0: zero-padded tail segment
    A = rand_raws(fa, m * k, 3).reshape(m, k)
    B = rand_raws(fa, k * n, 4).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fa)
    _taken(ta, tb, out, **kw)
    got = gemm.qgemul(ta, tb, out, **kw)
    ho = hostops.qgemul(
        [[(int(A[i, j]), fa) for j in range(k)] for i in range(m)],
        [[(int(B[i, j]), fa) for j in range(n)] for i in range(k)],
        out, kw["mul_to"], kw["add_formats"])
    g = np.asarray(got.raw(), dtype=object)
    assert all(int(g[i][j]) == ho[i][j][0]
               for i in range(m) for j in range(n))


def test_pair_output_keep(monkeypatch):
    fa = qformat(30, 9)
    fb = qformat(8, 8)
    out = qformat(36, 10, round_mode=RoundMode.RND_POS_INF,
                  overflow_mode=OverflowMode.SAT_TCPL)   # pair storage
    m, k, n = 2, 12, 3
    ta = from_raw(rand_raws(fa, m * k, 5).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 6).reshape(k, n), fb)
    _taken(ta, tb, out, **PAIR_KW)
    got = gemm.qgemul(ta, tb, out, **PAIR_KW)
    assert got.is_pair
    ref = _without_fast_wide(
        monkeypatch, lambda: gemm.qgemul(ta, tb, out, **PAIR_KW))
    _assert_same(got, ref)


def test_jit_compatible():
    fa = qformat(30, 9)
    fb = qformat(8, 8)
    out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    m, k, n = 2, 16, 2
    ta = from_raw(rand_raws(fa, m * k, 7).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 8).reshape(k, n), fb)
    f = jax.jit(lambda ah, al, bd: gemm.qgemul(
        QTensor(gemm.W.PairArray(ah, al), fa), QTensor(bd, fb), out,
        **PAIR_KW).data)
    got = QTensor(f(ta.data.hi, ta.data.lo, tb.data), out)
    eager = gemm.qgemul(ta, tb, out, **PAIR_KW)
    _assert_same(got, eager)


def test_order_sensitive_configs_not_taken():
    """A saturating tree has no proof — qgemul must stay on the exact
    order-preserving tree (plan is None, fast-wide never consulted)."""
    f = qformat(30, 9)
    k = 12
    mul_fmt = mul_merge(f, f, None, False)
    assert gemm.exact_plan(f, f, mul_fmt, (), k) is None


def test_small_product_interval_does_not_blow_up(monkeypatch):
    """Round-3 review regression: a narrow format's segment length must
    clamp to k — (4,0) products bound at 256, so the unclamped segment was
    I32_MAX // 256 ≈ 8.4M elements of zero padding (multi-GB at real m/n).
    The clamped path must stay exact."""
    fa = qformat(4, 0)
    out = qformat(36, 10, overflow_mode=OverflowMode.SAT_TCPL)
    kw = dict(mul_to=qformat(9, 0), add_formats=(qformat(15, 0),))
    m, k, n = 2, 32, 2
    A = rand_raws(fa, m * k, 40).reshape(m, k)
    B = rand_raws(fa, k * n, 41).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fa)
    mul_fmt = mul_merge(fa, fa, kw["mul_to"], False)
    plan = gemm.exact_plan(fa, fa, mul_fmt, kw["add_formats"], k)
    assert plan is not None
    res = gemm._fast_gemm_wide(ta, tb, out, plan)
    assert res is not None          # the path engages (pair-storage out)
    ho = hostops.qgemul(
        [[(int(A[i, j]), fa) for j in range(k)] for i in range(m)],
        [[(int(B[i, j]), fa) for j in range(n)] for i in range(k)],
        out, kw["mul_to"], kw["add_formats"])
    g = np.asarray(res.raw(), dtype=object)
    assert all(int(g[i][j]) == ho[i][j][0]
               for i in range(m) for j in range(n))
    # and the padded operand can never exceed k + seg elements
    import jax

    shapes = []

    def probe(ad, bd):
        r = gemm.pair_dot_2d(ad, bd, plan.prod_interval)
        shapes.append(r[0].shape)
        return r

    jax.eval_shape(probe, ta.data, tb.data)  # must not OOM / build 8M pads


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_vs_stream(monkeypatch, trial):
    """Random lossless wide-dot configs: fast path == streaming tree."""
    rng = np.random.RandomState(5000 + trial)
    fa = qformat(int(rng.randint(20, 31)), int(rng.randint(0, 7)))
    fb = qformat(int(rng.randint(4, 9)), int(rng.randint(0, 7)))
    out = qformat(int(rng.randint(10, 25)), int(rng.randint(0, 6)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(int(rng.choice([0, 1, 2, 3]))))
    k = int(rng.randint(9, 90))
    pf = fa.frac_bits + fb.frac_bits
    mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf)
    layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 2, pf),)
    m, n = 2, 3
    mul_fmt = mul_merge(fa, fb, mul_to, False)
    plan = gemm.exact_plan(fa, fb, mul_fmt, layers, k)
    if plan is None or plan.dot_interval.fits32 \
            or not plan.dot_interval.fits64:
        pytest.skip("config not in the wide fast-path regime")
    ta = from_raw(rand_raws(fa, m * k, 100 + trial).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 200 + trial).reshape(k, n), fb)
    got = gemm.qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers)
    ref = _without_fast_wide(
        monkeypatch,
        lambda: gemm.qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers))
    _assert_same(got, ref)


def test_wrp_tcpl_sat_epilogue_vs_oracle():
    """WRP_TCPL_SAT output (identity stub + machine-word wrap at the
    store): the pair epilogue's low-32 truncation must equal the oracle's
    int32 word wrap."""
    fa = qformat(30, 9)
    fb = qformat(8, 8)
    out = qformat(20, 6, overflow_mode=OverflowMode.WRP_TCPL_SAT)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 2, 16, 2
    A = rand_raws(fa, m * k, 50).reshape(m, k)
    B = rand_raws(fb, k * n, 51).reshape(k, n)
    ta, tb = from_raw(A, fa), from_raw(B, fb)
    plan = _taken(ta, tb, out, **kw)
    assert plan is not None
    got = gemm.qgemul(ta, tb, out, **kw)
    ho = hostops.qgemul(
        [[(int(A[i, j]), fa) for j in range(k)] for i in range(m)],
        [[(int(B[i, j]), fb) for j in range(n)] for i in range(k)],
        out, kw["mul_to"], kw["add_formats"])
    g = np.asarray(got.raw(), dtype=object)
    assert all(int(g[i][j]) == ho[i][j][0]
               for i in range(m) for j in range(n))
