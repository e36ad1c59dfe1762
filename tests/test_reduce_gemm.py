"""Device Qreduce / Qgemul / Qgemv vs the exact host golden model.

The host model is itself pinned to the C++ reference by the golden-vector
tests; these tests pin the *device* paths (i32 lanes, 64-bit pair emulation,
dot_general fast path, Pallas kernel) to the host model Δ=0.
"""

import numpy as np
import pytest

from qublas_tpu import hostops
from qublas_tpu.ops.gemm import exact_plan, qgemul, qgemv
from qublas_tpu.ops.reduce import qreduce
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import from_raw

rng = np.random.RandomState(42)


def rand_raws(fmt, shape):
    lo, hi = fmt.raw_min, fmt.raw_max
    return rng.randint(lo, hi + 1, size=shape)


F44 = qformat(4, 4)
F88 = qformat(8, 8)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
F30 = qformat(3, 0)


# ---------------------------------------------------------------------------
# Qreduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 16, 33])
@pytest.mark.parametrize("layers", [
    (),
    (qformat(4, 2),),
    (qformat(5, 3, round_mode=RoundMode.RND_CONV,
             overflow_mode=OverflowMode.SAT_ZERO), qformat(4, 1)),
])
def test_qreduce_matches_host(n, layers):
    vals = rand_raws(F44, n)
    dev = qreduce(from_raw(vals, F44), layers)
    host_raw, host_fmt = hostops.qreduce_list(
        [(int(v), F44) for v in vals], layers)
    assert int(dev.raw()) == host_raw
    assert dev.fmt == host_fmt


def test_qreduce_ndim_flattens_row_major():
    vals = rand_raws(F44, (3, 4))
    dev = qreduce(from_raw(vals, F44), (qformat(5, 2),))
    host_raw, host_fmt = hostops.qreduce_list(
        [(int(v), F44) for v in vals.reshape(-1)], (qformat(5, 2),))
    assert int(dev.raw()) == host_raw


def test_qreduce_axis_batched():
    vals = rand_raws(F44, (5, 6))
    dev = qreduce(from_raw(vals, F44), (qformat(5, 2),), axis=1)
    assert dev.shape == (5,)
    for i in range(5):
        host_raw, _ = hostops.qreduce_list(
            [(int(v), F44) for v in vals[i]], (qformat(5, 2),))
        assert int(dev.raw()[i]) == host_raw




def test_qreduce_wide_format_host_path():
    import random

    f = qformat(40, 40)
    pyrng = random.Random(99)
    vals = [pyrng.randint(-(1 << 70), 1 << 70) for _ in range(7)]
    dev = qreduce(from_raw(np.array(vals, dtype=object), f), ())
    host_raw, host_fmt = hostops.qreduce_list([(v, f) for v in vals], ())
    assert int(dev.raw()) == host_raw
    assert dev.fmt == host_fmt


# ---------------------------------------------------------------------------
# Qgemul — general (order-sensitive quantized accumulation)
# ---------------------------------------------------------------------------

def _host_gemm_ref(A, B, fa, fb, out_fmt, **kw):
    a_rows = [[(int(A[i, p]), fa) for p in range(A.shape[1])]
              for i in range(A.shape[0])]
    b_rows = [[(int(B[p, j]), fb) for j in range(B.shape[1])]
              for p in range(B.shape[0])]
    C = hostops.qgemul(a_rows, b_rows, out_fmt, **kw)
    return np.array([[c[0] for c in row] for row in C])


@pytest.mark.parametrize("mkn", [(1, 1, 1), (2, 3, 2), (4, 4, 4), (3, 7, 5)])
def test_qgemul_canonical_config(mkn):
    """BASELINE config 1: INT8 GEMM at Qu<8,8,TRN::TCPL,SAT::ZERO> — default
    (lossy) product quantization and accumulation."""
    m, k, n = mkn
    A, B = rand_raws(F88Z, (m, k)), rand_raws(F88Z, (k, n))
    dev = qgemul(from_raw(A, F88Z), from_raw(B, F88Z), F88Z)
    host = _host_gemm_ref(A, B, F88Z, F88Z, F88Z)
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64), host)
    assert dev.fmt == F88Z


def test_qgemul_per_layer_formats_and_mul_to():
    m, k, n = 3, 6, 4
    fa, fb = qformat(4, 4), qformat(4, 4)
    mul_to = qformat(5, 5, overflow_mode=OverflowMode.SAT_ZERO)
    layers = (qformat(6, 4, round_mode=RoundMode.RND_CONV), qformat(5, 2))
    out = qformat(6, 3)
    A, B = rand_raws(fa, (m, k)), rand_raws(fb, (k, n))
    dev = qgemul(from_raw(A, fa), from_raw(B, fb), out, mul_to=mul_to,
                 add_formats=layers)
    host = _host_gemm_ref(A, B, fa, fb, out, mul_to=mul_to,
                          add_formats=layers)
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64), host)


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
def test_qgemul_transposes(ta, tb):
    m, k, n = 3, 4, 2
    A = rand_raws(F44, (k, m) if ta else (m, k))
    B = rand_raws(F44, (n, k) if tb else (k, n))
    dev = qgemul(from_raw(A, F44), from_raw(B, F44), F44,
                 transpose_a=ta, transpose_b=tb)
    At = A.T if ta else A
    Bt = B.T if tb else B
    host = _host_gemm_ref(At, Bt, F44, F44, F44)
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64), host)


def test_qgemul_batched_matches_loop():
    fa = qformat(3, 4)  # 8-bit storage
    A, B = rand_raws(fa, (2, 3, 5)), rand_raws(fa, (2, 5, 4))
    out = qformat(6, 4)
    dev = qgemul(from_raw(A, fa), from_raw(B, fa), out)
    for i in range(2):
        host = _host_gemm_ref(A[i], B[i], fa, fa, out)
        np.testing.assert_array_equal(
            np.asarray(dev.raw()[i], dtype=np.int64), host)


# ---------------------------------------------------------------------------
# Qgemul — exact (integer-matmul) fast path
# ---------------------------------------------------------------------------

def test_exact_plan_triggers_for_lossless_config():
    fa = qformat(3, 4)  # int8 storage
    wide = qformat(20, 8)
    plan = exact_plan(fa, fa, wide, (wide,), k=16)
    assert plan is not None
    assert plan.prod_frac == 8
    assert plan.final_fmt == wide


def test_exact_plan_rejects_lossy_config():
    assert exact_plan(F88Z, F88Z, F88Z, (), k=4) is None


@pytest.mark.parametrize("k", [1, 3, 16])
def test_qgemul_fast_path_matches_host(k):
    fa = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(6, 4, overflow_mode=OverflowMode.SAT_ZERO,
                  round_mode=RoundMode.RND_CONV)
    A, B = rand_raws(fa, (4, k)), rand_raws(fa, (k, 3))
    dev = qgemul(from_raw(A, fa), from_raw(B, fa), out, mul_to=wide,
                 add_formats=(wide,))
    host = _host_gemm_ref(A, B, fa, fa, out, mul_to=wide, add_formats=(wide,))
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64), host)


def test_qgemul_full_prec_products():
    fa = qformat(3, 4)
    wide = qformat(22, 10)
    A, B = rand_raws(fa, (3, 9)), rand_raws(fa, (9, 3))
    dev = qgemul(from_raw(A, fa), from_raw(B, fa), qformat(6, 4),
                 mul_full_prec=True, add_formats=(wide,))
    host = _host_gemm_ref(A, B, fa, fa, qformat(6, 4), mul_full_prec=True,
                          add_formats=(wide,))
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64), host)


# ---------------------------------------------------------------------------
# Qgemv
# ---------------------------------------------------------------------------

def test_qgemv_matches_host():
    fa = qformat(4, 4)
    A, x = rand_raws(fa, (5, 7)), rand_raws(fa, 7)
    out = qformat(6, 4)
    dev = qgemv(from_raw(A, fa), from_raw(x, fa), out)
    a_rows = [[(int(A[i, p]), fa) for p in range(7)] for i in range(5)]
    x_vec = [(int(v), fa) for v in x]
    host = hostops.qgemv(a_rows, x_vec, out)
    np.testing.assert_array_equal(
        np.asarray(dev.raw(), dtype=np.int64),
        np.array([h[0] for h in host]))


def test_qgemul_wide_format_host_fallback():
    f = qformat(40, 40)
    A = np.array([[rng.randint(-(1 << 60), 1 << 60) for _ in range(3)]
                  for _ in range(2)], dtype=object)
    B = np.array([[rng.randint(-(1 << 60), 1 << 60) for _ in range(2)]
                  for _ in range(3)], dtype=object)
    dev = qgemul(from_raw(A, f), from_raw(B, f), f)
    host = _host_gemm_ref(A, B, f, f, f)
    assert (np.asarray(dev.raw(), dtype=object) == host).all()
