"""Complex GEMM integer-matmul fast path: lossless configs collapse to 4 (basic) /
3 (TF) integer matmuls; must match the general tree path bit-for-bit."""

import numpy as np
import pytest

from qublas_tpu.complex import complex_from_raw
from qublas_tpu.ops import cgemm as CG
from qublas_tpu.ops.cgemm import _fast_cgemul, cgemul
from qublas_tpu.qformat import OverflowMode, qformat

rng = np.random.RandomState(91)

F = qformat(3, 4)
WIDE = qformat(20, 8)
MID = qformat(5, 4)


def mat(shape, fr=F, fi=F):
    return complex_from_raw(rng.randint(fr.raw_min, fr.raw_max + 1, shape),
                            rng.randint(fi.raw_min, fi.raw_max + 1, shape),
                            fr, fi)


def general(a, b, out, **kw):
    orig = CG._fast_cgemul
    CG._fast_cgemul = lambda *a_, **k_: None
    try:
        return cgemul(a, b, out, **kw)
    finally:
        CG._fast_cgemul = orig


def assert_equal(x, y):
    np.testing.assert_array_equal(np.asarray(x.real.raw()),
                                  np.asarray(y.real.raw()))
    np.testing.assert_array_equal(np.asarray(x.imag.raw()),
                                  np.asarray(y.imag.raw()))
    assert x.real.fmt == y.real.fmt and x.imag.fmt == y.imag.fmt


BASIC_KW = dict(ac=WIDE, bd=WIDE, ad=WIDE, bc=WIDE, acbd=WIDE, adbc=WIDE)
TF_KW = dict(ab=MID, cd=MID, ba=MID, abc=WIDE, cdb=WIDE, bad=WIDE,
             AB=WIDE, BC=WIDE)


@pytest.mark.parametrize("algo", ["basic", "tf"])
@pytest.mark.parametrize("k", [1, 2, 5, 16, 33])
def test_fast_matches_general(algo, k):
    a, b = mat((4, k)), mat((k, 3))
    out = (qformat(18, 8), qformat(18, 8))
    fast = cgemul(a, b, out, algo=algo, add_formats=(WIDE,), **kw_for(algo))
    slow = general(a, b, out, algo=algo, add_formats=(WIDE,),
                   **kw_for(algo))
    assert_equal(fast, slow)
    # confirm the proof actually fired
    assert _fast_cgemul(a, b, out[0], out[1], algo, (WIDE,), (WIDE,),
                        kw_for(algo)) is not None


def kw_for(algo):
    return BASIC_KW if algo == "basic" else TF_KW


def test_mixed_part_formats():
    fr, fi = qformat(3, 4), qformat(2, 5)
    a, b = mat((3, 6), fr, fi), mat((6, 4), fr, fi)
    out = (qformat(18, 9), qformat(17, 9))
    fast = cgemul(a, b, out, algo="basic", add_formats=(WIDE,), **BASIC_KW)
    slow = general(a, b, out, algo="basic", add_formats=(WIDE,), **BASIC_KW)
    assert_equal(fast, slow)


def test_epilogue_saturation_allowed():
    """The final converting assignment may saturate — only the internal
    pipeline must be lossless."""
    narrow = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
              qformat(3, 4))
    a, b = mat((4, 8)), mat((8, 4))
    fast = cgemul(a, b, narrow, algo="basic", add_formats=(WIDE,),
                  **BASIC_KW)
    slow = general(a, b, narrow, algo="basic", add_formats=(WIDE,),
                   **BASIC_KW)
    assert_equal(fast, slow)


def test_lossy_configs_refuse_fast_path():
    f44 = qformat(4, 4)
    a, b = mat((3, 5), f44, f44), mat((5, 3), f44, f44)
    assert _fast_cgemul(a, b, f44, f44, "basic", (), (), {}) is None
    # default-inferred TF ba stage saturates -> refused
    assert _fast_cgemul(a, b, WIDE, WIDE, "tf", (WIDE,), (WIDE,),
                        dict(ab=WIDE, cd=WIDE, abc=WIDE, cdb=WIDE,
                             bad=WIDE, AB=WIDE, BC=WIDE)) is None


def test_batched_fast_path_matches_layered():
    """Batched complex GEMM takes the vmapped 3/4-matmul fast path when the
    proof holds; bits must equal the layered program (round-2 feature)."""
    import numpy as np

    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops.cgemm import cgemul
    from qublas_tpu.qformat import OverflowMode, qformat
    from qublas_tpu.qtensor import from_raw

    rng = np.random.RandomState(0)
    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    B, m, k, n = 3, 4, 8, 5

    def rq(shape):
        return from_raw(rng.randint(f.raw_min, f.raw_max + 1, shape), f)

    a = QComplexTensor(rq((B, m, k)), rq((B, m, k)))
    b = QComplexTensor(rq((B, k, n)), rq((B, k, n)))
    kw = dict(algo="tf", add_formats=(wide,), ab=mid, cd=mid, ba=mid,
              abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    got = cgemul(a, b, out, **kw)
    # per-batch 2-D reference (the already-verified single fast path)
    for i in range(B):
        one = cgemul(QComplexTensor(a.real[i], a.imag[i]),
                     QComplexTensor(b.real[i], b.imag[i]), out, **kw)
        np.testing.assert_array_equal(np.asarray(got.real.raw())[i],
                                      np.asarray(one.real.raw()))
        np.testing.assert_array_equal(np.asarray(got.imag.raw())[i],
                                      np.asarray(one.imag.raw()))
    # an order-sensitive config must still fall to the layered path
    f2 = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    a2 = QComplexTensor(
        from_raw(rng.randint(f2.raw_min, f2.raw_max + 1, (2, 3, 4)), f2),
        from_raw(rng.randint(f2.raw_min, f2.raw_max + 1, (2, 3, 4)), f2))
    b2 = QComplexTensor(
        from_raw(rng.randint(f2.raw_min, f2.raw_max + 1, (2, 4, 3)), f2),
        from_raw(rng.randint(f2.raw_min, f2.raw_max + 1, (2, 4, 3)), f2))
    got2 = cgemul(a2, b2, (f2, f2), algo="tf")
    for i in range(2):
        one2 = cgemul(QComplexTensor(a2.real[i], a2.imag[i]),
                      QComplexTensor(b2.real[i], b2.imag[i]), (f2, f2),
                      algo="tf")
        np.testing.assert_array_equal(np.asarray(got2.real.raw())[i],
                                      np.asarray(one2.real.raw()))
        np.testing.assert_array_equal(np.asarray(got2.imag.raw())[i],
                                      np.asarray(one2.imag.raw()))


def test_fast_path_preserves_wart_raws():
    """fill(int)-wart raws (legally out of the format's range, stored in a
    wider lane dtype) must survive the complex fast path's operand
    narrowing — an interval-based int16 downcast wrapped them (round-5
    review repro: 100000 in an int8-storage format wrapped to -31072 and
    the product diverged from the oracle)."""
    import numpy as np

    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops import cgemm as CG
    from qublas_tpu.ops.cgemm import cgemul
    from qublas_tpu.qformat import qformat
    from qublas_tpu.qtensor import from_raw

    f = qformat(3, 4)
    wide = qformat(40, 8)                  # roomy lossless steps
    out = (qformat(40, 8), qformat(40, 8))
    kw = dict(algo="basic", add_formats=(qformat(44, 8),),
              ac=wide, bd=wide, ad=wide, bc=wide,
              acbd=qformat(41, 8), adbc=qformat(41, 8))
    A = from_raw(np.full((2, 3), 100000), f)    # wart raw -> int32 lane
    B = from_raw(np.full((3, 2), 2), f)
    ca = QComplexTensor(A, from_raw(np.zeros((2, 3), dtype=int), f))
    cb = QComplexTensor(B, from_raw(np.zeros((3, 2), dtype=int), f))
    got = cgemul(ca, cb, out, **kw)
    with CG.force_fast_off():
        ref = cgemul(ca, cb, out, **kw)
    np.testing.assert_array_equal(np.asarray(got.real.raw()),
                                  np.asarray(ref.real.raw()))
    assert int(np.asarray(got.real.raw()).reshape(-1)[0]) == 600000
