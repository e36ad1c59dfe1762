"""Round-2 sharding extensions: sharded complex GEMM, sharded Qreduce, and
the ANUS LUT riding the K strategies (VERDICT item 6).

All cases assert bit-identity with the single-chip path on the virtual
8-device CPU mesh (conftest forces cpu + 8 devices).
"""

import numpy as np
import pytest

import jax

from qublas_tpu import anus
from qublas_tpu.complex import QComplexTensor
from qublas_tpu.ops.cgemm import cgemul
from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.ops.reduce import qreduce
from qublas_tpu.parallel import (
    make_mesh,
    sharded_cgemul,
    sharded_cgemul_k,
    sharded_cgemul_mn,
    sharded_qgemul_k,
    sharded_qgemul_k_pipelined,
    sharded_qreduce,
    sharded_qreduce_k,
)
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import QTensor, from_raw

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the virtual 8-device mesh")


def mesh22():
    return make_mesh(dp=2, tp=4)


def rand_q(shape, fmt, seed):
    rng = np.random.RandomState(seed)
    return from_raw(rng.randint(fmt.raw_min, fmt.raw_max + 1, shape), fmt)


def assert_q_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.raw()), np.asarray(b.raw()))
    assert a.fmt == b.fmt


# ---------------------------------------------------------------------------
# LUT through the K strategies
# ---------------------------------------------------------------------------

def test_lut_through_k_psum():
    f = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = anus.build_table(anus.sqrt_func, out, qformat(4, 3))
    mesh = mesh22()
    a = rand_q((8, 16), f, 0)
    b = rand_q((16, 12), f, 1)
    y = sharded_qgemul_k(a, b, out, mesh, mul_to=wide, add_formats=(wide,),
                         epilogue_lut=table)
    ref = qgemul(a, b, out, mul_to=wide, add_formats=(wide,),
                 epilogue_lut=table, use_pallas=False)
    assert_q_equal(y, ref)
    assert y.fmt == table.out_fmt


def test_lut_through_k_reduce_scatter_and_pipelined():
    f = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = anus.build_table(anus.reciprocal_func, out, out)
    mesh = mesh22()
    a = rand_q((4, 8), f, 2)
    b = rand_q((8, 8), f, 3)
    ref = qgemul(a, b, out, mul_to=wide, add_formats=(wide,),
                 epilogue_lut=table, use_pallas=False)
    y_rs = sharded_qgemul_k(a, b, out, mesh, mul_to=wide,
                            add_formats=(wide,), reduce_scatter=True,
                            epilogue_lut=table)
    assert_q_equal(y_rs, ref)
    y_pl = sharded_qgemul_k_pipelined(a, b, out, mesh, mul_to=wide,
                                      add_formats=(wide,),
                                      epilogue_lut=table)
    assert_q_equal(y_pl, ref)


# ---------------------------------------------------------------------------
# Sharded complex GEMM
# ---------------------------------------------------------------------------

def _complex_operands(m, k, n, f, seeds):
    return (QComplexTensor(rand_q((m, k), f, seeds[0]),
                           rand_q((m, k), f, seeds[1])),
            QComplexTensor(rand_q((k, n), f, seeds[2]),
                           rand_q((k, n), f, seeds[3])))


def test_sharded_cgemul_mn_order_sensitive():
    """mn sharding must stay bit-exact even for rounding/saturating
    configs (order-sensitive accumulation)."""
    f = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    out = (qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO),
           qformat(5, 3, round_mode=RoundMode.RND_CONV))
    a, b = _complex_operands(4, 6, 8, f, (10, 11, 12, 13))
    mesh = mesh22()
    y = sharded_cgemul_mn(a, b, out, mesh, algo="tf",
                          add_formats=(qformat(6, 4),))
    ref = cgemul(a, b, out, algo="tf", add_formats=(qformat(6, 4),))
    assert_q_equal(y.real, ref.real)
    assert_q_equal(y.imag, ref.imag)


def test_sharded_cgemul_mn_basic_inferred_formats():
    f = qformat(3, 4)
    a, b = _complex_operands(4, 4, 8, f, (20, 21, 22, 23))
    mesh = mesh22()
    wide = qformat(20, 8)
    out = (qformat(5, 4), qformat(5, 4))
    y = sharded_cgemul_mn(a, b, out, mesh, algo="basic",
                          add_formats=(wide,),
                          ac=wide, bd=wide, ad=wide, bc=wide,
                          acbd=wide, adbc=wide)
    ref = cgemul(a, b, out, algo="basic", add_formats=(wide,),
                 ac=wide, bd=wide, ad=wide, bc=wide, acbd=wide, adbc=wide)
    assert_q_equal(y.real, ref.real)
    assert_q_equal(y.imag, ref.imag)


def test_sharded_cgemul_k_tf_lossless():
    """K-sharded TF complex GEMM under the lossless proof: partial dots
    psum over the mesh, bit-identical to single-chip."""
    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
           qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO))
    a, b = _complex_operands(4, 16, 8, f, (30, 31, 32, 33))
    mesh = mesh22()
    kw = dict(algo="tf", add_formats=(wide,), ab=mid, cd=mid, ba=mid,
              abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    y = sharded_cgemul_k(a, b, out, mesh, **kw)
    ref = cgemul(a, b, out, **kw)
    assert_q_equal(y.real, ref.real)
    assert_q_equal(y.imag, ref.imag)


def test_sharded_cgemul_k_basic_lossless():
    f = qformat(3, 4)
    wide = qformat(22, 8)
    out = (qformat(22, 8), qformat(22, 8))
    a, b = _complex_operands(3, 8, 5, f, (40, 41, 42, 43))
    mesh = mesh22()
    kw = dict(algo="basic", add_formats=(wide,),
              ac=wide, bd=wide, ad=wide, bc=wide, acbd=wide, adbc=wide)
    y = sharded_cgemul_k(a, b, out, mesh, **kw)
    ref = cgemul(a, b, out, **kw)
    assert_q_equal(y.real, ref.real)
    assert_q_equal(y.imag, ref.imag)


def test_sharded_cgemul_k_rejects_lossy():
    f = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    a, b = _complex_operands(4, 8, 4, f, (50, 51, 52, 53))
    mesh = mesh22()
    with pytest.raises(ValueError):
        sharded_cgemul_k(a, b, (f, f), mesh, algo="tf")


def test_sharded_cgemul_auto_picks():
    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    a, b = _complex_operands(4, 16, 8, f, (60, 61, 62, 63))
    mesh = mesh22()
    kw = dict(algo="tf", add_formats=(wide,), ab=mid, cd=mid, ba=mid,
              abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    y = sharded_cgemul(a, b, out, mesh, **kw)
    ref = cgemul(a, b, out, **kw)
    assert_q_equal(y.real, ref.real)
    # lossy config falls back to mn
    f2 = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    a2, b2 = _complex_operands(4, 8, 8, f2, (70, 71, 72, 73))
    y2 = sharded_cgemul(a2, b2, (f2, f2), mesh, algo="tf")
    ref2 = cgemul(a2, b2, (f2, f2), algo="tf")
    assert_q_equal(y2.real, ref2.real)
    assert_q_equal(y2.imag, ref2.imag)


def test_sharded_cgemul_auto_unaligned_batch():
    """auto on a batched input whose batch is NOT divisible by the device
    count must not raise (ADVICE r4): it loops the 2D auto path per batch
    element and stacks."""
    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    kw = dict(algo="tf", add_formats=(wide,), ab=mid, cd=mid, ba=mid,
              abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    mesh = mesh22()
    rng = np.random.RandomState(7)

    def rq(shape, seed):
        r = np.random.RandomState(seed)
        return from_raw(r.randint(f.raw_min, f.raw_max + 1, shape), f)

    a = QComplexTensor(rq((3, 4, 16), 80), rq((3, 4, 16), 81))
    b = QComplexTensor(rq((3, 16, 8), 82), rq((3, 16, 8), 83))
    y = sharded_cgemul(a, b, out, mesh, **kw)
    ref = cgemul(a, b, out, **kw)
    assert_q_equal(y.real, ref.real)
    assert_q_equal(y.imag, ref.imag)
    # 2D b (shared across batch) through the same fallback
    b2 = QComplexTensor(rq((16, 8), 84), rq((16, 8), 85))
    y2 = sharded_cgemul(a, b2, out, mesh, **kw)
    ref2 = cgemul(a, b2, out, **kw)
    assert_q_equal(y2.real, ref2.real)
    assert_q_equal(y2.imag, ref2.imag)


# ---------------------------------------------------------------------------
# Sharded Qreduce
# ---------------------------------------------------------------------------

def test_sharded_qreduce_batch():
    """Batch-sharded reduction: order-sensitive layer formats stay exact
    (each lane's full tree on one chip)."""
    f = qformat(4, 4)
    layers = (qformat(5, 3, round_mode=RoundMode.RND_CONV,
                      overflow_mode=OverflowMode.SAT_ZERO), qformat(6, 2))
    x = rand_q((16, 21), f, 80)  # odd reduce length exercises tail rule
    mesh = mesh22()
    y = sharded_qreduce(x, layers, axis=1, mesh=mesh)
    ref = qreduce(x, layers, axis=1)
    assert_q_equal(y, ref)


def test_sharded_qreduce_batch_axis0_reduce():
    f = qformat(4, 4)
    x = rand_q((8, 16), f, 81)
    mesh = mesh22()
    y = sharded_qreduce(x, (qformat(8, 4),), axis=0, mesh=mesh,
                        batch_axis=1)
    ref = qreduce(x, (qformat(8, 4),), axis=0)
    assert_q_equal(y, ref)


def test_sharded_qreduce_k_lossless():
    f = qformat(3, 4)
    layers = (qformat(20, 4),)  # wide enough: provably lossless
    x = rand_q((64,), f, 82)
    mesh = mesh22()
    y = sharded_qreduce_k(x, layers, mesh=mesh)
    ref = qreduce(x, layers)
    assert_q_equal(y, ref)


def test_sharded_qreduce_k_rejects_lossy():
    f = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    x = rand_q((64,), f, 83)
    mesh = mesh22()
    with pytest.raises(ValueError):
        sharded_qreduce_k(x, (f,), mesh=mesh)  # saturating layers


def test_sharded_qreduce_wrong_divisibility():
    f = qformat(3, 4)
    mesh = mesh22()
    with pytest.raises(ValueError):
        sharded_qreduce(rand_q((10, 8), f, 84), (), axis=1, mesh=mesh)
    with pytest.raises(ValueError):
        sharded_qreduce_k(rand_q((30,), f, 85), (qformat(20, 4),),
                          mesh=mesh)
