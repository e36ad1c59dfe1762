"""Wide-format K-sharding (round-3 item 8, VERDICT r2 missing-3).

Pair-domain partial dots per chip + carry-correct 16-bit-column psum over
the mesh + pair requantize epilogue after the collective.  Every case must
be bit-exact vs the single-chip path — the losslessness proof makes every
association/distribution order produce identical bits, so these tests pin
the collective arithmetic (not rounding behavior, which the proof forbids
before the epilogue).
"""

import random

import numpy as np
import pytest

import jax

from qublas_tpu import from_raw, qformat
from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.qformat import OverflowMode, RoundMode


def _mesh_or_skip():
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    from qublas_tpu.parallel import make_mesh

    return make_mesh(dp=2, tp=4)


def rand_raws(fmt, n, seed):
    rng = random.Random(f"kw:{seed}:{fmt.storage_bits}:{n}")
    return np.array([rng.randint(fmt.raw_min, fmt.raw_max)
                     for _ in range(n)], dtype=object)


def _assert_same(got, ref):
    assert got.fmt == ref.fmt
    g = np.asarray(got.raw(), dtype=object)
    w = np.asarray(ref.raw(), dtype=object)
    assert g.shape == w.shape
    assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)]


def test_k_wide_pair_operand_lane_out():
    """40-bit pair operand x int16 weights, K-sharded; int-lane output."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    fa = qformat(30, 9)            # pair storage
    fb = qformat(7, 8)             # int16 lane
    out = qformat(20, 6, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_ZERO)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 3, 16, 5
    ta = from_raw(rand_raws(fa, m * k, 1).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 2).reshape(k, n), fb)
    assert ta.is_pair
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_k_wide_pair_out():
    """Pair-storage OUTPUT: epilogue runs requantize_pair_keep after the
    collective."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    fa = qformat(30, 9)
    fb = qformat(8, 8)
    out = qformat(36, 10, round_mode=RoundMode.RND_POS_INF,
                  overflow_mode=OverflowMode.SAT_TCPL)   # 47-bit: pair
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 2, 8, 3
    ta = from_raw(rand_raws(fa, m * k, 3).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 4).reshape(k, n), fb)
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, **kw)
    assert got.is_pair
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_k_wide_lane_segment_path():
    """Lane operands whose products fit int32 but whose dot does not:
    the matmul segment-dot decomposition.  (13,0) raws -> |prod| <= 2^26, so
    segments of ~32 accumulate exactly in int32 while the k=64 dot needs
    the 64-bit domain."""
    mesh = _mesh_or_skip()
    from qublas_tpu.ops.gemm import exact_plan
    from qublas_tpu.parallel import sharded_qgemul_k_wide
    from qublas_tpu.qformat import mul_merge

    fa = qformat(13, 0)
    out = qformat(25, 0, overflow_mode=OverflowMode.SAT_TCPL)
    kw = dict(mul_to=qformat(27, 0), add_formats=(qformat(33, 0),))
    m, k, n = 4, 64, 4
    plan = exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                      kw["add_formats"], k)
    assert plan is not None and not plan.dot_interval.fits32 \
        and plan.dot_interval.fits64
    ta = from_raw(rand_raws(fa, m * k, 5).reshape(m, k), fa)
    tb = from_raw(rand_raws(fa, k * n, 6).reshape(k, n), fa)
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_k_wide_reduce_scatter():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    fa = qformat(30, 9)
    fb = qformat(7, 8)
    out = qformat(22, 4, round_mode=RoundMode.TRN_SMGN,
                  overflow_mode=OverflowMode.SAT_SMGN)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 2, 16, 8
    ta = from_raw(rand_raws(fa, m * k, 7).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 8).reshape(k, n), fb)
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, reduce_scatter=True,
                                **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_k_wide_epilogue_lut():
    mesh = _mesh_or_skip()
    from qublas_tpu.anus import build_table, sqrt_func
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    fa = qformat(30, 9)
    fb = qformat(7, 8)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = build_table(sqrt_func, out, out)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 2, 8, 3
    ta = from_raw(rand_raws(fa, m * k, 9).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 10).reshape(k, n), fb)
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, epilogue_lut=table,
                                **kw)
    _assert_same(got, qgemul(ta, tb, out, epilogue_lut=table, **kw))


def test_k_wide_auto_routing():
    """shard_qgemul auto picks k_wide when the dot is lossless-but-wide."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import shard_qgemul
    from qublas_tpu.parallel.sharding import _k_wide_plan

    fa = qformat(30, 9)
    fb = qformat(7, 8)
    out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 2, 16, 3
    ta = from_raw(rand_raws(fa, m * k, 11).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 12).reshape(k, n), fb)
    assert _k_wide_plan(ta, tb, out, kw["mul_to"], kw["add_formats"],
                        False, 4) is not None
    got = shard_qgemul(ta, tb, out, mesh, strategy="auto", **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))
    got2 = shard_qgemul(ta, tb, out, mesh, strategy="k_wide", **kw)
    _assert_same(got2, qgemul(ta, tb, out, **kw))


def test_k_wide_rejects_order_sensitive():
    """A saturating tree (order-sensitive) must refuse K distribution."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    f = qformat(30, 9)
    m, k, n = 2, 8, 2
    ta = from_raw(rand_raws(f, m * k, 13).reshape(m, k), f)
    tb = from_raw(rand_raws(f, k * n, 14).reshape(k, n), f)
    with pytest.raises(ValueError, match="strategy='mn'"):
        # out == operand fmt: the tree saturates -> no lossless proof
        sharded_qgemul_k_wide(ta, tb, f, mesh)


def test_k_wide_rejects_bad_k():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    fa = qformat(30, 9)
    fb = qformat(7, 8)
    out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    ta = from_raw(rand_raws(fa, 2 * 6, 15).reshape(2, 6), fa)
    tb = from_raw(rand_raws(fb, 6 * 2, 16).reshape(6, 2), fb)
    with pytest.raises(ValueError):
        sharded_qgemul_k_wide(ta, tb, out, mesh, **kw)   # 6 % 4 != 0


@pytest.mark.parametrize("trial", range(6))
def test_k_wide_fuzz(trial):
    """Random lossless wide-dot configs vs the single-chip bits."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide
    from qublas_tpu.parallel.sharding import _k_wide_plan

    rng = np.random.RandomState(1000 + trial)
    fa = qformat(int(rng.randint(20, 31)), int(rng.randint(0, 7)))
    fb = qformat(int(rng.randint(4, 9)), int(rng.randint(0, 7)))
    out = qformat(int(rng.randint(10, 25)), int(rng.randint(0, 6)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(
                      int(rng.choice([0, 1, 2, 3]))))
    k = int(rng.choice([8, 16, 32]))
    pf = fa.frac_bits + fb.frac_bits
    mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf)
    layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 1, pf),)
    m, n = 2, 3
    if _k_wide_plan(from_raw(np.zeros((m, k), dtype=object), fa),
                    from_raw(np.zeros((k, n), dtype=object), fb),
                    out, mul_to, layers, False, 4) is None:
        pytest.skip("config not in the wide-K regime")
    ta = from_raw(rand_raws(fa, m * k, 100 + trial).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 200 + trial).reshape(k, n), fb)
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, mul_to=mul_to,
                                add_formats=layers)
    _assert_same(got, qgemul(ta, tb, out, mul_to=mul_to,
                             add_formats=layers))


def test_k_wide_wrp_tcpl_sat_epilogue():
    """WRP_TCPL_SAT output through the sharded wide-K epilogue."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide

    fa = qformat(30, 9)
    fb = qformat(7, 8)
    out = qformat(20, 6, overflow_mode=OverflowMode.WRP_TCPL_SAT)
    kw = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
    m, k, n = 2, 16, 3
    ta = from_raw(rand_raws(fa, m * k, 60).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 61).reshape(k, n), fb)
    got = sharded_qgemul_k_wide(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_qreduce_k_wide_lane_values():
    """Reduction-axis-sharded Qreduce whose lossless sum outgrows int32:
    per-chip pair sums + carry-correct psum (round 3)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.ops.reduce import qreduce
    from qublas_tpu.parallel import sharded_qreduce_k

    f = qformat(28, 0)                   # int32 lane values
    layers = (qformat(36, 0),)           # lossless layers; sum <= 2^33
    n = 32
    x = from_raw(rand_raws(f, n, 70), f)
    got = sharded_qreduce_k(x, layers, mesh=mesh)
    ref = qreduce(x, layers)
    assert got.fmt == ref.fmt
    assert int(np.asarray(got.raw(), dtype=object).reshape(())) == \
        int(np.asarray(ref.raw(), dtype=object).reshape(()))


def test_qreduce_k_wide_pair_values():
    mesh = _mesh_or_skip()
    from qublas_tpu.ops.reduce import qreduce
    from qublas_tpu.parallel import sharded_qreduce_k

    f = qformat(30, 9)                   # 40-bit pair values
    layers = (qformat(38, 9),)
    n = 32
    x = from_raw(rand_raws(f, n, 71), f)
    assert x.is_pair
    got = sharded_qreduce_k(x, layers, mesh=mesh)
    ref = qreduce(x, layers)
    assert got.fmt == ref.fmt and got.is_pair
    assert int(np.asarray(got.raw(), dtype=object).reshape(())) == \
        int(np.asarray(ref.raw(), dtype=object).reshape(()))


def test_qreduce_k_limb_values():
    """Round 4: limb-stored values through the K-sharded reduce (limb
    regime — previously rejected past the pair domain)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.ops.reduce import qreduce
    from qublas_tpu.parallel import sharded_qreduce_k

    f = qformat(40, 28)                  # limb-stored values
    layers = (qformat(75, 28),)
    x = from_raw(rand_raws(f, 8, 72), f)
    assert x.is_limb
    got = sharded_qreduce_k(x, layers, mesh=mesh)
    ref = qreduce(x, layers)
    assert got.fmt == ref.fmt and got.is_limb
    assert int(np.asarray(got.raw(), dtype=object).reshape(())) == \
        int(np.asarray(ref.raw(), dtype=object).reshape(()))


def test_qreduce_k_limb_pair_values_wide_sum():
    """Pair values whose lossless sum outgrows 64 bits: the limb regime
    takes over where the pair psum cannot."""
    mesh = _mesh_or_skip()
    from qublas_tpu.ops.reduce import qreduce
    from qublas_tpu.parallel import sharded_qreduce_k

    f = qformat(60, 0)
    layers = (qformat(66, 0),)
    x = from_raw(rand_raws(f, 32, 73), f)
    assert x.is_pair
    got = sharded_qreduce_k(x, layers, mesh=mesh)
    ref = qreduce(x, layers)
    assert got.fmt == ref.fmt
    assert int(np.asarray(got.raw(), dtype=object).reshape(())) == \
        int(np.asarray(ref.raw(), dtype=object).reshape(()))


def test_qreduce_k_rejects_host_wide():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qreduce_k

    f = qformat(1000, 0)                 # 1001-bit: host storage (round-4
    #                                      cap is 992; 301-bit became limb)
    x = from_raw(np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=object), f)
    with pytest.raises(ValueError):
        sharded_qreduce_k(x, (qformat(1100, 0),), mesh=mesh)
