"""Pipelined wide/limb K-sharding (round 4 follow-on).

The latency-hiding ring (``ppermute`` overlapping the next block's matmul
compute — the decomposed reduce-scatter matmul ``sharded_qgemul_k_pipelined``
runs for int32 dots) generalized to proof-lossless dots beyond int32:

* ``sharded_qgemul_k_wide_pipelined`` — pair-domain partial dots, exact
  mod-2^64 ``pair_add`` ring accumulation;
* ``sharded_qgemul_k_limb_pipelined`` — stacked-limb partial dots, exact
  mod-2^(32·Kw) ``ladd`` ring accumulation.

Every case must be bit-exact vs the single-chip path: the losslessness
proof makes every association/distribution order produce identical bits,
and ring intermediates are subset sums of ≤k products, so they stay inside
the proved domain.
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
    rng = random.Random(f"kpw:{seed}:{fmt.storage_bits}:{n}")
    return np.array([rng.randint(fmt.raw_min, fmt.raw_max)
                     for _ in range(n)], dtype=object)


def _assert_same(got, ref):
    assert got.fmt == ref.fmt
    g = np.asarray(got.raw(), dtype=object)
    w = np.asarray(ref.raw(), dtype=object)
    assert g.shape == w.shape
    assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)]


# pair-storage A (30,9) x int16-lane B: dot in the 64-bit pair domain
WKW = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
FA_W, FB_W = qformat(30, 9), qformat(7, 8)

# 40-bit x 40-bit operands: 80-bit products — beyond the pair domain
LKW = dict(mul_to=qformat(51, 30), add_formats=(qformat(57, 30),))
F40 = qformat(25, 15)


# ---------------------------------------------------------------------------
# wide (pair-domain) pipelined
# ---------------------------------------------------------------------------

def test_kwp_lane_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined

    out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    m, k, n = 4, 16, 8
    ta = from_raw(rand_raws(FA_W, m * k, 1).reshape(m, k), FA_W)
    tb = from_raw(rand_raws(FB_W, k * n, 2).reshape(k, n), FB_W)
    assert ta.is_pair
    got = sharded_qgemul_k_wide_pipelined(ta, tb, out, mesh, **WKW)
    _assert_same(got, qgemul(ta, tb, out, **WKW))


def test_kwp_pair_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined

    out = qformat(36, 10, round_mode=RoundMode.RND_POS_INF)
    m, k, n = 2, 16, 8
    ta = from_raw(rand_raws(FA_W, m * k, 3).reshape(m, k), FA_W)
    tb = from_raw(rand_raws(FB_W, k * n, 4).reshape(k, n), FB_W)
    got = sharded_qgemul_k_wide_pipelined(ta, tb, out, mesh, **WKW)
    assert got.is_pair
    _assert_same(got, qgemul(ta, tb, out, **WKW))


def test_kwp_lane_segment_path():
    """Lane operands, int32 products, >int32 dot: the matmul segment path
    inside each ring step."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined

    fa = qformat(13, 0)
    out = qformat(25, 0, overflow_mode=OverflowMode.SAT_TCPL)
    kw = dict(mul_to=qformat(27, 0), add_formats=(qformat(33, 0),))
    m, k, n = 4, 64, 8
    ta = from_raw(rand_raws(fa, m * k, 5).reshape(m, k), fa)
    tb = from_raw(rand_raws(fa, k * n, 6).reshape(k, n), fa)
    got = sharded_qgemul_k_wide_pipelined(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_kwp_epilogue_lut():
    mesh = _mesh_or_skip()
    from qublas_tpu.anus import build_table, sqrt_func
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined

    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = build_table(sqrt_func, out, out)
    m, k, n = 2, 8, 4
    ta = from_raw(rand_raws(FA_W, m * k, 7).reshape(m, k), FA_W)
    tb = from_raw(rand_raws(FB_W, k * n, 8).reshape(k, n), FB_W)
    got = sharded_qgemul_k_wide_pipelined(ta, tb, out, mesh,
                                          epilogue_lut=table, **WKW)
    _assert_same(got, qgemul(ta, tb, out, epilogue_lut=table, **WKW))


def test_kwp_strategy_dispatch():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import shard_qgemul

    out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    m, k, n = 2, 16, 4
    ta = from_raw(rand_raws(FA_W, m * k, 9).reshape(m, k), FA_W)
    tb = from_raw(rand_raws(FB_W, k * n, 10).reshape(k, n), FB_W)
    got = shard_qgemul(ta, tb, out, mesh, strategy="k_wide_pipelined",
                       **WKW)
    _assert_same(got, qgemul(ta, tb, out, **WKW))


def test_kwp_rejects_order_sensitive():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined

    f = qformat(30, 9)
    m, k, n = 2, 8, 4
    ta = from_raw(rand_raws(f, m * k, 11).reshape(m, k), f)
    tb = from_raw(rand_raws(f, k * n, 12).reshape(k, n), f)
    with pytest.raises(ValueError, match="strategy='mn'"):
        sharded_qgemul_k_wide_pipelined(ta, tb, f, mesh)


def test_kwp_rejects_bad_n():
    """N must divide tp (each ring step owns one N-block)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined

    out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    m, k, n = 2, 16, 3
    ta = from_raw(rand_raws(FA_W, m * k, 13).reshape(m, k), FA_W)
    tb = from_raw(rand_raws(FB_W, k * n, 14).reshape(k, n), FB_W)
    with pytest.raises(ValueError):
        sharded_qgemul_k_wide_pipelined(ta, tb, out, mesh, **WKW)


@pytest.mark.parametrize("trial", range(4))
def test_kwp_fuzz(trial):
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_wide_pipelined
    from qublas_tpu.parallel.sharding import _k_wide_plan

    rng = np.random.RandomState(8300 + trial)
    fa = qformat(int(rng.randint(20, 31)), int(rng.randint(0, 7)))
    fb = qformat(int(rng.randint(4, 9)), int(rng.randint(0, 7)))
    out = qformat(int(rng.randint(10, 25)), int(rng.randint(0, 6)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(int(rng.choice([0, 1, 2, 3]))))
    k = int(rng.choice([8, 16, 32]))
    pf = fa.frac_bits + fb.frac_bits
    mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf)
    layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 1, pf),)
    m, n = 2, 4
    if _k_wide_plan(from_raw(np.zeros((m, k), dtype=object), fa),
                    from_raw(np.zeros((k, n), dtype=object), fb),
                    out, mul_to, layers, False, 4) is None:
        pytest.skip("config not in the wide-K regime")
    ta = from_raw(rand_raws(fa, m * k, 300 + trial).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 400 + trial).reshape(k, n), fb)
    got = sharded_qgemul_k_wide_pipelined(ta, tb, out, mesh, mul_to=mul_to,
                                          add_formats=layers)
    _assert_same(got, qgemul(ta, tb, out, mul_to=mul_to,
                             add_formats=layers))


# ---------------------------------------------------------------------------
# limb-domain pipelined
# ---------------------------------------------------------------------------

def test_klp_limb_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined

    out = qformat(60, 20, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_TCPL)
    m, k, n = 3, 16, 8
    ta = from_raw(rand_raws(F40, m * k, 21).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 22).reshape(k, n), F40)
    assert ta.is_pair
    got = sharded_qgemul_k_limb_pipelined(ta, tb, out, mesh, **LKW)
    assert got.is_limb
    _assert_same(got, qgemul(ta, tb, out, **LKW))


def test_klp_limb_operand_lane_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined

    fa = qformat(40, 30)   # 70-bit limb storage
    fb = qformat(10, 8)
    out = qformat(30, 10, overflow_mode=OverflowMode.SAT_ZERO)
    kw = dict(mul_to=qformat(51, 38), add_formats=(qformat(57, 38),))
    m, k, n = 2, 16, 8
    ta = from_raw(rand_raws(fa, m * k, 23).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 24).reshape(k, n), fb)
    assert ta.is_limb
    got = sharded_qgemul_k_limb_pipelined(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_klp_pair_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined

    out = qformat(40, 20, round_mode=RoundMode.RND_NEG_INF,
                  overflow_mode=OverflowMode.SAT_TCPL)
    m, k, n = 2, 8, 4
    ta = from_raw(rand_raws(F40, m * k, 25).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 26).reshape(k, n), F40)
    got = sharded_qgemul_k_limb_pipelined(ta, tb, out, mesh, **LKW)
    assert got.is_pair
    _assert_same(got, qgemul(ta, tb, out, **LKW))


def test_klp_epilogue_lut():
    mesh = _mesh_or_skip()
    from qublas_tpu.anus import build_table, sqrt_func
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined

    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = build_table(sqrt_func, out, out)
    m, k, n = 2, 8, 4
    ta = from_raw(rand_raws(F40, m * k, 27).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 28).reshape(k, n), F40)
    got = sharded_qgemul_k_limb_pipelined(ta, tb, out, mesh,
                                          epilogue_lut=table, **LKW)
    _assert_same(got, qgemul(ta, tb, out, epilogue_lut=table, **LKW))


def test_klp_strategy_dispatch():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import shard_qgemul

    out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    m, k, n = 2, 16, 4
    ta = from_raw(rand_raws(F40, m * k, 29).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 30).reshape(k, n), F40)
    got = shard_qgemul(ta, tb, out, mesh, strategy="k_limb_pipelined",
                       **LKW)
    _assert_same(got, qgemul(ta, tb, out, **LKW))


def test_klp_rejects_order_sensitive():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined

    f = qformat(25, 15)
    m, k, n = 2, 8, 4
    ta = from_raw(rand_raws(f, m * k, 31).reshape(m, k), f)
    tb = from_raw(rand_raws(f, k * n, 32).reshape(k, n), f)
    with pytest.raises(ValueError, match="strategy='mn'"):
        sharded_qgemul_k_limb_pipelined(ta, tb, f, mesh)


def test_klp_rejects_bad_n():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined

    out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    m, k, n = 2, 16, 3
    ta = from_raw(rand_raws(F40, m * k, 33).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 34).reshape(k, n), F40)
    with pytest.raises(ValueError):
        sharded_qgemul_k_limb_pipelined(ta, tb, out, mesh, **LKW)


@pytest.mark.parametrize("trial", range(4))
def test_klp_fuzz(trial):
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb_pipelined
    from qublas_tpu.parallel.sharding import _k_limb_plan

    rng = np.random.RandomState(8400 + trial)
    fa = qformat(int(rng.randint(20, 34)), int(rng.randint(8, 20)))
    fb = qformat(int(rng.randint(20, 34)), int(rng.randint(8, 20)))
    pf = fa.frac_bits + fb.frac_bits
    k = int(rng.choice([8, 16, 32]))
    mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf)
    layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 2, pf),)
    out = qformat(int(rng.randint(20, 50)), int(rng.randint(0, 12)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(int(rng.choice([0, 1, 2, 3]))))
    m, n = 2, 4
    ta = from_raw(rand_raws(fa, m * k, 500 + trial).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 600 + trial).reshape(k, n), fb)
    kw = dict(mul_to=mul_to, add_formats=layers)
    got_plan = _k_limb_plan(ta, tb, out, mul_to, layers, False, 4)
    if got_plan is None:
        pytest.skip("config not in the limb-K regime")
    got = sharded_qgemul_k_limb_pipelined(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))
