"""Limb-domain K-sharding (round 4, VERDICT r3 item 1).

Proof-lossless dots beyond the 64-bit pair domain sharded over the
contraction dim: per-chip balanced-digit int8 partial dots recombined
into stacked uint32 limbs, carry-correct psum of 2·Kw 16-bit limb columns
over the mesh, limb requantize epilogue after the collective.  Every case
must be bit-exact vs the single-chip path — the losslessness proof makes
every association/distribution order produce identical bits, so these tests
pin the collective limb arithmetic.
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
    rng = random.Random(f"kl:{seed}:{fmt.storage_bits}:{n}")
    return np.array([rng.randint(fmt.raw_min, fmt.raw_max)
                     for _ in range(n)], dtype=object)


def _assert_same(got, ref):
    assert got.fmt == ref.fmt
    g = np.asarray(got.raw(), dtype=object)
    w = np.asarray(ref.raw(), dtype=object)
    assert g.shape == w.shape
    assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)]


# 40-bit x 40-bit operands: 80-bit products — beyond the pair domain
WIDE_KW = dict(mul_to=qformat(51, 30), add_formats=(qformat(57, 30),))
F40 = qformat(25, 15)


def test_k_limb_wide_pair_operands_limb_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    out = qformat(60, 20, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_TCPL)   # limb storage
    m, k, n = 3, 16, 2
    ta = from_raw(rand_raws(F40, m * k, 1).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 2).reshape(k, n), F40)
    assert ta.is_pair
    got = sharded_qgemul_k_limb(ta, tb, out, mesh, **WIDE_KW)
    assert got.is_limb
    _assert_same(got, qgemul(ta, tb, out, **WIDE_KW))


def test_k_limb_limb_operand_lane_out_reduce_scatter():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    fa = qformat(40, 30)   # 70-bit limb storage
    fb = qformat(10, 8)
    out = qformat(30, 10, overflow_mode=OverflowMode.SAT_ZERO)
    kw = dict(mul_to=qformat(51, 38), add_formats=(qformat(57, 38),))
    m, k, n = 2, 16, 8
    ta = from_raw(rand_raws(fa, m * k, 3).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 4).reshape(k, n), fb)
    assert ta.is_limb
    got = sharded_qgemul_k_limb(ta, tb, out, mesh, reduce_scatter=True,
                                **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))
    got2 = sharded_qgemul_k_limb(ta, tb, out, mesh, **kw)
    _assert_same(got2, qgemul(ta, tb, out, **kw))


def test_k_limb_pair_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    out = qformat(40, 20, round_mode=RoundMode.RND_NEG_INF,
                  overflow_mode=OverflowMode.SAT_TCPL)   # pair storage
    m, k, n = 2, 8, 3
    ta = from_raw(rand_raws(F40, m * k, 5).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 6).reshape(k, n), F40)
    got = sharded_qgemul_k_limb(ta, tb, out, mesh, **WIDE_KW)
    assert got.is_pair
    _assert_same(got, qgemul(ta, tb, out, **WIDE_KW))


def test_k_limb_epilogue_lut():
    mesh = _mesh_or_skip()
    from qublas_tpu.anus import build_table, sqrt_func
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = build_table(sqrt_func, out, out)
    m, k, n = 2, 8, 3
    ta = from_raw(rand_raws(F40, m * k, 7).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 8).reshape(k, n), F40)
    got = sharded_qgemul_k_limb(ta, tb, out, mesh, epilogue_lut=table,
                                **WIDE_KW)
    _assert_same(got, qgemul(ta, tb, out, epilogue_lut=table, **WIDE_KW))


def test_k_limb_wrp_tcpl_sat_epilogue():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    out = qformat(24, 8, round_mode=RoundMode.TRN_SMGN,
                  overflow_mode=OverflowMode.WRP_TCPL_SAT)
    m, k, n = 2, 8, 3
    ta = from_raw(rand_raws(F40, m * k, 9).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 10).reshape(k, n), F40)
    got = sharded_qgemul_k_limb(ta, tb, out, mesh, **WIDE_KW)
    _assert_same(got, qgemul(ta, tb, out, **WIDE_KW))


def test_k_limb_auto_routing():
    """shard_qgemul auto picks k_limb when the dot is lossless but beyond
    the pair domain (k and k_wide both ineligible)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import shard_qgemul
    from qublas_tpu.parallel.sharding import _k_limb_plan, _k_wide_plan

    out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    m, k, n = 2, 16, 3
    ta = from_raw(rand_raws(F40, m * k, 11).reshape(m, k), F40)
    tb = from_raw(rand_raws(F40, k * n, 12).reshape(k, n), F40)
    assert _k_wide_plan(ta, tb, out, WIDE_KW["mul_to"],
                        WIDE_KW["add_formats"], False, 4) is None
    assert _k_limb_plan(ta, tb, out, WIDE_KW["mul_to"],
                        WIDE_KW["add_formats"], False, 4) is not None
    got = shard_qgemul(ta, tb, out, mesh, strategy="auto", **WIDE_KW)
    _assert_same(got, qgemul(ta, tb, out, **WIDE_KW))
    got2 = shard_qgemul(ta, tb, out, mesh, strategy="k_limb", **WIDE_KW)
    _assert_same(got2, qgemul(ta, tb, out, **WIDE_KW))


def test_k_limb_rejects_order_sensitive():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    f = qformat(25, 15)
    m, k, n = 2, 8, 2
    ta = from_raw(rand_raws(f, m * k, 13).reshape(m, k), f)
    tb = from_raw(rand_raws(f, k * n, 14).reshape(k, n), f)
    with pytest.raises(ValueError, match="strategy='mn'"):
        # out == operand fmt: the tree saturates -> no lossless proof
        sharded_qgemul_k_limb(ta, tb, f, mesh)


def test_k_limb_rejects_bad_k():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb

    out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    ta = from_raw(rand_raws(F40, 2 * 6, 15).reshape(2, 6), F40)
    tb = from_raw(rand_raws(F40, 6 * 2, 16).reshape(6, 2), F40)
    with pytest.raises(ValueError):
        sharded_qgemul_k_limb(ta, tb, out, mesh, **WIDE_KW)  # 6 % 4 != 0


@pytest.mark.parametrize("trial", range(4))
def test_k_limb_fuzz(trial):
    """Random lossless beyond-64-bit configs vs the single-chip bits."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_qgemul_k_limb
    from qublas_tpu.parallel.sharding import _k_limb_plan

    rng = np.random.RandomState(7100 + trial)
    fa = qformat(int(rng.randint(20, 34)), int(rng.randint(8, 20)))
    fb = qformat(int(rng.randint(20, 34)), int(rng.randint(8, 20)))
    pf = fa.frac_bits + fb.frac_bits
    k = int(rng.choice([8, 16, 32]))
    mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf)
    layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 2, pf),)
    out = qformat(int(rng.randint(20, 50)), int(rng.randint(0, 12)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(int(rng.choice([0, 1, 2, 3]))))
    m, n = 2, 3
    ta = from_raw(rand_raws(fa, m * k, 500 + trial).reshape(m, k), fa)
    tb = from_raw(rand_raws(fb, k * n, 600 + trial).reshape(k, n), fb)
    kw = dict(mul_to=mul_to, add_formats=layers)
    got_plan = _k_limb_plan(ta, tb, out, mul_to, layers, False, 4)
    if got_plan is None:
        pytest.skip("config not in the limb-K regime")
    if got_plan[0].dot_interval.fits64:
        pytest.skip("pair-domain config (k_wide territory)")
    got = sharded_qgemul_k_limb(ta, tb, out, mesh, **kw)
    _assert_same(got, qgemul(ta, tb, out, **kw))


def test_psum_tp_bound_guard():
    """tp >= 2^15 must be refused before entering the wide/limb path
    (carry-correct column psum soundness bound, ADVICE r3)."""
    from qublas_tpu.parallel.sharding import _PSUM_COLS_MAX_TP, _check_psum_tp

    class FakeMesh:
        shape = {"tp": _PSUM_COLS_MAX_TP}

    with pytest.raises(ValueError, match="2\\^15"):
        _check_psum_tp(FakeMesh())


def test_auto_prefers_k_limb_over_k_wide():
    """Late-round-4 auto reorder: for a proof-lossless dot past int32 that
    BOTH wide strategies admit, the auto probe picks k_limb (its per-chip
    partial dots are the balanced-digit int8 dots, preferred over the
    pair-domain dots k_wide runs)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import shard_qgemul
    from qublas_tpu.parallel.sharding import _k_limb_plan, _k_wide_plan

    fa = qformat(13, 0)
    out = qformat(25, 0)
    kw = dict(mul_to=qformat(27, 0), add_formats=(qformat(40, 0),))
    m, k, n = 4, 96, 4
    ta = from_raw(rand_raws(fa, m * k, 11).reshape(m, k), fa)
    tb = from_raw(rand_raws(fa, k * n, 12).reshape(k, n), fa)

    # the overlap is real: both plans admit the config at tp=4
    assert _k_wide_plan(ta, tb, out, kw["mul_to"], kw["add_formats"],
                        False, 4) is not None
    assert _k_limb_plan(ta, tb, out, kw["mul_to"], kw["add_formats"],
                        False, 4) is not None

    # spy on the strategy runners: auto must route to k_limb, never k_wide
    from qublas_tpu.parallel import sharding as S

    taken = []
    orig_l, orig_w = S.sharded_qgemul_k_limb, S.sharded_qgemul_k_wide
    S.sharded_qgemul_k_limb = (
        lambda *a, **kk: taken.append("k_limb") or orig_l(*a, **kk))
    S.sharded_qgemul_k_wide = (
        lambda *a, **kk: taken.append("k_wide") or orig_w(*a, **kk))
    try:
        got = shard_qgemul(ta, tb, out, mesh, strategy="auto", **kw)
    finally:
        S.sharded_qgemul_k_limb = orig_l
        S.sharded_qgemul_k_wide = orig_w
    assert taken == ["k_limb"], taken
    ref = qgemul(ta, tb, out, **kw)
    _assert_same(got, ref)
