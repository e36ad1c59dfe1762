"""Sharded Qgemul on the virtual 8-device CPU mesh (conftest forces
xla_force_host_platform_device_count=8) — the standard JAX pattern for
testing collectives without a pod."""

import numpy as np
import pytest

import jax

from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.parallel import (
    make_mesh, shard_qgemul, sharded_qgemul_dp, sharded_qgemul_k,
    sharded_qgemul_mn,
)
from qublas_tpu.qformat import OverflowMode, qformat
from qublas_tpu.qtensor import from_raw

rng = np.random.RandomState(5)

F34 = qformat(3, 4)          # int8 storage
WIDE = qformat(20, 8)        # lossless accumulate
OUT = qformat(6, 4, overflow_mode=OverflowMode.SAT_ZERO)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)


def rand(fmt, shape):
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape)


def test_mesh_shapes():
    mesh = make_mesh(dp=2, tp=4)
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert len(jax.devices()) == 8


def test_k_sharded_exact_config_matches_single_chip():
    mesh = make_mesh(dp=1, tp=8)
    m, k, n = 16, 64, 24
    a = from_raw(rand(F34, (m, k)), F34)
    b = from_raw(rand(F34, (k, n)), F34)
    ref = qgemul(a, b, OUT, mul_to=WIDE, add_formats=(WIDE,))
    out = sharded_qgemul_k(a, b, OUT, mesh, mul_to=WIDE, add_formats=(WIDE,))
    np.testing.assert_array_equal(np.asarray(out.raw()), np.asarray(ref.raw()))


def test_k_sharded_reduce_scatter_matches():
    mesh = make_mesh(dp=1, tp=8)
    m, k, n = 8, 32, 16  # n divisible by tp for the scatter
    a = from_raw(rand(F34, (m, k)), F34)
    b = from_raw(rand(F34, (k, n)), F34)
    ref = qgemul(a, b, OUT, mul_to=WIDE, add_formats=(WIDE,))
    out = sharded_qgemul_k(a, b, OUT, mesh, mul_to=WIDE,
                           add_formats=(WIDE,), reduce_scatter=True)
    np.testing.assert_array_equal(np.asarray(out.raw()), np.asarray(ref.raw()))


def test_k_sharded_pipelined_matches_single_chip():
    """Decomposed reduce-scatter matmul (ppermute-pipelined transfer overlap)
    must be bit-identical to the single-chip result."""
    from qublas_tpu.parallel import sharded_qgemul_k_pipelined

    mesh = make_mesh(dp=1, tp=8)
    m, k, n = 16, 64, 32
    a = from_raw(rand(F34, (m, k)), F34)
    b = from_raw(rand(F34, (k, n)), F34)
    ref = qgemul(a, b, OUT, mul_to=WIDE, add_formats=(WIDE,))
    out = sharded_qgemul_k_pipelined(a, b, OUT, mesh, mul_to=WIDE,
                                     add_formats=(WIDE,))
    np.testing.assert_array_equal(np.asarray(out.raw()), np.asarray(ref.raw()))


def test_k_sharded_rejects_order_sensitive_config():
    mesh = make_mesh(dp=1, tp=8)
    a = from_raw(rand(F88Z, (4, 16)), F88Z)
    b = from_raw(rand(F88Z, (16, 4)), F88Z)
    with pytest.raises(ValueError, match="order-sensitive|lossless"):
        sharded_qgemul_k(a, b, F88Z, mesh)


def test_mn_sharded_quantized_accumulation_bit_exact():
    """The order-sensitive canonical config is bit-exact under M/N sharding."""
    mesh = make_mesh(dp=2, tp=4)
    m, k, n = 8, 8, 8
    a = from_raw(rand(F88Z, (m, k)), F88Z)
    b = from_raw(rand(F88Z, (k, n)), F88Z)
    ref = qgemul(a, b, F88Z)
    out = sharded_qgemul_mn(a, b, F88Z, mesh)
    np.testing.assert_array_equal(np.asarray(out.raw()), np.asarray(ref.raw()))


def test_dp_batched_streaming():
    mesh = make_mesh(dp=2, tp=4)
    a = from_raw(rand(F34, (8, 4, 16)), F34)
    b = from_raw(rand(F34, (8, 16, 4)), F34)
    ref = qgemul(a, b, OUT, mul_to=WIDE, add_formats=(WIDE,))
    out = sharded_qgemul_dp(a, b, OUT, mesh, mul_to=WIDE, add_formats=(WIDE,))
    np.testing.assert_array_equal(np.asarray(out.raw()), np.asarray(ref.raw()))


def test_auto_strategy_dispatch():
    mesh = make_mesh(dp=1, tp=8)
    # lossless config -> k strategy works through the front door
    a = from_raw(rand(F34, (8, 64)), F34)
    b = from_raw(rand(F34, (64, 8)), F34)
    ref = qgemul(a, b, OUT, mul_to=WIDE, add_formats=(WIDE,))
    out = shard_qgemul(a, b, OUT, mesh, mul_to=WIDE, add_formats=(WIDE,))
    np.testing.assert_array_equal(np.asarray(out.raw()), np.asarray(ref.raw()))
    # lossy config -> auto falls back to mn
    a2 = from_raw(rand(F88Z, (8, 8)), F88Z)
    b2 = from_raw(rand(F88Z, (8, 8)), F88Z)
    ref2 = qgemul(a2, b2, F88Z)
    out2 = shard_qgemul(a2, b2, F88Z, mesh)
    np.testing.assert_array_equal(np.asarray(out2.raw()),
                                  np.asarray(ref2.raw()))
