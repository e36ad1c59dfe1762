"""End-to-end sharded deployment walkthrough.

Runs a quantized datapath — GEMM + ANUS ROM + complex GEMM + tree
reduction — across a device mesh with every sharding regime the library
provides, asserting each result bit-identical to the single-chip path.
On several GPUs the same code spans cards (tp over NVLink) and hosts
(dp over the network, after ``init_distributed``); here it runs anywhere
via the virtual-device escape hatch:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
    JAX_PLATFORMS=cpu python examples/sharded_deployment.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax

from qublas_tpu import anus, checkpoint
from qublas_tpu.complex import QComplexTensor
from qublas_tpu.ops.cgemm import cgemul
from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.ops.reduce import qreduce
from qublas_tpu.parallel import (
    make_mesh,
    shard_qgemul,
    sharded_cgemul,
    sharded_qreduce_k_tree,
)
from qublas_tpu.qformat import OverflowMode, qformat
from qublas_tpu.qtensor import from_raw


def main():
    n_dev = len(jax.devices())
    dp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(dp=dp, tp=n_dev // dp)
    tp = mesh.shape["tp"]
    print(f"mesh: dp={dp} x tp={tp} over {n_dev} devices")
    rng = np.random.RandomState(0)

    def rand(fmt, shape):
        return from_raw(rng.randint(fmt.raw_min, fmt.raw_max + 1, shape),
                        fmt)

    # 1) lossless int8 GEMM with a fused ANUS ROM: auto picks K-sharding
    #    (psum over the mesh) because the accumulation proves lossless
    fa = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = anus.build_table(anus.rsqrt_func, mid, mid)
    a = rand(fa, (8, 8 * tp))
    w1 = rand(fa, (8 * tp, 8 * tp))
    h = shard_qgemul(a, w1, mid, mesh, mul_to=wide, add_formats=(wide,),
                     epilogue_lut=table)
    ref_h = qgemul(a, w1, mid, mul_to=wide, add_formats=(wide,),
                   epilogue_lut=table, use_pallas=False)
    np.testing.assert_array_equal(np.asarray(h.raw()),
                                  np.asarray(ref_h.raw()))
    print("lossless GEMM + fused ROM: K-sharded, bit-exact")

    # 2) ORDER-SENSITIVE (saturating per-layer) GEMM: the round-5 k_tree
    #    split shards the contraction dim with NO losslessness requirement
    #    (one-subtree-per-device splits fold via the ppermute butterfly)
    f88z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    at = rand(f88z, (8, 8 * tp))
    bt = rand(f88z, (8 * tp, 4))
    y = shard_qgemul(at, bt, f88z, mesh, add_formats=(f88z,),
                     strategy="k_tree")
    ref_y = qgemul(at, bt, f88z, add_formats=(f88z,), use_pallas=False)
    np.testing.assert_array_equal(np.asarray(y.raw()),
                                  np.asarray(ref_y.raw()))
    print("order-sensitive GEMM: k_tree-sharded, bit-exact")

    # 3) complex GEMM (TF algorithm with its per-step tags), auto-sharded
    ca = QComplexTensor(rand(fa, (4, 8 * tp)), rand(fa, (4, 8 * tp)))
    cb = QComplexTensor(rand(fa, (8 * tp, 2 * tp)),
                        rand(fa, (8 * tp, 2 * tp)))
    m5 = qformat(5, 4)
    ckw = dict(algo="tf", add_formats=(wide,), ab=m5, cd=m5, ba=m5,
               abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    cy = sharded_cgemul(ca, cb, (mid, mid), mesh, **ckw)
    ref_c = cgemul(ca, cb, (mid, mid), **ckw)
    np.testing.assert_array_equal(np.asarray(cy.real.raw()),
                                  np.asarray(ref_c.real.raw()))
    np.testing.assert_array_equal(np.asarray(cy.imag.raw()),
                                  np.asarray(ref_c.imag.raw()))
    print("TF complex GEMM: auto-sharded, bit-exact")

    # 4) order-sensitive tree reduction, reduction-axis-sharded (k_tree)
    xv = rand(f88z, (8 * tp,))
    rv = sharded_qreduce_k_tree(xv, (f88z,), mesh=mesh)
    ref_r = qreduce(xv, (f88z,))
    assert int(np.asarray(jax.device_get(rv.data))) == int(ref_r.raw())
    print("order-sensitive Qreduce: k_tree-sharded, bit-exact")

    # 5) checkpoint the results (raw-exact npz pytree) and restore
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".npz") as fh:
        checkpoint.save(fh.name, {"h": h, "y": y})
        back = checkpoint.load(fh.name)
    np.testing.assert_array_equal(np.asarray(back["y"].raw()),
                                  np.asarray(y.raw()))
    print("checkpoint round-trip: bit-exact")
    print("sharded deployment example OK")


if __name__ == "__main__":
    main()
