"""Round-2 capabilities tour: wide formats on device + sharded execution.

Models a 40-bit accumulator datapath (the reference's multiword-ArbiInt
territory, QuBLAS.h:566-912) end-to-end:

1. 33–64-bit formats live ON DEVICE as (hi, lo) 32-bit limb pairs — the
   elementwise pipeline, reductions and GEMMs run there bit-exactly.
2. 65–256-bit formats ALSO live on device, as stacked uint32 N-limb
   storage (ops/limbint.py); only >256-bit formats (and fill(int)-wart
   raws beyond the storage word) fall back to exact host ints, served by
   the compiled 512-bit multiword engine where its envelope fits.
3. The same programs shard over a `jax.sharding.Mesh` (run with
   XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
   to see the virtual 8-device mesh).

Every value printed is bit-exact vs the Python golden model (hostops),
which is pinned to the compiled C++ reference by tests/golden_data.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax

import qublas_tpu as q
from qublas_tpu import refrand
from qublas_tpu.qformat import OverflowMode, QFormat


def main():
    import jax

    print("devices:", jax.devices())

    # -- 1. a 40-bit-storage format, resident on device as limb pairs ----
    acc40 = QFormat(30, 9)               # 40-bit storage
    x = refrand.reference_fill((4, 8), acc40, gen=refrand.MT19937(1))
    print(f"\n40-bit tensor: is_pair={x.is_pair} (device limb pairs)")

    small = q.qformat(3, 4)
    w = q.from_float(np.linspace(-2.0, 2.0, 8), small)
    y = q.qmul(x, w, to=QFormat(38, 10))         # pair x lane on device
    print("wide qmul out fmt:", y.fmt, "| first row:", y.to_double()[0][:3])

    r = q.qreduce(y, (QFormat(44, 10),), axis=1)  # wide tree reduce
    print("wide qreduce:", r.to_double())

    # -- 2. 141-bit formats: device-resident stacked N-limb storage ------
    wide = QFormat(100, 40)
    a = q.from_raw(np.array([(1 << 90) + 12345, -(1 << 95)], dtype=object),
                   wide)
    print(f"\n141-bit tensor: is_limb={a.is_limb} (device N-limb storage)")
    b = q.from_float([2.0, 0.5], q.qformat(3, 4))
    p = q.qmul(a, b, to=QFormat(110, 40))
    print(f"141-bit qmul (device limb lanes): {p.raw()}")

    # -- 2b. wide GEMM: streams over k-chunks at scale -------------------
    # (qgemul on pair/limb operands picks the streaming binary-carry tree
    # automatically when the layered [m, k, n] product tensor would be
    # large — peak memory [m, 64, n], so e.g. a 1024^3 40-bit GEMM runs
    # where the ~17 GB layered materialization cannot; see
    # `bench.py --wide-gemm`.)
    ga = refrand.reference_fill((4, 48), acc40, gen=refrand.MT19937(7))
    gb = refrand.reference_fill((48, 4), small, gen=refrand.MT19937(8))
    big = q.qgemul(ga, gb, QFormat(34, 9))
    print("wide GEMM out fmt:", big.fmt, "| [0,0] =", big.to_double()[0][0])

    # -- 3. sharded execution over a mesh --------------------------------
    n_dev = len(jax.devices())
    if n_dev >= 2:
        from qublas_tpu.parallel import (
            make_mesh, shard_qgemul, sharded_qreduce,
        )

        dp = 2 if n_dev % 2 == 0 else 1
        mesh = make_mesh(dp=dp, tp=n_dev // dp)
        fa = q.qformat(3, 4)
        wide32 = q.qformat(20, 8)
        out = q.qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
        A = q.random_fill((8, 8 * mesh.shape["tp"]), fa, seed=1)
        B = q.random_fill((8 * mesh.shape["tp"], 8 * mesh.shape["tp"]), fa,
                          seed=2)
        C = shard_qgemul(A, B, out, mesh, mul_to=wide32,
                         add_formats=(wide32,))  # auto: K-psum (lossless)
        ref = q.qgemul(A, B, out, mul_to=wide32, add_formats=(wide32,),
                       use_pallas=False)
        exact = np.array_equal(np.asarray(C.raw()), np.asarray(ref.raw()))
        print(f"\nsharded GEMM over {mesh.shape}: bit-exact = {exact}")

        if (8 * mesh.shape["tp"]) % n_dev == 0:
            xr = q.random_fill((n_dev * 2, 16), fa, seed=3)
            rr = sharded_qreduce(xr, (wide32,), axis=1, mesh=mesh)
            rref = q.qreduce(xr, (wide32,), axis=1)
            print("sharded qreduce bit-exact =",
                  np.array_equal(np.asarray(rr.raw()),
                                 np.asarray(rref.raw())))
    else:
        print("\n(single device: rerun with a virtual mesh to see sharding)")


if __name__ == "__main__":
    main()
