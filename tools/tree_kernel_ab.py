#!/usr/bin/env python3
"""Time the order-sensitive tree GEMM's two device backends on the GPU.

    python tools/tree_kernel_ab.py [--n 2048] [--reps 5]

Runs the canonical ``Qu<8,8,TRN::TCPL,SAT::ZERO>`` GEMM at n^3 through
``tree_gemm_scan`` (XLA) and ``tree_gemm_tiled`` (Pallas on Triton) at a few
tile settings, checks every output bit-exact against the scan, and prints
one JSON line per backend with the best warm time of ``--reps`` calls
(host clock around work that ends in ``block_until_ready``), taken in
turns (scan, kernels..., kernels..., scan).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qublas_tpu.ops import tree_gemm  # noqa: E402
from qublas_tpu.qformat import OverflowMode, mul_merge, qformat  # noqa: E402

VARIANTS = (  # (tile, blk, num_warps)
    (32, 16, 4), (64, 16, 8), (32, 8, 4), (16, 16, 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("tree_kernel_ab: needs a GPU")
    n = args.n
    f = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    plan = tree_gemm.plan_tree(f, f, mul_merge(f, f), (), n, f)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(f.raw_min, f.raw_max + 1, (n, n),
                                 dtype=np.int64).astype(np.int32))
    b = jnp.asarray(rng.integers(f.raw_min, f.raw_max + 1, (n, n),
                                 dtype=np.int64).astype(np.int32))
    fns = {"scan": jax.jit(lambda x, y: tree_gemm.tree_gemm_scan(
        x, y, plan, f))}
    for tile, blk, nw in VARIANTS:
        fns[f"tiled_t{tile}_b{blk}_w{nw}"] = jax.jit(
            lambda x, y, tile=tile, blk=blk, nw=nw: tree_gemm.tree_gemm_tiled(
                x, y, plan, f, tile=tile, blk=blk, num_warps=nw))
    ref = None
    compile_s, best = {}, {}
    for name, fn in list(fns.items()):
        t0 = time.perf_counter()
        try:
            out = np.asarray(jax.block_until_ready(fn(a, b)))
        except Exception as e:  # noqa: BLE001 - report and drop the variant
            print(json.dumps({"backend": name, "error": str(e)[:400]}),
                  flush=True)
            del fns[name]
            continue
        compile_s[name] = time.perf_counter() - t0
        if ref is None:
            ref = out
        elif not np.array_equal(out, ref):
            raise SystemExit(f"{name} differs from the scan")
        best[name] = float("inf")
    order = list(fns) + list(fns)[::-1]
    for name in order:
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[name](a, b))
            best[name] = min(best[name], time.perf_counter() - t0)
    for name in fns:
        print(json.dumps({"backend": name, "n": n,
                          "compile_plus_first_s": round(compile_s[name], 3),
                          "best_warm_s": best[name],
                          "gprod_s": n ** 3 / best[name] / 1e9}),
              flush=True)


if __name__ == "__main__":
    main()
