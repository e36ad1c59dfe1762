#!/usr/bin/env python3
"""Headline benchmark: INT8 Qgemul throughput vs the raw int8 matmul.

    python bench.py            # headline record (one JSON line)
    python bench.py --tree     # one per-config row (see EXTRA)
    python bench.py --all      # every row, printed as one JSON document

``vs_baseline`` is the quantized GEMM's rate over the same shape run as a
raw ``jnp.matmul`` int8×int8→int32 with no requantization, measured in the
same run: the fused shift-round-saturate epilogue should cost little on top
of the matmul.  Every record carries ``platform``, ``device_kind`` and
``device_count``.  The bench runs on a GPU only: without one it exits
non-zero.  It writes no file.
"""

import json
import os
import sys
import time

import numpy as np

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import configure_cache, require_gpu  # noqa: E402
from qublas_tpu.ops.gemm import exact_plan, qgemul  # noqa: E402
from qublas_tpu.qformat import OverflowMode, qformat  # noqa: E402
from qublas_tpu.qtensor import QTensor  # noqa: E402


def device_stamp(devices=None) -> dict:
    """Platform, device kind and device count, stamped on every record."""
    devices = devices if devices is not None else jax.devices()
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices)}


def headline_record(gops: float, roof_gops: float, pairs: int,
                    stamp: dict, device=None) -> dict:
    """The headline JSON record.  ``vs_baseline`` is the quantized GEMM's
    rate over the same-run raw int8 matmul's.  ``device`` (optional,
    ``{"gops", "roofline_gops", "ab_pairs"}`` from device-trace timing)
    becomes the primary value when present; the host-clock numbers then
    move to ``wall_*`` fields."""
    rec = {
        "metric": "int8_qgemul_gops",
        "value": round(gops, 2),
        "unit": "GOP/s",
        "roofline_gops": round(roof_gops, 2),
        "vs_baseline": round(gops / roof_gops, 4),
        "ab_pairs": pairs,
        "timing": "wall",
        **stamp,
    }
    if device is not None:
        rec["wall_gops"] = rec["value"]
        rec["wall_roofline_gops"] = rec["roofline_gops"]
        rec["wall_vs_baseline"] = rec["vs_baseline"]
        rec["value"] = round(device["gops"], 2)
        rec["roofline_gops"] = round(device["roofline_gops"], 2)
        rec["vs_baseline"] = round(device["gops"] / device["roofline_gops"],
                                   4)
        rec["device_ab_pairs"] = device["ab_pairs"]
        rec["timing"] = "device-trace"
    return rec


M = N = K = 4096
ITERS = 256

FA = qformat(3, 4)  # int8 storage: the INT8 Qgemul config
WIDE = qformat(20, 8)  # lossless int32 accumulation (proof-checked below)
OUT = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)


def _time(fn, a, b, iters=ITERS, budget_s=45.0):
    """Seconds per call, with a data dependency chaining iterations (the
    output feeds the next call's LHS) and ``block_until_ready`` on the
    last output.  The loop stops early at ``budget_s``."""
    jax.block_until_ready(fn(a, b))  # warm-up
    t0 = time.perf_counter()
    x = a
    done = 0
    for _ in range(iters):
        x = fn(x, b)
        done += 1
        if time.perf_counter() - t0 > budget_s:
            break
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / done


def _device_op_time(fn, a, b):
    """Device-trace seconds of one ``fn(a, b)`` program execution: the
    busiest HLO module's kernel time (``utils.profiling.device_busy``)."""
    from qublas_tpu.utils.profiling import device_busy

    return device_busy(lambda: jax.block_until_ready(fn(a, b)))["module_s"]


def _device_pair_refine(fn_a, fn_b, a, b, rg, pairs=2):
    """Interleaved device-trace A/B refinement of two RG-chained jit
    programs: per-iteration seconds ``(ta, tb)``, best of ``pairs``
    interleaved pairs."""
    ta = tb = float("inf")
    for _ in range(pairs):
        x1 = _device_op_time(fn_a, a, b)
        x2 = _device_op_time(fn_b, a, b)
        if x1 is None or x2 is None:
            return None
        ta = min(ta, x1)
        tb = min(tb, x2)
    return ta / rg, tb / rg


def bench_tree_gemm():
    """BASELINE config 1 at the *canonical order-sensitive* format
    Qu<8,8,TRN::TCPL,SAT::ZERO>: the binary-carry tree (the tiled kernel
    on the GPU).  vs_baseline = speedup over the layered
    [m,k,n]-materializing fallback."""
    from qublas_tpu.ops import tree_gemm
    from qublas_tpu.qformat import mul_merge

    f = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    m = n = k = 512
    rng = np.random.RandomState(0)
    a = jnp.asarray(rng.randint(f.raw_min, f.raw_max + 1, (m, k),
                                dtype=np.int64).astype(np.int32))
    b = jnp.asarray(rng.randint(f.raw_min, f.raw_max + 1, (k, n),
                                dtype=np.int64).astype(np.int32))
    plan = tree_gemm.plan_tree(f, f, mul_merge(f, f), (), k, f)
    assert plan is not None, "canonical config must stay on the device tree"
    RG = 16

    # chain iterations INSIDE jit (fori_loop) so one dispatch covers RG
    # device iterations
    @jax.jit
    def stream(a_data, b_data):
        def body(i, x):
            return qgemul(QTensor(x, f), QTensor(b_data, f), f).data \
                .astype(jnp.int32)
        return jax.lax.fori_loop(0, RG, body, a_data)

    @jax.jit
    def layered(a_data, b_data):
        from qublas_tpu.ops import elementwise as ew
        from qublas_tpu.ops.reduce import qreduce

        def body(i, x):
            prod = ew.qmul(QTensor(x[:, :, None], f),
                           QTensor(b_data[None, :, :], f))
            acc = qreduce(prod, (), axis=-2)
            return ew.qcast(acc, f).data.astype(jnp.int32)
        return jax.lax.fori_loop(0, 2, body, a_data)

    t_s = _time(stream, a, b, iters=4) / RG
    t_l = _time(layered, a, b, iters=2) / 2
    ops = 2.0 * m * n * k
    prods = float(m * n * k)
    rec = {
        "metric": "canonical_tree_qgemul_gops",
        "value": round(ops / t_s / 1e9, 2),
        "unit": "GOP/s",
        "timing": "wall",
        "vs_baseline": round(t_l / t_s, 2),  # speedup over layered fallback
        "gprod_s": round(prods / t_s / 1e9, 2),
        **device_stamp(),
    }
    t_dev = _device_op_time(stream, a, b)
    if t_dev is not None:
        t_dev /= RG
        rec["wall_gops"] = rec["value"]
        rec["value"] = round(ops / t_dev / 1e9, 2)
        rec["timing"] = "device-trace"
        rec["gprod_s"] = round(prods / t_dev / 1e9, 2)
    print(json.dumps(rec))
    return rec


def bench_reduce():
    """BASELINE config 2: Qreduce with per-layer formats, batched."""
    from qublas_tpu.ops.reduce import qreduce
    from qublas_tpu.qformat import RoundMode

    f = qformat(4, 4)
    layers = (qformat(5, 3, round_mode=RoundMode.RND_CONV,
                      overflow_mode=OverflowMode.SAT_ZERO), qformat(6, 2))
    B, n = 4096, 1024
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randint(f.raw_min, f.raw_max + 1, (B, n),
                                dtype=np.int64).astype(np.int8))

    RG = 16

    # chain RG iterations INSIDE jit (one dispatch covers them).  Chain
    # shape matters: the op must CONSUME a barrier output tied to the
    # carry, and its result must feed the carry (`acc + y`) — the earlier
    # `return barrier((xd, y))[0]` shape got the whole body elided (an
    # RG=16 vs RG=64 device-trace differential measured ~zero marginal
    # per-iteration cost), as did the r2/r3 `* 0` feedback term
    def chain(fn):
        @jax.jit
        def f2(x_data, _):
            def body(i, acc):
                xt, _ = jax.lax.optimization_barrier((x_data, acc))
                return acc + fn(xt).astype(jnp.int32)
            acc = jax.lax.fori_loop(0, RG, body,
                                    jnp.zeros((B,), jnp.int32))
            return acc[:, None]
        return f2

    red = chain(lambda xd: qreduce(QTensor(xd, f), layers, axis=1).data)
    baseline = chain(lambda xd: jnp.sum(xd.astype(jnp.int32), axis=1))
    t_r = _time(red, x, None, iters=4) / RG
    t_b = _time(baseline, x, None, iters=4) / RG
    elems = float(B * n)
    rec = {
        "metric": "qreduce_layered_gelems",
        "value": round(elems / t_r / 1e9, 3),
        "unit": "Gelem/s",
        "timing": "wall",
        "vs_baseline": round(t_b / t_r, 4),  # vs plain int32 sum
    }
    # device-trace refinement: host-clock times of this small op are
    # dominated by dispatch
    dev = _device_pair_refine(red, baseline, x, None, RG)
    if dev is not None:
        td_r, td_b = dev
        rec["wall_value"] = rec["value"]
        rec["wall_vs_baseline"] = rec["vs_baseline"]
        rec["value"] = round(elems / td_r / 1e9, 3)
        rec["vs_baseline"] = round(td_b / td_r, 4)
        rec["timing"] = "device-trace"
    print(json.dumps(rec))
    return rec


def bench_lut_gemm():
    """BASELINE config 4: ANUS LUT fused into the Qgemul epilogue — reports
    the overhead vs the plain quantized GEMM (1.0 = free)."""
    from qublas_tpu.anus import build_table, rsqrt_func

    rng = np.random.RandomState(0)
    a_raw = jnp.asarray(rng.randint(FA.raw_min, FA.raw_max + 1, (M, K),
                                    dtype=np.int64).astype(np.int8))
    b_raw = jnp.asarray(rng.randint(FA.raw_min, FA.raw_max + 1, (K, N),
                                    dtype=np.int64).astype(np.int8))
    table = build_table(rsqrt_func, OUT, OUT)

    @jax.jit
    def fused(a_data, b_data):
        return qgemul(QTensor(a_data, FA), QTensor(b_data, FA), OUT,
                      mul_to=WIDE, add_formats=(WIDE,),
                      epilogue_lut=table).data

    @jax.jit
    def plain(a_data, b_data):
        return qgemul(QTensor(a_data, FA), QTensor(b_data, FA), OUT,
                      mul_to=WIDE, add_formats=(WIDE,)).data

    # interleave fused/plain passes with best-of per side (headline bench
    # methodology)
    t_f = t_p = float("inf")
    for _ in range(3):
        t_f = min(t_f, _time(fused, a_raw, b_raw, iters=64, budget_s=15.0))
        t_p = min(t_p, _time(plain, a_raw, b_raw, iters=64, budget_s=15.0))
    ops = 2.0 * M * N * K
    rec = {
        "metric": "int8_qgemul_lut_gops",
        "value": round(ops / t_f / 1e9, 2),
        "unit": "GOP/s",
        "timing": "wall",
        "vs_baseline": round(t_p / t_f, 4),  # vs plain quantized GEMM
    }
    # device-trace refinement: the epilogue's device cost
    dev = _device_pair_refine(fused, plain, a_raw, b_raw, 1)
    if dev is not None:
        td_f, td_p = dev
        rec["wall_value"] = rec["value"]
        rec["wall_vs_baseline"] = rec["vs_baseline"]
        rec["value"] = round(ops / td_f / 1e9, 2)
        rec["vs_baseline"] = round(td_p / td_f, 4)
        rec["timing"] = "device-trace"
    print(json.dumps(rec))
    return rec


def bench_cgemm():
    """BASELINE config 5: TFComplexMul complex GEMM, lossless config on the
    int32 fast path.

    The fast path lowers TF's three 9-bit-operand-sum matmuls to the four
    elementary int8 matmuls (exact distribution under the losslessness
    proof, ``cgemm._tf_int8_distributed``), so it never issues the int16
    matmuls of the ``vs_baseline`` floor (3 raw int16 matmuls);
    ``vs_3xint8_informational`` compares with 3 raw int8 matmuls.  Every
    operand of every arm is barrier-tied to the carry AND both output
    parts are consumed: a hoisted loop-invariant matmul or a DCE'd
    imag-only dot makes an arm time fewer matmuls than it claims."""
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops.cgemm import cgemul

    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    m = n = k = 2048
    rng = np.random.RandomState(0)

    def raws(shape):
        return jnp.asarray(rng.randint(f.raw_min, f.raw_max + 1, shape,
                                       dtype=np.int64).astype(np.int8))

    ar, ai, br, bi = raws((m, k)), raws((m, k)), raws((k, n)), raws((k, n))
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
           qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO))

    RG = 8

    # chain RG iterations INSIDE jit, EVERY a-side operand tied to the
    # carry with an optimization_barrier, and interleave the
    # arms with best-of per side
    @jax.jit
    def tf(x, _b):
        def body(i, acc):
            xt, ait, _ = jax.lax.optimization_barrier((x, ai, acc))
            c = cgemul(QComplexTensor(QTensor(xt, f), QTensor(ait, f)),
                       QComplexTensor(QTensor(br, f), QTensor(bi, f)),
                       out, algo="tf", add_formats=(wide,), ab=mid, cd=mid,
                       ba=mid, abc=wide, cdb=wide, bad=wide, AB=wide,
                       BC=wide)
            # consume BOTH parts (round 5): an unused imag lets XLA DCE
            # the imag-only dots and the arm times fewer matmuls than it
            # claims (measured: 0.153 vs 0.207 ms/iter at 2048^3)
            return acc + c.real.data.astype(jnp.int32) \
                + c.imag.data.astype(jnp.int32)
        return jax.lax.fori_loop(0, RG, body,
                                 jnp.zeros((m, n), jnp.int32))

    def floor_arm(dtype):
        br_c, bi_c = br.astype(dtype), bi.astype(dtype)

        @jax.jit
        def fl(x, _b):
            def body(i, acc):
                xt, ait, _ = jax.lax.optimization_barrier((x, ai, acc))
                xc, ac = xt.astype(dtype), ait.astype(dtype)
                d1 = jnp.matmul(xc, br_c, preferred_element_type=jnp.int32)
                d2 = jnp.matmul(ac, br_c, preferred_element_type=jnp.int32)
                d3 = jnp.matmul(xc, bi_c, preferred_element_type=jnp.int32)
                return acc + d1 + d2 + d3
            return jax.lax.fori_loop(0, RG, body,
                                     jnp.zeros((m, n), jnp.int32))
        return fl

    floor16 = floor_arm(jnp.int16)
    floor8 = floor_arm(jnp.int8)

    for fn in (tf, floor16, floor8):
        jax.block_until_ready(fn(ar, None))  # compile + warm

    def timed(fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(ar, None))
        return (time.perf_counter() - t0) / RG

    t_c = t_16 = t_8 = float("inf")
    for _ in range(4):
        t_c = min(t_c, timed(tf))
        t_16 = min(t_16, timed(floor16))
        t_8 = min(t_8, timed(floor8))
    ops = 3 * 2.0 * m * n * k  # the 3 TF multiplies
    rec = {
        "metric": "tf_complex_qgemul_gops",
        "value": round(ops / t_c / 1e9, 2),
        "unit": "GOP/s",
        "timing": "wall",
        "vs_baseline": round(t_16 / t_c, 4),   # vs 3x int16 matmul floor
        "vs_3xint8_informational": round(t_8 / t_c, 4),
    }
    # device-trace refinement
    dev = _device_pair_refine(tf, floor16, ar, None, RG)
    dev8 = _device_pair_refine(tf, floor8, ar, None, RG, pairs=1)
    if dev is not None:
        td_c, td_16 = dev
        rec["wall_value"] = rec["value"]
        rec["wall_vs_baseline"] = rec["vs_baseline"]
        rec["value"] = round(ops / td_c / 1e9, 2)
        rec["vs_baseline"] = round(td_16 / td_c, 4)
        rec["timing"] = "device-trace"
        if dev8 is not None:
            rec["vs_3xint8_informational"] = round(dev8[1] / dev8[0], 4)
    print(json.dumps(rec))
    return rec


def bench_wide():
    """Round-2 feature: 33..64-bit-storage formats on device as (hi, lo)
    limb pairs vs the exact Python host loop they previously required.
    vs_baseline = speedup (VERDICT bar: >= 100x)."""
    from qublas_tpu.ops import elementwise as ew
    from qublas_tpu.qtensor import QTensor, from_raw

    f40 = qformat(30, 9)           # storage 40 -> pair storage
    out = qformat(35, 6, overflow_mode=OverflowMode.SAT_ZERO)
    n = 512 * 512
    rng = np.random.RandomState(0)
    raws_a = rng.randint(-(1 << 39), 1 << 39, size=n, dtype=np.int64)
    raws_b = rng.randint(-(1 << 13), 1 << 13, size=n, dtype=np.int64)
    a = from_raw(raws_a.astype(object), f40)
    b = from_raw(raws_b.astype(object), qformat(10, 4))

    RG = 32

    # chain RG iterations INSIDE jit (fori_loop) so one dispatch covers
    # them.  The chain feeds the previous OUTPUT back as the next input;
    # the op has
    # no data-dependent branches, so the drifting value distribution
    # cannot change the timing.
    @jax.jit
    def dev(ah, al, bd):
        from qublas_tpu.ops.wideint import PairArray

        def body(i, carry):
            # relabel the out-format raws as f40 raws (same pair storage)
            # so every chained iteration measures the same op config
            x = QTensor(PairArray(carry[0], carry[1]), f40)
            r = ew.qmul(x, QTensor(bd, qformat(10, 4)), to=out)
            return r.data.hi, r.data.lo

        x = QTensor(PairArray(ah, al), f40)
        r = ew.qmul(x, QTensor(bd, qformat(10, 4)), to=out)
        return jax.lax.fori_loop(0, RG - 1, body, (r.data.hi, r.data.lo))

    hi, lo = dev(a.data.hi, a.data.lo, b.data)
    jax.block_until_ready(lo)  # warm-up + sync
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < 10.0 and iters < 8:
        hi, lo = dev(hi, lo, b.data)
        iters += 1
    jax.block_until_ready(lo)
    t_dev = (time.perf_counter() - t0) / (iters * RG)

    # the Python host loop these formats ran on before pair storage, on a
    # small slice, extrapolated linearly (it is strictly per-element)
    from qublas_tpu import hostops

    m = 16384
    fb = qformat(10, 4)
    t0 = time.perf_counter()
    for x, y in zip(raws_a[:m], raws_b[:m]):
        hostops.qmul((int(x), f40), (int(y), fb), to=out)
    t_host = (time.perf_counter() - t0) * (n / m)
    rec = {
        "metric": "wide_qmul_melems",
        "value": round(n / t_dev / 1e6, 2),
        "unit": "Melem/s",
        "vs_baseline": round(t_host / t_dev, 1),  # speedup over host loop
    }
    print(json.dumps(rec))
    return rec


def bench_limb():
    """Round-2 feature: 65..256-bit-storage formats on device as stacked
    N-limb uint32 arrays vs the exact Python host loop they previously
    required.  vs_baseline = speedup over that loop."""
    from qublas_tpu.ops import elementwise as ew
    from qublas_tpu.ops.limbint import LimbArray
    from qublas_tpu.qtensor import QTensor, from_raw

    fa = qformat(100, 40)          # 141-bit storage -> 5 limbs
    fb = qformat(10, 4)
    n = 512 * 512
    rng = np.random.RandomState(0)
    raws_a = np.array([(int(h) << 64) | int(l) for h, l in zip(
        rng.randint(-(1 << 62), 1 << 62, size=n, dtype=np.int64),
        rng.randint(0, 1 << 63, size=n, dtype=np.int64))], dtype=object)
    raws_b = rng.randint(-(1 << 13), 1 << 13, size=n, dtype=np.int64)
    a = from_raw(raws_a, fa)
    b = from_raw(raws_b.astype(object), fb)
    assert a.is_limb

    RG = 32

    # chain RG iterations INSIDE jit — one dispatch covers them all; the
    # output requantizes back into the input format so it feeds the next
    # iteration (same limb count, no data-dependent control flow)
    @jax.jit
    def dev(limbs, bd):
        def body(i, ls):
            x = QTensor(LimbArray(ls), fa)
            return ew.qmul(x, QTensor(bd, fb), to=fa).data.limbs
        return jax.lax.fori_loop(0, RG, body, limbs)

    limbs = dev(a.data.limbs, b.data)
    jax.block_until_ready(limbs)  # warm-up + sync
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < 10.0 and iters < 8:
        limbs = dev(limbs, b.data)
        iters += 1
    jax.block_until_ready(limbs)
    t_dev = (time.perf_counter() - t0) / (iters * RG)

    from qublas_tpu import hostops

    m = 8192
    t0 = time.perf_counter()
    for x, y in zip(raws_a[:m], raws_b[:m]):
        hostops.qmul((int(x), fa), (int(y), fb), to=fa)
    t_host = (time.perf_counter() - t0) * (n / m)
    rec = {
        "metric": "limb_qmul_melems",
        "value": round(n / t_dev / 1e6, 2),
        "unit": "Melem/s",
        "vs_baseline": round(t_host / t_dev, 1),  # speedup over host loop
    }
    print(json.dumps(rec))
    return rec


def bench_wide_gemm():
    """Streaming wide GEMM (binary-carry over k-chunks): pair-storage
    operands on device.  value = G products/s of the streaming path at
    1024^3 (whose layered [m,k,n] pair materialization would need ~17 GB
    and cannot fit device memory); vs_baseline = streaming/layered speed ratio at
    512^3 where both fit."""
    from qublas_tpu.ops import gemm as G
    from qublas_tpu.ops.wideint import PairArray
    from qublas_tpu.qtensor import QTensor, from_raw

    f40 = qformat(30, 9)  # 40-bit storage: pair lanes; out = same (saturating
    # tree -> order-sensitive, so the int32 fast path cannot take it)
    rng = np.random.RandomState(0)

    def mk(m, k):
        raws = rng.randint(-(1 << 39), 1 << 39, size=m * k, dtype=np.int64)
        return from_raw(raws.astype(object).reshape(m, k), f40)

    RG = 4

    def build(sz, min_elems):
        a, b = mk(sz, sz), mk(sz, sz)

        @jax.jit
        def f(ah, al, bh, bl):
            bq = QTensor(PairArray(bh, bl), f40)

            def body(i, c):
                x = QTensor(PairArray(c[0], c[1]), f40)
                r = G.qgemul(x, bq, f40)
                return (r.data.hi, r.data.lo)
            return jax.lax.fori_loop(0, RG, body, (ah, al))

        def run():
            # override active for every run so a retrace cannot flip the
            # arm (same class as the bench_fastwide ADVICE r3 finding);
            # round 5: gemm's supported stream_gate context
            with G.stream_gate(min_elems):
                hi, lo = f(a.data.hi, a.data.lo, b.data.hi, b.data.lo)
                jax.block_until_ready(lo)  # sync

        def timed():
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) / RG

        run()  # compile + warm-up
        return timed

    # interleave stream/layered passes with best-of per side (same
    # methodology as the headline bench)
    cmp_sz = 512
    stream_t = build(cmp_sz, 0)
    layer_t = build(cmp_sz, 1 << 60)
    t_stream = min(stream_t(), stream_t())
    t_layer = min(layer_t(), layer_t())
    for _ in range(2):
        t_stream = min(t_stream, stream_t())
        t_layer = min(t_layer, layer_t())
    # 1023^3: odd k with NO power-of-two factor — only runnable at all by
    # the general-k ragged-tail stream (round 3); the layered [m,k,n] pair
    # materialization (~17 GB) cannot fit device memory at this scale either way
    big = 1023
    big_t = build(big, 0)
    t_big = min(big_t(), big_t())
    rec = {
        "metric": "wide_gemm_stream_gprod",
        "value": round(big ** 3 / t_big / 1e9, 2),
        "unit": "Gprod/s",
        "k": big,
        "vs_baseline": round(t_layer / t_stream, 2),  # vs layered at 512^3
    }
    print(json.dumps(rec))
    return rec


def bench_fastwide():
    """Proof-lossless beyond-int32 dots at an int16-lane config: the
    production fast dispatch (the balanced-digit int8 dot, with the
    pair-domain dot as fallback) vs the order-preserving stream, plus the
    FORCED pair-domain path as its own arm.  A/B-interleaved best-of; per-iteration device-trace timing when the
    profiler is available."""
    from qublas_tpu.ops import gemm as G
    from qublas_tpu.qformat import mul_merge

    fa = qformat(13, 0)                   # int16 lanes, |prod| <= 2^26
    out = qformat(25, 0)
    kw = dict(mul_to=qformat(27, 0), add_formats=(qformat(40, 0),))
    m = n = 512
    k = 2048                              # dot ~2^37: past int32
    plan = exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                      kw["add_formats"], k)
    assert plan is not None and not plan.dot_interval.fits32
    rng = np.random.RandomState(0)
    a = jnp.asarray(rng.randint(fa.raw_min, fa.raw_max + 1, (m, k),
                                dtype=np.int64).astype(np.int16))
    b = jnp.asarray(rng.randint(fa.raw_min, fa.raw_max + 1, (k, n),
                                dtype=np.int64).astype(np.int16))
    _timing = {"dev": False}

    def build(mode):
        # "auto": production dispatch; "pair": force the round-3
        # pair-domain path (digit dot disabled); "stream": both fast paths
        # disabled -> the order-preserving binary-carry stream
        RG = 4 if mode == "stream" else 8

        @jax.jit
        def f(ad, bd):
            def body(i, c):
                # optimization_barrier ties the LHS to the carry so each
                # iteration depends on the last: XLA loop-invariant code
                # motion would otherwise hoist the GEMM and time one
                # iteration + RG adds.  (An additive `+ (c & 0)` mask is
                # NOT enough — the algebraic simplifier folds it away and
                # the hoist happens anyway, measured.)
                ad2, _ = jax.lax.optimization_barrier((ad, c))
                r = qgemul(QTensor(ad2, fa), QTensor(bd, fa), out, **kw)
                return c + r.data.astype(jnp.int32)
            return jax.lax.fori_loop(0, RG, body,
                                     jnp.zeros((m, n), jnp.int32))

        def patched(run):
            # the override must cover every trace of ``f`` — including a
            # retrace after cache eviction — or an arm would silently
            # trace the wrong path (ADVICE r3; the round-4 device-trace
            # session caught the "stream" arm actually running the limb
            # fast path because only the wide tier was disabled).  Round 5
            # replaced the module monkeypatch with gemm's supported
            # context API (force_tiers_off / stream_gate).
            from contextlib import ExitStack

            with ExitStack() as st:
                if mode == "stream":
                    st.enter_context(G.force_tiers_off("wide", "limb"))
                    st.enter_context(G.stream_gate(0))
                elif mode == "pair":
                    st.enter_context(G.force_tiers_off("limb"))
                return run()

        def once():
            r = f(a, b)
            jax.block_until_ready(r)  # sync

        patched(once)  # compile + warm-up

        def timed():
            # device-trace per-iteration time when available (round 4);
            # the patch stays active across the traced run so a retrace
            # cannot flip the arm
            from qublas_tpu.utils.profiling import device_busy

            p = patched(lambda: device_busy(once))
            if p and p.get("module_s"):
                _timing["dev"] = True
                return p["module_s"] / RG
            t0 = time.perf_counter()
            patched(once)
            return (time.perf_counter() - t0) / RG
        return timed

    autot = build("auto")
    pairt = build("pair")
    streamt = build("stream")
    t_a = min(autot(), autot())
    t_p = min(pairt(), pairt())
    t_s = min(streamt(), streamt())
    for _ in range(2):
        t_a = min(t_a, autot())
        t_p = min(t_p, pairt())
        t_s = min(t_s, streamt())
    prods = float(m * n * k)
    rec = {
        "metric": "fastwide_gemm_gprod",
        "value": round(prods / t_a / 1e9, 2),
        "unit": "Gprod/s",
        "timing": "device-trace" if _timing["dev"] else "wall",
        "vs_baseline": round(t_s / t_a, 2),  # vs the order-preserving stream
        "pair_path_gprod_s": round(prods / t_p / 1e9, 2),
        "pair_vs_auto": round(t_a / t_p, 4),  # <1: pair path slower
    }
    print(json.dumps(rec))
    return rec


def bench_limbwide():
    """Round-4 feature: the limb-domain wide-dot fast GEMM (proof-lossless
    dot beyond the 64-bit pair domain; balanced-digit int8 matmul +
    exact stacked-limb recombination) vs the order-preserving streaming
    tree these configs previously ran.  40-bit x 40-bit operands (80-bit
    products).  A/B-interleaved best-of."""
    from qublas_tpu.ops import gemm as G
    from qublas_tpu.ops.wideint import PairArray
    from qublas_tpu.qformat import mul_merge
    from qublas_tpu.qtensor import from_raw

    fa = qformat(25, 15)                  # 40-bit pair storage
    out = qformat(60, 20)                 # limb output
    kw = dict(mul_to=qformat(51, 30), add_formats=(qformat(62, 30),))
    m = n = 512
    k = 2048
    plan = exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                      kw["add_formats"], k)
    assert plan is not None and not plan.dot_interval.fits64
    assert G.limb_dot_plan(fa, fa, out, plan, k, m, n) is not None
    rng = np.random.RandomState(0)

    def mk(r, c):
        raws = rng.randint(-(1 << 39), 1 << 39, size=r * c, dtype=np.int64)
        return from_raw(raws.astype(object).reshape(r, c), fa)

    a, b = mk(m, k), mk(k, n)
    _timing = {"dev": False}

    def build(disable_fast):
        # chain iterations INSIDE jit so one dispatch covers them (the
        # per-dispatch cost otherwise floors the measurement); the slower
        # stream arm gets fewer chained iterations
        RG = 4 if disable_fast else 32

        @jax.jit
        def f(ah, al, bh, bl):
            bq = QTensor(PairArray(bh, bl), fa)

            def body(i, c):
                # optimization_barrier ties the LHS to the carry so each
                # iteration depends on the last (a `+ (c & 0)` mask gets
                # algebraically folded and the GEMM hoisted — measured)
                ah2, _ = jax.lax.optimization_barrier((ah, c))
                r = qgemul(QTensor(PairArray(ah2, al), fa), bq, out, **kw)
                return c + r.data.limbs[0].astype(jnp.int32)
            return jax.lax.fori_loop(0, RG, body,
                                     jnp.zeros((m, n), jnp.int32))

        def patched(run):
            # override covers every trace (incl. retrace after cache
            # eviction) via gemm's supported context API (round 5).
            # Disable BOTH fast tiers: the pair path cannot take 80-bit
            # dots today (fits64 gate) but the stream claim must not rest
            # on that staying true
            from contextlib import ExitStack

            with ExitStack() as st:
                if disable_fast:
                    st.enter_context(G.force_tiers_off("wide", "limb"))
                    st.enter_context(G.stream_gate(0))
                return run()

        def once():
            r = f(a.data.hi, a.data.lo, b.data.hi, b.data.lo)
            jax.block_until_ready(r)  # sync

        patched(once)  # compile + warm-up

        def timed():
            # device-trace per-iteration time when available (round 4);
            # patch active across the traced run
            from qublas_tpu.utils.profiling import device_busy

            p = patched(lambda: device_busy(once))
            if p and p.get("module_s"):
                _timing["dev"] = True
                return p["module_s"] / RG
            t0 = time.perf_counter()
            patched(once)
            return (time.perf_counter() - t0) / RG
        return timed

    fastt = build(False)
    streamt = build(True)
    t_f = min(fastt(), fastt())
    t_s = min(streamt(), streamt())
    for _ in range(2):
        t_f = min(t_f, fastt())
        t_s = min(t_s, streamt())
    prods = float(m * n * k)
    rec = {
        "metric": "limbwide_gemm_gprod",
        "value": round(prods / t_f / 1e9, 2),
        "unit": "Gprod/s",
        "operand_bits": 40,
        "timing": "device-trace" if _timing["dev"] else "wall",
        "vs_baseline": round(t_s / t_f, 2),  # vs the order-preserving stream
    }
    print(json.dumps(rec))
    return rec


def bench_cgemm_wide():
    """Late-round-4 feature: the limb-domain complex GEMM fast path
    (proof-lossless complex dots beyond int32: 4 balanced-digit limb
    dots + exact limb shift/combine epilogues) vs the layered
    order-preserving path these configs previously ran.  40-bit pair
    operands, 80-bit products, basic algo.  A/B-interleaved best-of with
    device-trace refinement."""
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops import cgemm as C
    from qublas_tpu.ops.cgemm import cgemul
    from qublas_tpu.ops.wideint import PairArray
    from qublas_tpu.qtensor import from_raw

    fa = qformat(25, 15)                  # 40-bit pair storage
    w51, acc = qformat(51, 30), qformat(52, 30)
    kw = dict(algo="basic", add_formats=(qformat(62, 30),),
              ac=w51, bd=w51, ad=w51, bc=w51, acbd=acc, adbc=acc)
    outf = (qformat(60, 20),) * 2         # limb output parts
    m = n = 128
    k = 512
    rng = np.random.RandomState(0)

    def mk(r, c):
        raws = rng.randint(-(1 << 39), 1 << 39, size=r * c, dtype=np.int64)
        return from_raw(raws.astype(object).reshape(r, c), fa)

    ca = QComplexTensor(mk(m, k), mk(m, k))
    cb = QComplexTensor(mk(k, n), mk(k, n))
    info = {}
    probe = C._fast_cgemul(ca, cb, outf[0], outf[1], "basic",
                           (kw["add_formats"][0],), (kw["add_formats"][0],),
                           {t: kw[t] for t in
                            ("ac", "bd", "ad", "bc", "acbd", "adbc")},
                           info=info)
    assert probe is not None and info.get("domain") == "limb"
    _timing = {"dev": False}

    def build(disable_fast):
        # chain iterations INSIDE jit; the layered arm is far
        # slower — fewer chained iterations
        RG = 1 if disable_fast else 8

        @jax.jit
        def f(arh, arl, aih, ail, brh, brl, bih, bil):
            qb = QComplexTensor(QTensor(PairArray(brh, brl), fa),
                                QTensor(PairArray(bih, bil), fa))

            def body(i, c):
                # tie EVERY a-side operand to the carry (ADVICE r4: tying
                # only arh let XLA hoist the ai-side digit matmuls out of
                # the loop, timing 2 of 4 dots) AND consume BOTH parts
                # (round 5: an unused imag lets XLA DCE the imag-only
                # dots — the same under-timing by another route)
                arh2, arl2, aih2, ail2, _ = jax.lax.optimization_barrier(
                    (arh, arl, aih, ail, c))
                qa = QComplexTensor(QTensor(PairArray(arh2, arl2), fa),
                                    QTensor(PairArray(aih2, ail2), fa))
                r = cgemul(qa, qb, outf, **kw)
                return (c + r.real.data.limbs[0].astype(jnp.int32)
                        + r.imag.data.limbs[0].astype(jnp.int32))
            return jax.lax.fori_loop(0, RG, body,
                                     jnp.zeros((m, n), jnp.int32))

        def patched(run):
            # supported override (round 5): layered arm runs inside
            # cgemm's force_fast_off context instead of a module patch
            if not disable_fast:
                return run()
            with C.force_fast_off():
                return run()

        def once():
            r = f(ca.real.data.hi, ca.real.data.lo,
                  ca.imag.data.hi, ca.imag.data.lo,
                  cb.real.data.hi, cb.real.data.lo,
                  cb.imag.data.hi, cb.imag.data.lo)
            jax.block_until_ready(r)  # sync

        patched(once)  # compile + warm-up

        def timed():
            from qublas_tpu.utils.profiling import device_busy

            p = patched(lambda: device_busy(once))
            if p and p.get("module_s"):
                _timing["dev"] = True
                return p["module_s"] / RG
            t0 = time.perf_counter()
            patched(once)
            return (time.perf_counter() - t0) / RG
        return timed

    fastt = build(False)
    slowt = build(True)
    t_f = min(fastt(), fastt())
    t_s = min(slowt(), slowt())
    for _ in range(2):
        t_f = min(t_f, fastt())
        t_s = min(t_s, slowt())
    prods = float(m * n * k)              # complex products per GEMM
    rec = {
        "metric": "cgemm_wide_gcprod",
        "value": round(prods / t_f / 1e9, 3),
        "unit": "Gcprod/s",
        "operand_bits": 40,
        "timing": "device-trace" if _timing["dev"] else "wall",
        "vs_baseline": round(t_s / t_f, 2),  # vs the layered path
    }
    print(json.dumps(rec))
    return rec


def bench_div():
    """Round-5 artifact row for the division op class (VERDICT r4 item 6:
    device dividers landed in round 4 with tests but no bench row).
    value = device pair-division throughput (64-step restoring long
    division on (hi, lo) pairs, in-jit chained); vs_baseline = speedup
    over the exact Python host loop these configs ran before round 4.
    ``native_wide_div_speedup`` rides along: the round-5 compiled
    multiword divider (qh_wx_div) vs the Python-int loop at a 300-bit
    config (host-side CPU — stable, no chip)."""
    from qublas_tpu import hostops
    from qublas_tpu.ops import elementwise as ew
    from qublas_tpu.ops.wideint import PairArray
    from qublas_tpu.qtensor import QTensor, from_raw

    f40 = qformat(30, 9)              # pair-storage numerator
    fb = qformat(10, 4)
    out = qformat(35, 6, overflow_mode=OverflowMode.SAT_ZERO)
    n = 256 * 256
    rng = np.random.RandomState(0)
    raws_a = rng.randint(-(1 << 39), 1 << 39, size=n, dtype=np.int64)
    raws_b = rng.randint(-(1 << 13), 1 << 13, size=n, dtype=np.int64)
    raws_b[raws_b == 0] = 1
    raws_b[5] = 0                     # div-by-zero wart in the mix
    a = from_raw(raws_a.astype(object), f40)
    b = from_raw(raws_b.astype(object), fb)

    RG = 8

    @jax.jit
    def dev(ah, al, bd):
        def body(i, carry):
            x = QTensor(PairArray(carry[0], carry[1]), f40)
            r = ew.qdiv(x, QTensor(bd, fb), to=out)
            return r.data.hi, r.data.lo

        x = QTensor(PairArray(ah, al), f40)
        r = ew.qdiv(x, QTensor(bd, fb), to=out)
        return jax.lax.fori_loop(0, RG - 1, body, (r.data.hi, r.data.lo))

    hi, lo = dev(a.data.hi, a.data.lo, b.data)
    jax.block_until_ready(lo)  # warm-up + sync
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < 10.0 and iters < 8:
        hi, lo = dev(hi, lo, b.data)
        iters += 1
    jax.block_until_ready(lo)
    t_dev = (time.perf_counter() - t0) / (iters * RG)

    m = 4096
    t0 = time.perf_counter()
    for x, y in zip(raws_a[:m], raws_b[:m]):
        hostops.qdiv((int(x), f40), (int(y), fb), to=out)
    t_host = (time.perf_counter() - t0) * (n / m)

    # native multiword divider vs the Python-int loop (300-bit operands)
    from qublas_tpu import native

    nat_speedup = None
    if native.available():
        import random as _random

        fa3 = qformat(200, 100)
        fb3 = qformat(180, 120)
        out3 = qformat(250, 60)
        rr = _random.Random("benchdiv")
        n3 = 2000
        A3 = np.array([rr.randint(fa3.raw_min, fa3.raw_max)
                       for _ in range(n3)], dtype=object)
        B3 = np.array([rr.randint(fb3.raw_min, fb3.raw_max) or 1
                       for _ in range(n3)], dtype=object)
        t0 = time.perf_counter()
        got = native.binary_op("div", A3, B3, fa3, fb3, out3)
        t_nat = time.perf_counter() - t0
        assert got is not None
        t0 = time.perf_counter()
        for x, y in zip(A3[:200], B3[:200]):
            hostops.qdiv((int(x), fa3), (int(y), fb3), to=out3)
        t_loop = (time.perf_counter() - t0) * (n3 / 200)
        nat_speedup = round(t_loop / t_nat, 1)

    rec = {
        "metric": "div_pair_melems",
        "value": round(n / t_dev / 1e6, 2),
        "unit": "Melem/s",
        "vs_baseline": round(t_host / t_dev, 1),  # speedup over host loop
        "native_wide_div_speedup": nat_speedup,
    }
    print(json.dumps(rec))
    return rec


def bench_native():
    """Rounds 3-4 native host engine (host-side CPU — stable, no chip):
    300-bit and 1200-bit elementwise qmul through the compiled multiword
    engine (incl. marshalling) vs the exact Python-int golden loop.
    value = Melem/s at 300 bits; vs_baseline = speedup over the loop.
    The 1200-bit row exercises the late-round-4 NL=64 instantiation."""
    import random

    from qublas_tpu import hostops, native

    if not native.available():
        rec = {"metric": "native_qmul_melems", "value": None,
               "unit": "Melem/s", "vs_baseline": None,
               "error": "no native toolchain"}
        print(json.dumps(rec))
        return rec

    def row(bits_a, bits_b, out_f, n):
        fa = qformat(bits_a[0], bits_a[1])
        fb = qformat(bits_b[0], bits_b[1])
        out = qformat(out_f[0], out_f[1])
        rng = random.Random(f"bn:{bits_a}")
        A = np.array([rng.randint(fa.raw_min, fa.raw_max)
                      for _ in range(n)], dtype=object)
        B = np.array([rng.randint(fb.raw_min, fb.raw_max)
                      for _ in range(n)], dtype=object)
        t_eng = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            got = native.binary_op("mul", A, B, fa, fb, out)
            t_eng = min(t_eng, time.perf_counter() - t0)
        assert got is not None, "config must stay on the compiled engine"
        # loop arm on a slice, scaled (the loop is O(n) in element count)
        m = max(n // 8, 64)
        t0 = time.perf_counter()
        want = [hostops.qmul((int(x), fa), (int(y), fb), to=out)[0]
                for x, y in zip(A[:m], B[:m])]
        t_loop = (time.perf_counter() - t0) * (n / m)
        assert [int(v) for v in got.reshape(-1)[:m]] == want
        return n / t_eng / 1e6, t_loop / t_eng

    mel300, speed300 = row((200, 100), (180, 120), (250, 60), 8192)
    mel1200, speed1200 = row((800, 400), (700, 500), (900, 300), 2048)
    rec = {
        "metric": "native_qmul_melems",
        "value": round(mel300, 2),
        "unit": "Melem/s",
        "vs_baseline": round(speed300, 1),   # vs the Python-int loop
        "bits": 300,
        "melems_1200bit": round(mel1200, 2),
        "vs_loop_1200bit": round(speed1200, 1),
    }
    print(json.dumps(rec))
    return rec


EXTRA = {"tree": bench_tree_gemm, "reduce": bench_reduce,
         "lut": bench_lut_gemm, "cgemm": bench_cgemm, "wide": bench_wide,
         "limb": bench_limb, "wide-gemm": bench_wide_gemm,
         "fastwide": bench_fastwide, "limbwide": bench_limbwide,
         "cgemmwide": bench_cgemm_wide, "div": bench_div,
         "native": bench_native}


def run_all() -> int:
    """Run every per-config bench and print ONE JSON document of rows.
    Each row records its own error instead of aborting the sweep."""
    rows = {}
    for name, fn in EXTRA.items():
        try:
            rows[name] = fn()
        except Exception as e:  # a broken row must not hide the others
            rows[name] = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"metric": name, "error": rows[name]["error"]}))
    print(json.dumps({"schema": 2, **device_stamp(), "rows": rows},
                     sort_keys=True))
    return 0


def main():
    require_gpu()
    configure_cache(jax)
    for arg in sys.argv[1:]:
        name = arg.lstrip("-")
        if name in EXTRA:
            EXTRA[name]()
            return 0
        if name == "all":
            return run_all()
    rng = np.random.RandomState(0)
    a_raw = jnp.asarray(
        rng.randint(FA.raw_min, FA.raw_max + 1, size=(M, K), dtype=np.int64)
        .astype(np.int8))
    b_raw = jnp.asarray(
        rng.randint(FA.raw_min, FA.raw_max + 1, size=(K, N), dtype=np.int64)
        .astype(np.int8))

    plan = exact_plan(FA, FA, WIDE, (WIDE,), K)
    assert plan is not None, "bench config must be on the int32 fast path"

    @jax.jit
    def quantized(a_data, b_data):
        return qgemul(QTensor(a_data, FA), QTensor(b_data, FA), OUT,
                      mul_to=WIDE, add_formats=(WIDE,)).data

    @jax.jit
    def roofline(a_data, b_data):
        # minimal int8 epilogue so the output can chain back as the next LHS
        return jnp.matmul(a_data, b_data,
                          preferred_element_type=jnp.int32).astype(jnp.int8)

    # interleaved A/B passes with best-of on each side, both programs
    # compiled and warm before the clock starts
    for fn in (quantized, roofline):
        jax.block_until_ready(fn(a_raw, b_raw))
    t_best_q = t_best_r = float("inf")
    pairs = 3
    for _ in range(pairs):
        t_best_q = min(t_best_q, _time(quantized, a_raw, b_raw,
                                       iters=128, budget_s=20.0))
        t_best_r = min(t_best_r, _time(roofline, a_raw, b_raw,
                                       iters=128, budget_s=20.0))
    ops = 2.0 * M * N * K
    device = None
    td_q = td_r = float("inf")
    for _ in range(2):
        td_q = min(td_q, _device_op_time(quantized, a_raw, b_raw))
        td_r = min(td_r, _device_op_time(roofline, a_raw, b_raw))
    device = {"gops": ops / td_q / 1e9, "roofline_gops": ops / td_r / 1e9,
              "ab_pairs": 2}
    rec = headline_record(ops / t_best_q / 1e9, ops / t_best_r / 1e9, pairs,
                          device_stamp(), device=device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
