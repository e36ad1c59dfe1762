#!/usr/bin/env python3
"""On-device differential sweep: device paths, eager AND jitted, vs oracle.

The CPU test suite (tests/conftest.py forces the cpu platform) cannot see
backend miscompiles: a limb-dot fast path once was bit-exact eager but
WRONG under ``jax.jit`` on an accelerator (XLA fused the int32->limb
conversion chain into lshl's shift/or network and corrupted high digits).
This tool closes that blind spot: a curated config per device route, each
executed on the default platform both op-by-op and under one ``jit``, and
both results compared bit-for-bit against the `hostops` oracle.

Curated rather than randomized: every distinct (op, formats, shape) is one
compile, so the sweep pins one representative config per dispatch route
instead of thousands.  ``chip_smoke.py`` runs it as its first phase.

Usage:  python tools/device_differential.py          # ~40 compiles
Exit code 1 on any mismatch.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

from qublas_tpu import anus, hostops
from qublas_tpu.complex import QComplexTensor
from qublas_tpu.ops import elementwise as ew
from qublas_tpu.ops.cgemm import cgemul
from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.ops.reduce import qreduce
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import QTensor, from_raw

FAILS = 0
SKIPS = 0


def _raws(fmt, n, seed):
    import random

    rng = random.Random(f"devdiff:{seed}:{fmt.storage_bits}:{n}")
    lo = max(fmt.raw_min, -(1 << 62))
    hi = min(fmt.raw_max, (1 << 62) - 1)
    return np.array([rng.randint(lo, max(hi, lo)) for _ in range(n)],
                    dtype=object)


def _ints(t: QTensor):
    return [int(v) for v in np.asarray(t.raw(), dtype=object).reshape(-1)]


def check(name, fn, args, out_fmt, want, fmt_want=None):
    """Run ``fn(*args)`` (raw leaves -> raw leaves) eager and jitted on the
    default platform; both must reproduce the oracle ints ``want``."""
    global FAILS, SKIPS
    t0 = time.time()
    try:
        eager = _ints(QTensor(fn(*args), out_fmt))
        jitted = _ints(QTensor(jax.jit(fn)(*args), out_fmt))
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        SKIPS += 1
        print(f"SKIP {name}: host-routed (not jittable by design)",
              flush=True)
        return
    except Exception as e:  # noqa: BLE001 - a crash is a failure
        FAILS += 1
        print(f"FAIL {name}: CRASH {type(e).__name__}: {str(e)[:200]}",
              flush=True)
        return
    dt = time.time() - t0
    if eager != want:
        FAILS += 1
        print(f"FAIL {name}: EAGER diverges from oracle\n"
              f"  got  {eager}\n  want {want}", flush=True)
    elif jitted != want:
        FAILS += 1
        print(f"FAIL {name}: JIT diverges (eager exact -> backend "
              f"miscompile)\n  got  {jitted}\n  want {want}", flush=True)
    else:
        print(f"PASS {name} ({dt:.1f}s)", flush=True)


# ---------------------------------------------------------------------------
# elementwise — one config per storage route (lane / pair / limb)
# ---------------------------------------------------------------------------

def run_elementwise():
    cases = [
        # lane: int8/int16 operands, int32 intermediates
        ("ew.lane", qformat(7, 8), qformat(7, 8),
         qformat(10, 10, round_mode=RoundMode.RND_CONV),
         ("qadd", "qsub", "qmul", "qdiv")),
        # pair: 40-bit pair A, lane B
        ("ew.pair", qformat(30, 9), qformat(7, 8),
         qformat(36, 10, overflow_mode=OverflowMode.SAT_TCPL),
         ("qadd", "qsub", "qmul", "qdiv")),
        # limb: 71-bit stacked-limb A
        ("ew.limb", qformat(40, 30), qformat(8, 6),
         qformat(45, 30, round_mode=RoundMode.RND_ZERO),
         ("qadd", "qsub", "qmul", "qdiv")),
    ]
    for tag, fa, fb, to, ops in cases:
        n = 8
        A, B = _raws(fa, n, tag + "a"), _raws(fb, n, tag + "b")
        B = np.array([v if v else 1 for v in B], dtype=object)
        B[3] = 0                      # div-by-zero -> 0 semantics in the mix
        a, b = from_raw(A, fa), from_raw(B, fb)
        for op in ops:
            host = [getattr(hostops, op)((int(x), fa), (int(y), fb), to=to)
                    for x, y in zip(A, B)]
            want = [w for (w, _) in host]
            wf = host[0][1]
            check(f"{tag}.{op}",
                  lambda da, db, op=op: getattr(ew, op)(
                      QTensor(da, fa), QTensor(db, fb), to=to).data,
                  (a.data, b.data), wf, want)


# ---------------------------------------------------------------------------
# casts — requantize across storage transitions and modes
# ---------------------------------------------------------------------------

def run_casts():
    cases = [
        ("cast.lane->pair", qformat(7, 8),
         qformat(40, 10, round_mode=RoundMode.RND_CONV)),
        ("cast.pair->lane", qformat(30, 9),
         qformat(10, 5, overflow_mode=OverflowMode.SAT_ZERO)),
        ("cast.pair->limb", qformat(30, 9),
         qformat(60, 20, round_mode=RoundMode.RND_NEG_INF)),
        ("cast.limb->lane", qformat(40, 30),
         qformat(10, 5, round_mode=RoundMode.TRN_SMGN,
                 overflow_mode=OverflowMode.SAT_SMGN)),
        ("cast.limb->limb", qformat(40, 30),
         qformat(50, 40, overflow_mode=OverflowMode.WRP_TCPL)),
        ("cast.limb->pair", qformat(40, 30),
         qformat(33, 20, overflow_mode=OverflowMode.WRP_TCPL_SAT)),
    ]
    for tag, fa, fb in cases:
        A = _raws(fa, 8, tag)
        a = from_raw(A, fa)
        want = [hostops.convert((int(v), fa), fb)[0] for v in A]
        check(tag, lambda d: QTensor(d, fa).astype(fb).data,
              (a.data,), fb, want)


# ---------------------------------------------------------------------------
# layered reduce — lane / pair / limb regimes
# ---------------------------------------------------------------------------

def run_reduce():
    cases = [
        ("reduce.lane", qformat(7, 8), (qformat(12, 8), qformat(16, 8))),
        ("reduce.pair", qformat(28, 0), (qformat(36, 0),)),
        ("reduce.limb", qformat(40, 28), (qformat(78, 28),)),
    ]
    for tag, fa, layers in cases:
        n = 16
        A = _raws(fa, n, tag)
        a = from_raw(A, fa)
        want, wf = hostops.qreduce_list([(int(v), fa) for v in A], layers)
        check(tag, lambda d: qreduce(QTensor(d, fa), layers).data,
              (a.data,), wf, [want])


# ---------------------------------------------------------------------------
# GEMM — one config per dispatch route
# ---------------------------------------------------------------------------

def _gemm_case(tag, fa, fb, out, mul_to, layers, m, k, n, stream=False):
    A = _raws(fa, m * k, tag + "a").reshape(m, k)
    B = _raws(fb, k * n, tag + "b").reshape(k, n)
    host = hostops.qgemul(
        [[(int(A[i][j]), fa) for j in range(k)] for i in range(m)],
        [[(int(B[i][j]), fb) for j in range(n)] for i in range(k)],
        out, mul_to=mul_to, add_formats=layers)
    want = [r for row in host for (r, _) in row]
    a, b = from_raw(A, fa), from_raw(B, fb)

    def fn(da, db):
        from contextlib import ExitStack

        from qublas_tpu.ops import gemm as _g

        with ExitStack() as st:
            if stream:
                st.enter_context(_g.stream_gate(0))  # trace-time static
            return qgemul(QTensor(da, fa), QTensor(db, fb), out,
                          mul_to=mul_to, add_formats=layers).data

    check(tag, fn, (a.data, b.data), out, want)


def run_gemm():
    f34 = qformat(3, 4)
    w = qformat(20, 8)
    # int32 integer-matmul fast path + fused epilogue
    _gemm_case("gemm.mxu_i32", f34, f34,
               qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
               w, (w,), 4, 16, 4)
    # pair-domain wide dot (lane operands, >int32 dot)
    _gemm_case("gemm.pair_wide", qformat(13, 0), qformat(13, 0),
               qformat(25, 0, overflow_mode=OverflowMode.SAT_TCPL),
               qformat(27, 0), (qformat(33, 0),), 4, 64, 4)
    # limb-digit wide dot (pair operands, >64-bit dot)
    _gemm_case("gemm.limb_digit", qformat(25, 15), qformat(25, 15),
               qformat(60, 20, round_mode=RoundMode.RND_CONV,
                       overflow_mode=OverflowMode.SAT_TCPL),
               qformat(51, 30), (qformat(57, 30),), 3, 16, 4)
    # order-sensitive tree (saturating accumulate): the tiled kernel on
    # the GPU, the scan elsewhere
    f88z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    _gemm_case("gemm.tree", f88z, f88z, f88z, None, (), 4, 8, 4)
    # general-k stream (odd k, ragged tail subtree)
    _gemm_case("gemm.stream", f88z, f88z, f88z, None, (), 2, 33, 2,
               stream=True)


# ---------------------------------------------------------------------------
# complex GEMM + ANUS LUT
# ---------------------------------------------------------------------------

def run_cgemm():
    fa = qformat(3, 4)
    w = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    f40 = qformat(25, 15)
    w51 = qformat(51, 30)
    acc = qformat(52, 30)
    s26 = qformat(26, 15)
    p52 = qformat(52, 30)
    outw = (qformat(60, 20, round_mode=RoundMode.RND_CONV,
                    overflow_mode=OverflowMode.SAT_TCPL),) * 2
    cases = [
        # int32 fast path
        ("cgemm.basic", fa, out, "basic",
         dict(ac=mid, bd=mid, ad=mid, bc=mid, acbd=w, adbc=w,
              add_formats=(w,))),
        ("cgemm.tf", fa, out, "tf",
         dict(ab=mid, cd=mid, ba=mid, abc=w, cdb=w, bad=w, AB=w, BC=w,
              add_formats=(w,))),
        # limb-domain wide path: 40-bit pair operands, 80-bit products
        ("cgemm.basic_wide", f40, outw, "basic",
         dict(ac=w51, bd=w51, ad=w51, bc=w51, acbd=acc, adbc=acc,
              add_formats=(qformat(58, 30),))),
        ("cgemm.tf_wide", f40, outw, "tf",
         dict(ab=s26, cd=s26, ba=s26, abc=p52, cdb=p52, bad=p52,
              AB=qformat(53, 30), BC=qformat(53, 30),
              add_formats=(qformat(58, 30),))),
    ]
    m, k, n = 2, 4, 2
    global FAILS
    for tag, fop, outf, algo, kw in cases:
        Ar = _raws(fop, m * k, tag + "a").reshape(m, k)
        Ai = _raws(fop, m * k, tag + "b").reshape(m, k)
        Br = _raws(fop, k * n, tag + "c").reshape(k, n)
        Bi = _raws(fop, k * n, tag + "d").reshape(k, n)
        ca = QComplexTensor(from_raw(Ar, fop), from_raw(Ai, fop))
        cb = QComplexTensor(from_raw(Br, fop), from_raw(Bi, fop))
        ref = cgemul(ca, cb, outf, algo=algo, **kw)   # eager reference
        want = _ints(ref.real) + _ints(ref.imag)

        def fn(dar, dai, dbr, dbi, fop=fop, outf=outf, algo=algo, kw=kw):
            r = cgemul(QComplexTensor(QTensor(dar, fop), QTensor(dai, fop)),
                       QComplexTensor(QTensor(dbr, fop), QTensor(dbi, fop)),
                       outf, algo=algo, **kw)
            return (r.real.data, r.imag.data)

        t0 = time.time()
        try:
            jr = jax.jit(fn)(ca.real.data, ca.imag.data,
                             cb.real.data, cb.imag.data)
            got = _ints(QTensor(jr[0], ref.real.fmt)) \
                + _ints(QTensor(jr[1], ref.imag.fmt))
        except Exception as e:  # noqa: BLE001
            FAILS += 1
            print(f"FAIL {tag}: CRASH {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)
            continue
        if got != want:
            FAILS += 1
            print(f"FAIL {tag}: JIT diverges from eager", flush=True)
        else:
            print(f"PASS {tag} ({time.time() - t0:.1f}s)", flush=True)


def run_bitwise():
    """Round-5 raw-bitwise surface: pair ^ limb on-device vs Python ints
    (the two's-complement oracle), eager + jit."""
    from qublas_tpu import bitwise

    fp, fl = qformat(30, 9), qformat(50, 29)
    A = _raws(fp, 8, "bwa")
    B = _raws(fl, 8, "bwb")
    a, b = from_raw(A, fp), from_raw(B, fl)
    want = [int(x) ^ int(y) for x, y in zip(A, B)]

    def fn(ah, al, bl):
        from qublas_tpu.ops.limbint import LimbArray
        from qublas_tpu.ops.wideint import PairArray

        r = bitwise.qxor(QTensor(PairArray(ah, al), fp),
                         QTensor(LimbArray(bl), fl))
        return r.data.limbs

    from qublas_tpu.ops.limbint import LimbArray

    check("bitwise.pair_xor_limb",
          lambda ah, al, bl: LimbArray(fn(ah, al, bl)),
          (a.data.hi, a.data.lo, b.data.limbs), fl, want)


def run_anus():
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = anus.build_table(anus.sqrt_func, mid, mid)
    X = _raws(mid, 16, "lut")
    x = from_raw(X, mid)
    ref = table(x)                                   # eager reference
    want = _ints(ref)
    check("anus.lut_select_tree",
          lambda d: table(QTensor(d, mid)).data,
          (x.data,), ref.fmt, want)


def run_sharded():
    """shard_map programs on a 1x1 mesh of the real device: a tp=1 ring /
    psum is a legitimate single-device execution of the sharded code
    paths (the limb-dot miscompile once reproduced through exactly this
    route before it showed anywhere else)."""
    from qublas_tpu.parallel import make_mesh, shard_qgemul

    mesh = make_mesh(dp=1, tp=1)
    cases = [
        # int32 K-psum + its ppermute ring
        ("shard.k", "k", qformat(3, 4), qformat(3, 4),
         qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(20, 8), (qformat(20, 8),), 4, 16, 4),
        ("shard.k_pipelined", "k_pipelined", qformat(3, 4), qformat(3, 4),
         qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(20, 8), (qformat(20, 8),), 4, 16, 4),
        # pair-domain psum + ring
        ("shard.k_wide", "k_wide", qformat(30, 9), qformat(7, 8),
         qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(40, 17), (qformat(45, 17),), 4, 16, 8),
        ("shard.k_wide_pipelined", "k_wide_pipelined",
         qformat(30, 9), qformat(7, 8),
         qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(40, 17), (qformat(45, 17),), 4, 16, 8),
        # limb-domain psum + ring (beyond-pair dots)
        ("shard.k_limb", "k_limb", qformat(25, 15), qformat(25, 15),
         qformat(60, 20, round_mode=RoundMode.RND_CONV,
                 overflow_mode=OverflowMode.SAT_TCPL),
         qformat(51, 30), (qformat(57, 30),), 3, 16, 8),
        ("shard.k_limb_pipelined", "k_limb_pipelined",
         qformat(25, 15), qformat(25, 15),
         qformat(60, 20, round_mode=RoundMode.RND_CONV,
                 overflow_mode=OverflowMode.SAT_TCPL),
         qformat(51, 30), (qformat(57, 30),), 3, 16, 8),
        # round 5: subtree-aligned K-sharding of the ORDER-SENSITIVE tree
        # (all_gather'ed node values + shifted-format top fold); power-of-2
        # and ragged k
        ("shard.k_tree", "k_tree",
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         None, (qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),),
         4, 16, 4),
        ("shard.k_tree_ragged", "k_tree",
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         None, (qformat(9, 6, round_mode=RoundMode.RND_CONV),),
         3, 21, 4),
        # M/N tiles of the order-sensitive tree: the tiled kernel inside
        # shard_map on the GPU
        ("shard.mn", "mn",
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
         None, (), 4, 19, 4),
    ]
    global FAILS
    for tag, strat, fa, fb, out, mul_to, layers, m, k, n in cases:
        A = _raws(fa, m * k, tag + "a").reshape(m, k)
        B = _raws(fb, k * n, tag + "b").reshape(k, n)
        host = hostops.qgemul(
            [[(int(A[i][j]), fa) for j in range(k)] for i in range(m)],
            [[(int(B[i][j]), fb) for j in range(n)] for i in range(k)],
            out, mul_to=mul_to, add_formats=layers)
        want = [r for row in host for (r, _) in row]
        t0 = time.time()
        try:
            got = shard_qgemul(from_raw(A, fa), from_raw(B, fb), out, mesh,
                               mul_to=mul_to, add_formats=layers,
                               strategy=strat)
            g = _ints(got)
        except Exception as e:  # noqa: BLE001
            FAILS += 1
            print(f"FAIL {tag}: CRASH {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
            continue
        if g != want:
            FAILS += 1
            print(f"FAIL {tag}: diverges from oracle\n"
                  f"  got  {g}\n  want {want}", flush=True)
        else:
            print(f"PASS {tag} ({time.time() - t0:.1f}s)", flush=True)


def run_sharded_ktree_complex():
    """Complex/reduce k_tree on the 1x1 mesh: the q==1 branch runs the
    LOCAL single-device cgemul (fast dispatch) inside shard_map — the same
    route class that caught the limb-dot miscompile."""
    from qublas_tpu.parallel import (make_mesh, sharded_cgemul_k_tree,
                                     sharded_qreduce_k_tree)
    from qublas_tpu.ops.reduce import qreduce

    global FAILS
    mesh = make_mesh(dp=1, tp=1)
    f = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    out = (f, qformat(5, 3, round_mode=RoundMode.RND_CONV))
    kw = dict(algo="tf", add_formats=(qformat(6, 4),))
    Ar = _raws(f, 3 * 32, "ckta").reshape(3, 32)
    Ai = _raws(f, 3 * 32, "cktb").reshape(3, 32)
    Br = _raws(f, 32 * 4, "cktc").reshape(32, 4)
    Bi = _raws(f, 32 * 4, "cktd").reshape(32, 4)
    ca = QComplexTensor(from_raw(Ar, f), from_raw(Ai, f))
    cb = QComplexTensor(from_raw(Br, f), from_raw(Bi, f))
    t0 = time.time()
    try:
        got = sharded_cgemul_k_tree(ca, cb, out, mesh, **kw)
        ref = cgemul(ca, cb, out, **kw)
        ok = (_ints(got.real) == _ints(ref.real)
              and _ints(got.imag) == _ints(ref.imag))
        xv = from_raw(_raws(f, 32, "ckte"), f)
        gr = sharded_qreduce_k_tree(xv, (f,), mesh=mesh)
        rr = qreduce(xv, (f,))
        ok = ok and _ints(gr) == _ints(rr) and gr.fmt == rr.fmt
    except Exception as e:  # noqa: BLE001
        FAILS += 1
        print(f"FAIL shard.cgemul+reduce_k_tree: CRASH {type(e).__name__}: "
              f"{str(e)[:200]}", flush=True)
        return
    if not ok:
        FAILS += 1
        print("FAIL shard.cgemul+reduce_k_tree: diverges from single-chip",
              flush=True)
    else:
        print(f"PASS shard.cgemul+reduce_k_tree ({time.time() - t0:.1f}s)",
              flush=True)


ROUTES = (run_elementwise, run_casts, run_reduce, run_gemm, run_cgemm,
          run_anus, run_bitwise, run_sharded, run_sharded_ktree_complex)


def run_all():
    """Run every route; returns (failures, host-routed skips)."""
    global FAILS, SKIPS
    FAILS = SKIPS = 0
    for route in ROUTES:
        route()
    return FAILS, SKIPS


def main():
    t0 = time.time()
    print("platform:", jax.devices()[0].platform,
          jax.devices()[0].device_kind, flush=True)
    fails, skips = run_all()
    print(f"done in {time.time() - t0:.0f}s — "
          f"{'ALL CLEAN' if not fails else f'{fails} FAILURES'}"
          f" ({skips} host-routed skips)", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
