#!/usr/bin/env python3
"""Deep randomized differential sweep: device paths vs the host golden model.

Heavier than the in-suite fuzz (tests/test_fuzz_differential.py): random
formats across all three storage classes (int32 lanes / 64-bit pairs /
N-limb), all 7x5 mode combos including negative int/frac bits, over
elementwise ops, tree reduce, GEMM (all dispatch paths), complex multiplies
with random tag subsets, complex GEMM with random layer shapes, and ANUS
qpoly/qapprox with adversarial breakpoints.  Every mismatch with the oracle
prints a self-contained repro line.

Usage:  python tools/deep_fuzz.py [trials-per-family]   (default 1000;
        ~2 min per 1000 on CPU).  Exit code 1 on any mismatch.

Round-2 catch: the WRP::TCPL_SAT machine-word-wrap hole in the integer-matmul
exactness proof (ops/gemm.py _identity_range) fell out of this sweep.
"""

import sys
import time
import zlib

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from qublas_tpu import anus, hostops, hostint
from qublas_tpu.complex import QComplexTensor, cmul, cmul_tf
from qublas_tpu.ops import elementwise as ew
from qublas_tpu.ops.cgemm import cgemul
from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.ops.reduce import qreduce
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import from_raw, scalar

FAILS = 0


def fail(*msg):
    global FAILS
    FAILS += 1
    print("FAIL", *msg, flush=True)


def rng_for(tag, t):
    return np.random.RandomState(zlib.crc32(f"{tag}:{t}".encode()) % (2**31))


def rand_fmt(rng, mx, mn=0):
    while True:
        i = int(rng.randint(-8, mx))
        f = int(rng.randint(-8, mx))
        if mn <= i + f <= mx:
            break
    return qformat(i, f, bool(rng.randint(0, 2)),
                   RoundMode(rng.randint(0, 7)),
                   OverflowMode(rng.randint(0, 5)))


def rand_raws(rng, fmt, n):
    lo = max(fmt.raw_min, -(1 << 62))
    hi = min(fmt.raw_max, (1 << 62) - 1)
    if hi < lo:
        hi = lo
    return np.array([int(rng.randint(lo, hi + 1)) for _ in range(n)],
                    dtype=object)


def sweep_elementwise(trials):
    for t in range(trials):
        rng = rng_for("ew", t)
        mx = [24, 48, 90][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, mx)
        to = None if rng.randint(0, 2) else rand_fmt(rng, mx)
        op = ["qmul", "qadd", "qsub", "qdiv", "qabs", "qneg",
              "qcmp", "qeq"][rng.randint(0, 8)]
        n = 16
        A, B = rand_raws(rng, fa, n), rand_raws(rng, fb, n)
        if op == "qdiv":
            B = np.array([v if v else 1 for v in B], dtype=object)
            B[3] = 0
        a, b = from_raw(A, fa), from_raw(B, fb)
        try:
            if op in ("qcmp", "qeq"):
                dev = np.asarray(getattr(ew, op)(a, b)).reshape(-1)
                for x, y, g in zip(A, B, dev):
                    want = getattr(hostops, op)((int(x), fa), (int(y), fb))
                    if (int(g) if op == "qcmp" else bool(g)) != want:
                        fail(op, fa, fb, int(x), int(y), g, want)
            elif op in ("qabs", "qneg"):
                dev = getattr(ew, op)(a)
                for x, g in zip(A, np.asarray(dev.raw(),
                                              dtype=object).reshape(-1)):
                    want, wf = getattr(hostops, op)((int(x), fa))
                    if int(g) != want or dev.fmt != wf:
                        fail(op, fa, int(x), int(g), want)
            else:
                dev = getattr(ew, op)(a, b, to=to)
                for x, y, g in zip(A, B, np.asarray(dev.raw(),
                                                    dtype=object).reshape(-1)):
                    want, wf = getattr(hostops, op)((int(x), fa),
                                                    (int(y), fb), to=to)
                    if int(g) != want or dev.fmt != wf:
                        fail(op, fa, fb, to, int(x), int(y), int(g), want)
        except Exception as e:  # noqa: BLE001 - report and continue
            fail("CRASH", op, fa, fb, to, type(e).__name__, str(e)[:150])


def sweep_reduce(trials):
    for t in range(trials):
        rng = rng_for("red", t)
        mx = [24, 48, 90][t % 3]
        fa = rand_fmt(rng, min(mx, 40))
        n = int(rng.randint(1, 24))
        layers = tuple(rand_fmt(rng, mx) for _ in range(rng.randint(0, 3)))
        A = rand_raws(rng, fa, n)
        try:
            dev = qreduce(from_raw(A, fa), layers)
            want, wf = hostops.qreduce_list([(int(v), fa) for v in A], layers)
            g = int(np.asarray(dev.raw(), dtype=object).reshape(-1)[0])
            if g != want or dev.fmt != wf:
                fail("reduce", fa, layers, n, g, want)
        except Exception as e:
            fail("CRASH reduce", fa, layers, n, type(e).__name__, str(e)[:150])


def sweep_gemm(trials):
    for t in range(trials):
        rng = rng_for("gemm", t)
        mx = [20, 40, 70][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, 16)
        out = rand_fmt(rng, mx)
        mul_to = None if rng.randint(0, 2) else rand_fmt(rng, mx + 10)
        layers = tuple(rand_fmt(rng, mx + 10)
                       for _ in range(rng.randint(0, 2)))
        # every 4th trial stretches k into streaming territory (round 3:
        # general-k ragged-tail stream + the pair-domain wide fast path)
        # with the size gate lowered so the paths actually engage
        stream_trial = t % 4 == 3
        m, n2 = 2, 2
        k = int(rng.randint(16, 90)) if stream_trial else \
            int(rng.randint(1, 10))
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        from qublas_tpu.ops import gemm as _g

        saved_gate = _g._STREAM_MIN_ELEMS
        if stream_trial:
            _g._STREAM_MIN_ELEMS = 0
        try:
            dev = qgemul(from_raw(A, fa), from_raw(B, fb), out,
                         mul_to=mul_to, add_formats=layers)
            host = hostops.qgemul(
                [[(int(A[i, j]), fa) for j in range(k)] for i in range(m)],
                [[(int(B[i, j]), fb) for j in range(n2)] for i in range(k)],
                out, mul_to=mul_to, add_formats=layers)
            gr = np.asarray(dev.raw(), dtype=object)
            for i in range(m):
                for j in range(n2):
                    if int(gr[i][j]) != host[i][j][0]:
                        fail("gemm", fa, fb, out, mul_to, layers, k,
                             int(gr[i][j]), host[i][j][0])
        except Exception as e:
            fail("CRASH gemm", fa, fb, out, mul_to, layers,
                 type(e).__name__, str(e)[:150])
        finally:
            _g._STREAM_MIN_ELEMS = saved_gate


def sweep_gemm_limbwide(trials):
    """Limb-domain wide fast dot (round 4): proof-lossless configs whose dot
    outgrows the 64-bit pair domain (wide pair operands, limb operands, limb
    outputs) must match the oracle AND the pre-round-4 route with the limb
    fast path disabled.  Formats are constructed lossless (mul_to/layers wide
    enough) so the plan exists; trials outside the limb gate are skipped and
    not counted."""
    from qublas_tpu.ops import gemm as _g
    from qublas_tpu.qformat import mul_merge

    done = 0
    for t in range(trials):
        rng = rng_for("glimb", t)
        fa = qformat(int(rng.randint(18, 40)), int(rng.randint(4, 32)),
                     bool(rng.randint(0, 2)))
        fb = qformat(int(rng.randint(18, 40)), int(rng.randint(4, 32)),
                     bool(rng.randint(0, 2)))
        pf = fa.frac_bits + fb.frac_bits
        k = int(rng.randint(2, 40))
        mul_to = qformat(fa.int_bits + fb.int_bits + 2, pf)
        layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 3,
                          pf),)
        out = rand_fmt(rng, 60)
        m, n2 = 2, 2
        mul_fmt = mul_merge(fa, fb, mul_to, False)
        plan = _g.exact_plan(fa, fb, mul_fmt, layers, k)
        if plan is None or plan.dot_interval.fits64:
            continue
        if _g.limb_dot_plan(fa, fb, out, plan, k, m, n2) is None:
            continue
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            ta, tb = from_raw(A, fa), from_raw(B, fb)
            dev = qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers)
            saved = _g._fast_gemm_limb
            _g._fast_gemm_limb = lambda *a, **kw: None
            try:
                prev = qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers)
            finally:
                _g._fast_gemm_limb = saved
            host = hostops.qgemul(
                [[(int(A[i, j]), fa) for j in range(k)] for i in range(m)],
                [[(int(B[i, j]), fb) for j in range(n2)] for i in range(k)],
                out, mul_to=mul_to, add_formats=layers)
            gr = np.asarray(dev.raw(), dtype=object)
            pr = np.asarray(prev.raw(), dtype=object)
            for i in range(m):
                for j in range(n2):
                    if int(gr[i][j]) != host[i][j][0] \
                            or int(pr[i][j]) != host[i][j][0]:
                        fail("gemm_limbwide", fa, fb, out, mul_to, layers, k,
                             int(gr[i][j]), int(pr[i][j]), host[i][j][0])
            done += 1
        except Exception as e:
            fail("CRASH gemm_limbwide", fa, fb, out, mul_to, layers,
                 type(e).__name__, str(e)[:150])
    return done


BASIC_TAGS = ["ac", "bd", "ad", "bc", "acbd", "adbc"]
TF_TAGS = ["ab", "cd", "ba", "abc", "cdb", "bad", "AB", "BC"]


def sweep_complex(trials):
    for t in range(trials):
        rng = rng_for("cplx", t)
        fr, fi = rand_fmt(rng, 20), rand_fmt(rng, 20)
        gr, gi = rand_fmt(rng, 20), rand_fmt(rng, 20)
        n = 6
        a = QComplexTensor(from_raw(rand_raws(rng, fr, n), fr),
                           from_raw(rand_raws(rng, fi, n), fi))
        b = QComplexTensor(from_raw(rand_raws(rng, gr, n), gr),
                           from_raw(rand_raws(rng, gi, n), gi))
        algo = ["basic", "tf"][rng.randint(0, 2)]
        names = BASIC_TAGS if algo == "basic" else TF_TAGS
        tags = {nm: rand_fmt(rng, 20) for nm in names
                if rng.randint(0, 3) == 0}
        fn = cmul if algo == "basic" else cmul_tf
        hfn = hostops.complex_mul_basic if algo == "basic" \
            else hostops.complex_mul_tf
        try:
            dev = fn(a, b, **tags)
            ar = np.asarray(a.real.raw(), dtype=object)
            ai = np.asarray(a.imag.raw(), dtype=object)
            br = np.asarray(b.real.raw(), dtype=object)
            bi = np.asarray(b.imag.raw(), dtype=object)
            dr = np.asarray(dev.real.raw(), dtype=object)
            di = np.asarray(dev.imag.raw(), dtype=object)
            for j in range(n):
                (wr, wrf), (wi, wif) = hfn(
                    ((int(ar[j]), fr), (int(ai[j]), fi)),
                    ((int(br[j]), gr), (int(bi[j]), gi)), **tags)
                if int(dr[j]) != wr or int(di[j]) != wi \
                        or dev.real.fmt != wrf or dev.imag.fmt != wif:
                    fail("cmul", algo, tags, j, int(dr[j]), wr,
                         int(di[j]), wi)
        except NotImplementedError:
            pass
        except Exception as e:
            fail("CRASH cmul", algo, tags, type(e).__name__, str(e)[:150])


def sweep_cgemul(trials):
    for t in range(trials):
        rng = rng_for("cg", t)
        mul_tags = {}
        if t % 3 == 2:
            # every 3rd trial constructs a lossless WIDE config (operands
            # up to ~30 bits, tags/layers wide enough that the proof
            # holds) so the limb-domain complex fast path (late round 4)
            # stays in the sweep alongside the layered path
            fr = qformat(int(rng.randint(10, 30)), int(rng.randint(4, 16)),
                         bool(rng.randint(0, 2)))
            fi = qformat(int(rng.randint(10, 30)), int(rng.randint(4, 16)),
                         bool(rng.randint(0, 2)))
            ib = max(fr.int_bits, fi.int_bits) + 1
            pf = max(fr.frac_bits, fi.frac_bits) * 2
            k = int(rng.randint(1, 20))
            w = qformat(2 * ib + 2, pf)
            acc = qformat(2 * ib + 3, pf)
            mul_tags = dict(ac=w, bd=w, ad=w, bc=w, acbd=acc, adbc=acc)
            layers = (qformat(2 * ib + k.bit_length() + 4, pf),)
            out = (rand_fmt(rng, 55), rand_fmt(rng, 55))
            algo = "basic"
            m, n2 = 2, 2
        else:
            fr, fi = rand_fmt(rng, 8), rand_fmt(rng, 8)
            m, k, n2 = 2, int(rng.randint(1, 6)), 2
            out = (rand_fmt(rng, 10), rand_fmt(rng, 10))
            layers = tuple(rand_fmt(rng, 14) if rng.randint(0, 2)
                           else (rand_fmt(rng, 14), rand_fmt(rng, 14))
                           for _ in range(rng.randint(0, 3)))
            algo = ["basic", "tf"][rng.randint(0, 2)]

        def rc(r, c):
            return QComplexTensor(
                from_raw(rand_raws(rng, fr, r * c).reshape(r, c), fr),
                from_raw(rand_raws(rng, fi, r * c).reshape(r, c), fi))

        a, b = rc(m, k), rc(k, n2)
        try:
            dev = cgemul(a, b, out, algo=algo, add_formats=layers,
                         **mul_tags)

            def rows(c):
                re = np.asarray(c.real.raw(), dtype=object)
                im = np.asarray(c.imag.raw(), dtype=object)
                return [[((int(re[i, j]), c.real.fmt),
                          (int(im[i, j]), c.imag.fmt))
                         for j in range(re.shape[1])]
                        for i in range(re.shape[0])]

            host = hostops.cgemul(rows(a), rows(b), out, algo=algo,
                                  add_formats=layers, **mul_tags)
            dr = np.asarray(dev.real.raw(), dtype=object)
            di = np.asarray(dev.imag.raw(), dtype=object)
            for i in range(m):
                for j in range(n2):
                    if int(dr[i][j]) != host[i][j][0][0] \
                            or int(di[i][j]) != host[i][j][1][0]:
                        fail("cgemul", algo, layers, k, i, j)
        except Exception as e:
            fail("CRASH cgemul", algo, layers, type(e).__name__,
                 str(e)[:150])


def sweep_anus(trials):
    def host_qpoly(xp, cps):
        acc = cps[-1]
        for a in reversed(cps[:-1]):
            m = hostops.qmul(xp, acc, to=a[1])
            acc = hostops.qadd(a, m, to=a[1])
        return acc

    for t in range(trials):
        rng = rng_for("poly", t)
        mx = [20, 44, 80][t % 3]
        fx = rand_fmt(rng, mx)
        X = rand_raws(rng, fx, 8)
        coeffs = [scalar(float(rng.randn() * (2.0 ** rng.randint(-3, 4))),
                         rand_fmt(rng, 20)) for _ in range(rng.randint(1, 4))]
        try:
            dev = anus.qpoly(from_raw(X, fx), coeffs)
            hc = [(int(np.asarray(c.raw(), dtype=object).reshape(-1)[0]),
                   c.fmt) for c in coeffs]
            for v, g in zip(X, np.asarray(dev.raw(),
                                          dtype=object).reshape(-1)):
                want, wf = host_qpoly((int(v), fx), hc)
                if int(g) != want or dev.fmt != wf:
                    fail("qpoly", fx, [c.fmt for c in coeffs], int(v),
                         int(g), want)
        except Exception as e:
            fail("CRASH qpoly", fx, type(e).__name__, str(e)[:150])

    for t in range(trials):
        rng = rng_for("appx", t)
        mx = [20, 44, 80][t % 3]
        while True:
            fx = rand_fmt(rng, mx, mn=4)
            if fx.int_bits >= 3 and fx.frac_bits >= 0:
                break
        X = rand_raws(rng, fx, 8)
        nseg = int(rng.randint(2, 4))
        bps = []
        for _ in range(nseg - 1):
            if rng.randint(0, 2):
                bps.append(float(rng.randn()
                                 * (2.0 ** rng.randint(0, min(mx + 6, 40)))))
            else:
                v = int(X[rng.randint(0, 8)])
                bps.append(hostint.raw_to_double(
                    v + int(rng.randint(-1, 2)), fx))
        bps = sorted(bps) + [float("inf")]
        segs = [anus.Segment(bp, [scalar(float(i + 1), fx)])
                for i, bp in enumerate(bps)]
        try:
            dev = anus.qapprox(from_raw(X, fx), segs)
            host = anus.qapprox(from_raw(X, QFormat(300, fx.frac_bits)),
                                segs)
            dr = np.asarray(dev.raw(), dtype=object).reshape(-1)
            hr = np.asarray(host.raw(), dtype=object).reshape(-1)
            for v, g, h in zip(X, dr, hr):
                if int(g) != int(h):
                    fail("qapprox", fx, bps[:-1], int(v), int(g), int(h))
        except Exception as e:
            fail("CRASH qapprox", fx, type(e).__name__, str(e)[:150])


def sweep_cast(trials):
    """Direct cross-format conversion (astype / converting assignment)."""
    for t in range(trials):
        rng = rng_for("cast", t)
        mx = [24, 48, 90][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, [24, 48, 90][(t + 1) % 3])
        A = rand_raws(rng, fa, 16)
        try:
            dev = from_raw(A, fa).astype(fb)
            for v, g in zip(A, np.asarray(dev.raw(),
                                          dtype=object).reshape(-1)):
                want = hostops.convert((int(v), fa), fb)[0]
                if int(g) != want:
                    fail("cast", fa, fb, int(v), int(g), want)
        except Exception as e:
            fail("CRASH cast", fa, fb, type(e).__name__, str(e)[:150])


def sweep_bitstream(trials):
    """BitStream round trips with random chunk orders (representable raws)."""
    from qublas_tpu import bitstream

    for t in range(trials):
        rng = rng_for("bits", t)
        fx = rand_fmt(rng, 40)
        if fx.width <= 0:
            continue
        n = int(rng.randint(1, 9))
        lo = max(-(1 << (fx.width - 1)) if fx.signed and fx.width > 0 else 0,
                 -(1 << 62))
        hi = min((1 << (fx.width - (1 if fx.signed else 0))) - 1
                 if fx.width > 0 else 0, (1 << 62) - 1)
        if hi < lo:
            continue
        A = np.array([int(rng.randint(lo, hi + 1)) for _ in range(n)],
                     dtype=object)

        def order(chunk_ok):
            c = rng.randint(0, 3)
            if c == 0:
                return None
            if c == 1:
                return bitstream.l2r
            d = int(rng.randint(1, 4))
            return bitstream.r2l(d) if chunk_ok % d == 0 else None

        t_ord = order(n)
        e_ord = order(fx.width)
        try:
            x = from_raw(A, fx)
            s = bitstream.to_bits(x, tensor_order=t_ord, elem_order=e_ord)
            back = bitstream.from_bits(s, fx, (n,), tensor_order=t_ord,
                                       elem_order=e_ord,
                                       twos_complement=True)
            got = [int(v) for v in np.asarray(back.raw(),
                                              dtype=object).reshape(-1)]
            if got != [int(v) for v in A]:
                fail("bits", fx, t_ord, e_ord, list(A), got)
        except Exception as e:
            fail("CRASH bits", fx, type(e).__name__, str(e)[:150])


def sweep_sharded(trials):
    """Auto-routed sharded GEMM vs single-chip, on the virtual mesh.
    Requires XLA_FLAGS=--xla_force_host_platform_device_count=8 (skipped
    otherwise)."""
    if len(jax.devices()) < 8:
        print("sharded: skipped (need 8 virtual devices; set XLA_FLAGS="
              "--xla_force_host_platform_device_count=8)", flush=True)
        return 0
    from qublas_tpu.parallel import make_mesh, shard_qgemul

    mesh = make_mesh(dp=2, tp=4)
    for t in range(trials):
        rng = rng_for("shard", t)
        m = 4
        k = int(rng.choice([4, 8, 12, 16]))
        n2 = 8
        if t % 4 == 3:
            # every 4th trial constructs a lossless wide config (mul_to /
            # layers wide enough) so auto's k_wide / k_limb (round 4)
            # strategies get exercised in the sharded sweep
            fa = qformat(int(rng.randint(14, 34)), int(rng.randint(4, 20)),
                         bool(rng.randint(0, 2)))
            fb = qformat(int(rng.randint(14, 34)), int(rng.randint(4, 20)),
                         bool(rng.randint(0, 2)))
            pf = fa.frac_bits + fb.frac_bits
            mul_to = qformat(fa.int_bits + fb.int_bits + 2, pf)
            layers = (qformat(fa.int_bits + fb.int_bits
                              + k.bit_length() + 3, pf),)
            out = rand_fmt(rng, 60)
        else:
            mx = [16, 20, 40][t % 3]
            fa, fb = rand_fmt(rng, mx), rand_fmt(rng, 12)
            out = rand_fmt(rng, mx)
            mul_to = None if rng.randint(0, 2) else rand_fmt(rng, mx + 8)
            layers = tuple(rand_fmt(rng, mx + 8)
                           for _ in range(rng.randint(0, 2)))
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            got = shard_qgemul(from_raw(A, fa), from_raw(B, fb), out, mesh,
                               mul_to=mul_to, add_formats=layers)
            ref = qgemul(from_raw(A, fa), from_raw(B, fb), out,
                         mul_to=mul_to, add_formats=layers)
            g = np.asarray(got.raw(), dtype=object).reshape(-1)
            w = np.asarray(ref.raw(), dtype=object).reshape(-1)
            if got.fmt != ref.fmt or \
                    [int(v) for v in g] != [int(v) for v in w]:
                fail("shard", fa, fb, out, mul_to, layers, k)
            if t % 2:
                # odd trials also push the explicit ppermute-pipelined
                # rings (int32 / pair / limb regime picked by the same
                # plans auto uses; n2=8 always divides tp).  A config
                # outside every pipelined gate raises ValueError -> fine.
                from qublas_tpu.parallel.sharding import (
                    _k_limb_plan, _k_wide_plan)

                ta, tb = from_raw(A, fa), from_raw(B, fb)
                if _k_limb_plan(ta, tb, out, mul_to, layers, False,
                                4) is not None:
                    strat = "k_limb_pipelined"
                elif _k_wide_plan(ta, tb, out, mul_to, layers, False,
                                  4) is not None:
                    strat = "k_wide_pipelined"
                else:
                    strat = "k_pipelined"
                try:
                    gp = shard_qgemul(ta, tb, out, mesh, mul_to=mul_to,
                                      add_formats=layers, strategy=strat)
                    gpr = np.asarray(gp.raw(), dtype=object).reshape(-1)
                    if gp.fmt != ref.fmt or \
                            [int(v) for v in gpr] != [int(v) for v in w]:
                        fail("shard_pipelined", strat, fa, fb, out,
                             mul_to, layers, k)
                except ValueError:
                    pass  # outside the strategy's gate: clean rejection
        except ValueError:
            pass  # clean host-route/config rejections are fine
        except Exception as e:
            fail("CRASH shard", fa, fb, out, mul_to, layers,
                 type(e).__name__, str(e)[:150])
    return trials


def sweep_sharded_ktree(trials):
    """Round-5 subtree-aligned K-sharding of ORDER-SENSITIVE tree GEMMs
    (``sharded_qgemul_k_tree``): random rounding/saturating configs over
    random k (power-of-2, tp-divisible, ragged, odd) vs the single-chip
    tree, on the virtual mesh.  Every config is admitted (no losslessness
    gate), so the sweep is dominated by genuinely order-sensitive trees."""
    if len(jax.devices()) < 8:
        print("sharded_ktree: skipped (need 8 virtual devices)", flush=True)
        return 0
    from qublas_tpu.parallel import make_mesh, sharded_qgemul_k_tree

    meshes = [make_mesh(dp=2, tp=4), make_mesh(dp=1, tp=8)]
    for t in range(trials):
        rng = rng_for("ktree", t)
        mesh = meshes[t % 2]
        m, n2 = 3, 4
        k = int(rng.choice([7, 8, 12, 16, 17, 24, 32, 33, 40, 64]))
        mx = [12, 16, 24][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, 12)
        out = rand_fmt(rng, mx)
        mul_to = None if rng.randint(0, 2) else rand_fmt(rng, mx + 6)
        layers = tuple(rand_fmt(rng, mx + 6)
                       for _ in range(rng.randint(0, 3)))
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            got = sharded_qgemul_k_tree(from_raw(A, fa), from_raw(B, fb),
                                        out, mesh, mul_to=mul_to,
                                        add_formats=layers)
            ref = qgemul(from_raw(A, fa), from_raw(B, fb), out,
                         mul_to=mul_to, add_formats=layers)
            g = np.asarray(got.raw(), dtype=object).reshape(-1)
            w = np.asarray(ref.raw(), dtype=object).reshape(-1)
            if got.fmt != ref.fmt or \
                    [int(v) for v in g] != [int(v) for v in w]:
                fail("ktree", fa, fb, out, mul_to, layers, k, t % 2)
            if t % 3 == 2:
                # the reduce analogue on the same order-sensitive formats
                from qublas_tpu.parallel import sharded_qreduce_k_tree

                xv = from_raw(A[0], fa)
                gr = sharded_qreduce_k_tree(xv, layers, mesh=mesh)
                rr = qreduce(xv, layers)
                if gr.fmt != rr.fmt or \
                        int(np.asarray(gr.raw(), dtype=object).reshape(())) \
                        != int(np.asarray(rr.raw(),
                                          dtype=object).reshape(())):
                    fail("ktree_reduce", fa, layers, k, t % 2)
            if t % 5 == 4:
                # the complex analogue (per-part trees, basic/tf alternate)
                from qublas_tpu.parallel import sharded_cgemul_k_tree

                algo = "tf" if t % 2 else "basic"
                ca = QComplexTensor(from_raw(A, fa),
                                    from_raw(rand_raws(rng, fa, m * k)
                                             .reshape(m, k), fa))
                cb = QComplexTensor(from_raw(B, fb),
                                    from_raw(rand_raws(rng, fb, k * n2)
                                             .reshape(k, n2), fb))
                gc = sharded_cgemul_k_tree(ca, cb, out, mesh, algo=algo,
                                           add_formats=layers)
                rc = cgemul(ca, cb, out, algo=algo, add_formats=layers)
                for part in ("real", "imag"):
                    gp = np.asarray(getattr(gc, part).raw(),
                                    dtype=object).reshape(-1)
                    wp = np.asarray(getattr(rc, part).raw(),
                                    dtype=object).reshape(-1)
                    if getattr(gc, part).fmt != getattr(rc, part).fmt or \
                            [int(v) for v in gp] != [int(v) for v in wp]:
                        fail("ktree_cgemul", algo, fa, fb, out, layers, k)
        except ValueError:
            pass  # clean host-route rejections are fine
        except Exception as e:
            fail("CRASH ktree", fa, fb, out, mul_to, layers, k,
                 type(e).__name__, str(e)[:150])
    return trials


def sweep_bitwise(trials):
    """Round-5 raw-bitwise surface (bitwise.qand/qor/qxor/qnot) across
    random mixed-width formats and storage kinds vs the Python-int
    two's-complement oracle, plus decimal round-trips."""
    import operator

    from qublas_tpu import bitwise

    ops = [("qand", operator.and_), ("qor", operator.or_),
           ("qxor", operator.xor)]
    for t in range(trials):
        rng = rng_for("bitw", t)
        mx = [12, 30, 60, 120, 400, 1100][t % 6]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, mx // (1 + t % 3) + 2)
        n = 6

        def dense(fmt):
            # FULL-width raws (rand_raws clamps to +/-2^62, which leaves
            # wide formats' high limbs as pure sign fill — r5 review);
            # every 4th trial throws in a fill(int)-wart raw beyond the
            # declared range (stored un-masked by from_raw)
            w = max(fmt.storage_bits, 2)
            vals = [int(rng.randint(0, 2)) * -1 ^
                    int.from_bytes(bytes(rng.randint(0, 256, (w + 14) // 8,
                                                     dtype=np.int64)
                                         .astype(np.uint8)), "little")
                    for _ in range(n)]
            vals = [max(min(v, fmt.raw_max), fmt.raw_min) for v in vals]
            if t % 4 == 0 and fmt.storage_bits <= 24:
                vals[0] = fmt.raw_max * 3 + 7          # wart raw
            return np.array(vals, dtype=object)

        A, B = dense(fa), dense(fb)
        a, b = from_raw(A, fa), from_raw(B, fb)
        wide = fa if fa.storage_bits >= fb.storage_bits else fb
        try:
            name, op = ops[t % 3]
            got = getattr(bitwise, name)(a, b)
            want = [op(int(x), int(y)) for x, y in zip(A, B)]
            if got.fmt != wide or \
                    [int(v) for v in np.asarray(got.raw(),
                                                dtype=object).reshape(-1)] \
                    != want:
                fail("bitwise", name, fa, fb)
            gn = bitwise.qnot(a)
            if [int(v) for v in np.asarray(gn.raw(),
                                           dtype=object).reshape(-1)] \
                    != [~int(x) for x in A]:
                fail("bitwise_not", fa)
            dec = bitwise.to_decimal(a)
            rt = bitwise.from_decimal(dec, fa)
            if [int(v) for v in np.asarray(rt.raw(),
                                           dtype=object).reshape(-1)] \
                    != [int(x) for x in A]:
                fail("bitwise_decimal_rt", fa)
        except Exception as e:
            fail("CRASH bitwise", fa, fb, type(e).__name__, str(e)[:150])
    return trials


def main():
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    t0 = time.time()
    for name, fn, n in [
        ("elementwise", sweep_elementwise, trials),
        ("cast", sweep_cast, trials),
        ("reduce", sweep_reduce, max(trials // 4, 50)),
        ("gemm", sweep_gemm, max(trials // 6, 50)),
        ("gemm_limbwide", sweep_gemm_limbwide, max(trials // 6, 50)),
        ("complex", sweep_complex, max(trials // 2, 50)),
        ("cgemul", sweep_cgemul, max(trials // 6, 50)),
        ("anus", sweep_anus, max(trials // 3, 50)),
        ("bitstream", sweep_bitstream, trials),
        ("sharded", sweep_sharded, max(trials // 10, 30)),
        ("sharded_ktree", sweep_sharded_ktree, max(trials // 10, 30)),
        ("bitwise", sweep_bitwise, max(trials // 4, 50)),
    ]:
        # sweeps report the trials they actually EXECUTED (a skipped family
        # must not inflate the headline config count — advisor r2)
        done = fn(n)
        done = n if done is None else done
        if done:
            print(f"{name}: {done} trials, {FAILS} total fails "
                  f"[{time.time() - t0:.0f}s]", flush=True)
    print(f"DEEP FUZZ DONE: {FAILS} fails in {time.time() - t0:.0f}s")
    return 1 if FAILS else 0


if __name__ == "__main__":
    sys.exit(main())
