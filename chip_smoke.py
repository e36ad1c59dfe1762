#!/usr/bin/env python3
"""Smoke run of the quantized GEMM paths on an NVIDIA GPU, bit-exact.

    python chip_smoke.py           # one card: differential, lossless, tree, wide
    python chip_smoke.py --four    # four cards: the sharded strategies only

Each phase drives the public entry points (``qgemul``, ``cgemul``,
``shard_qgemul`` ...) at the sizes of BASELINE.json's configs, with operands
drawn from a fixed seed, and compares the result with the host oracle
(``hostops`` and the native engine) at zero tolerance.  For every phase it
prints the compile time, the warm time (host clock around work that ends in
``block_until_ready``), the dispatch route, the peak device memory, and what
XLA compiled each integer dot to.  The last line of standard output is the
JSON result ``{"ok": true, "device": {...}}``; it is printed only when every
phase matched.  Without a GPU the script exits non-zero and prints no
result.  The compile cache is ``$JAX_COMPILATION_CACHE_DIR`` when set and
``.jax_cache/`` in the checkout otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# Environment: device check, compile cache, card line
# ---------------------------------------------------------------------------

def compile_cache_dir(environ=None) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` here."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or \
        os.path.join(REPO, ".jax_cache")


def configure_cache(jax) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.
    When the environment names a directory, JAX already reads it and no
    other directory is set here."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def require_gpu(count: int = 1):
    """The first ``count`` GPU devices; exits non-zero on any other
    platform (no CPU fallback)."""
    import jax

    who = os.path.basename(sys.argv[0]) or "chip_smoke.py"
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{who}: needs an NVIDIA GPU, JAX found "
                         f"{devs[0].platform!r} devices; nothing was run")
    if len(devs) < count:
        raise SystemExit(f"{who}: needs {count} GPUs, JAX found {len(devs)}")
    return devs[:count]


def parse_gpu_query(text: str):
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> [(name, power_limit)], one per card."""
    rows = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if sep and name.strip():
            rows.append((name.strip(), limit.strip()))
    return rows


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout


# ---------------------------------------------------------------------------
# Compiled-program inspection
# ---------------------------------------------------------------------------

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\w+)\[")


def _comp_name(line: str):
    """Computation name of an HLO header line, or None."""
    if line.startswith((" ", "}", "HloModule")) or not line.rstrip() \
            .endswith("{"):
        return None
    head = line.split("(", 1)[0].split()
    return head[-1].lstrip("%") if head else None


def _operand_types(call: str, types):
    """Element types of the first two operands of ``op(...)`` text."""
    names = re.findall(r"%([\w.\-]+)", call.split(")", 1)[0])
    return tuple(types.get(n, "?") for n in names[:2])


def dot_routes(hlo: str):
    """What XLA compiled each dot of an optimized HLO module to.

    Returns a list of ``(route, operand_types)``: ``cublaslt`` / ``cublas``
    (a library custom call), ``triton_gemm`` (a Triton GEMM fusion), or
    ``other:<fusion kind>`` for a dot emitted inside another fusion (or
    ``other:entry`` at top level)."""
    comps, callers, types, cur = {}, {}, {}, None
    for line in hlo.splitlines():
        name = _comp_name(line)
        if name is not None:
            cur = name
            comps[cur] = []
            continue
        if cur is None:
            continue
        comps[cur].append(line)
        m = _INSTR.match(line)
        if m:
            types[(cur, m.group(1))] = m.group(2)
        for callee in re.findall(r"calls=%?([\w.\-]+)", line):
            callers[callee] = line
    routes = []
    for comp, lines in comps.items():
        local = {n: t for (c, n), t in types.items() if c == comp}
        for line in lines:
            if "custom_call_target=\"__cublas" in line:
                kind = "cublaslt" if "$lt$" in line else "cublas"
                routes.append((kind, _operand_types(
                    line.split("custom-call(", 1)[1], local)))
            if " dot(" not in line:
                continue
            ops = _operand_types(line.split(" dot(", 1)[1], local)
            caller = callers.get(comp, "")
            if "kind=kCustom" in caller and ("triton" in caller
                                             or "gemm_fusion" in caller):
                routes.append(("triton_gemm", ops))
            else:
                m = re.search(r"kind=(k\w+)", caller)
                routes.append(("other:" + (m.group(1) if m else "entry"),
                               ops))
    return routes


def float_dots(routes):
    return [r for r in routes if any(t.startswith(("f", "bf")) for t in r[1])]


def peak_bytes(device=None):
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def compile_and_run(fn, *args):
    """jit ``fn``, compile it for ``args``, run it twice; returns
    (output, stats, optimized HLO text)."""
    import jax

    jf = jax.jit(fn)
    t0 = time.perf_counter()
    compiled = jf.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_warm = time.perf_counter() - t0
    text = compiled.as_text()
    routes = dot_routes(text)
    floats = float_dots(routes)
    if floats:
        raise AssertionError(f"float dot on an integer path: {floats}")
    return out, {"compile_s": round(t_compile, 3),
                 "warm_s": round(t_warm, 6),
                 "dots": [f"{r}{list(t)}" for r, t in routes]}, text


def tree_route(hlo: str) -> str:
    """Which tree backend a compiled order-sensitive GEMM runs."""
    if "tree_gemm_tiled" in hlo:
        return "tree_gemm_tiled"
    return "tree_gemm_scan" if "while" in hlo else "other"


def _rand(rng, fmt, shape, dtype):
    lo = max(fmt.raw_min, -(1 << 62))
    hi = min(fmt.raw_max, (1 << 62) - 1)
    return rng.integers(lo, hi + 1, size=shape, dtype=np.int64).astype(dtype)


def _assert_equal(name, got, want):
    got = np.asarray(got, dtype=np.int64)
    want = np.asarray(want, dtype=np.int64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: {bad} elements differ from the "
                             f"oracle (shape {got.shape} vs {want.shape})")


def _native_gemm(A, B, fa, fb, mul_fmt, add_formats, out_fmt):
    """The native host engine's GEMM, its rows split over threads (the
    engine releases the GIL while it runs)."""
    from concurrent.futures import ThreadPoolExecutor

    from qublas_tpu import native

    if not native.available():
        raise RuntimeError("native host engine unavailable (needs g++)")
    chunks = np.array_split(np.asarray(A), min(8, os.cpu_count() or 1,
                                               len(A)))
    with ThreadPoolExecutor(len(chunks)) as pool:
        parts = list(pool.map(lambda a: native.tree_gemm_host(
            a, B, fa, fb, mul_fmt, tuple(add_formats), out_fmt), chunks))
    if any(p is None for p in parts):
        raise RuntimeError("GEMM outside the native engine's envelope")
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# Phases (each returns a dict of facts; raising marks the phase failed)
# ---------------------------------------------------------------------------

def phase_differential():
    """Every route of tools/device_differential.py, eager and jit."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import device_differential

    fails, skips = device_differential.run_all()
    if fails:
        raise AssertionError(f"{fails} differential routes failed")
    return {"route": "all differential routes", "host_routed_skips": skips}


def phase_lossless(n=4096, strip=64, seed=0):
    """BASELINE configs 1 and 4: __graft_entry__.entry()'s chain at width n."""
    import jax.numpy as jnp

    from __graft_entry__ import _formats, entry
    from qublas_tpu.ops import gemm as G
    from qublas_tpu.qformat import mul_merge

    fwd, _ = entry()
    fa, wide, mid = _formats()
    mul_fmt = mul_merge(fa, fa, wide)
    plan = G.exact_plan(fa, fa, mul_fmt, (wide,), n)
    if plan is None or not G._device_epilogue_ok(plan, mid):
        raise AssertionError("lossless chain left the int32 fast path")
    rng = np.random.default_rng(seed)
    x, w1, w2 = (_rand(rng, fa, (n, n), np.int8) for _ in range(3))
    args = tuple(jnp.asarray(v) for v in (x, w1, w2))
    out, stats, _ = compile_and_run(fwd, *args)
    eager = np.asarray(fwd(*args))
    _assert_equal("lossless eager vs jit", eager, np.asarray(out))
    s8 = [d for d in stats["dots"] if "'s8', 's8'" in d]
    if len(s8) < 2:
        raise AssertionError(f"expected two int8 dots, got {stats['dots']}")

    from qublas_tpu.anus import build_table, sqrt_func

    table = build_table(sqrt_func, mid, mid)
    h = _native_gemm(x[:strip], w1, fa, fa, mul_fmt, (wide,), mid)
    h = np.asarray(table._raws, dtype=np.int64)[h & table._mask]
    h = _host_convert(h, mid, fa)
    y = _native_gemm(h, w2, fa, fa, mul_fmt, (wide,), mid)
    _assert_equal("lossless jit vs oracle strip", np.asarray(out)[:strip], y)
    stats.update(route="int32 fast path (int8 dots + fused requantize, "
                       "select-tree ROM)", oracle_rows=strip)
    return stats


def _host_convert(raws, src, dst):
    """Converting assignment ``src -> dst`` on the native engine."""
    from qublas_tpu import native

    out = native.requantize(np.asarray(raws, dtype=np.int64), src, dst)
    if out is None:
        raise RuntimeError("native host engine unavailable (needs g++)")
    return out


TREE_FMT_ARGS = dict(int_bits=8, frac_bits=8)


def phase_tree(shapes=((2048, 2048, 2048), (512, 2047, 512)), strip=32,
               seed=1, expect=None):
    """BASELINE config 1, canonical Qu<8,8,TRN::TCPL,SAT::ZERO>."""
    import jax
    import jax.numpy as jnp

    from qublas_tpu.ops import tree_gemm
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.qformat import OverflowMode, mul_merge, qformat
    from qublas_tpu.qtensor import QTensor

    f = qformat(overflow_mode=OverflowMode.SAT_ZERO, **TREE_FMT_ARGS)
    mul_fmt = mul_merge(f, f)
    if expect is None:
        expect = "tree_gemm_tiled" if jax.default_backend() == "gpu" \
            else "tree_gemm_scan"
    rng = np.random.default_rng(seed)
    facts = {}

    def fn(a, b):
        return qgemul(QTensor(a, f), QTensor(b, f), f).data

    for m, k, n in shapes:
        if tree_gemm.plan_hybrid(f, f, mul_fmt, (), k, f) is not None or \
                tree_gemm.plan_tree(f, f, mul_fmt, (), k, f) is None:
            raise AssertionError("canonical config left the tree path")
        A = _rand(rng, f, (m, k), np.int32)
        B = _rand(rng, f, (k, n), np.int32)
        a, b = jnp.asarray(A), jnp.asarray(B)
        out, stats, text = compile_and_run(fn, a, b)
        route = tree_route(text)
        if route != expect:
            raise AssertionError(f"tree ran {route}, expected {expect}")
        _assert_equal(f"tree {m}x{k}x{n} eager vs jit",
                      np.asarray(fn(a, b)), np.asarray(out))
        rows = min(strip, m)
        want = _native_gemm(A[:rows], B, f, f, mul_fmt, (), f)
        _assert_equal(f"tree {m}x{k}x{n} vs oracle strip",
                      np.asarray(out)[:rows], want)
        stats.update(route=route, oracle_rows=rows)
        facts[f"{m}x{k}x{n}"] = stats
    return facts


def wide_limb_shape(k=2048):
    """Largest square m = n (a multiple of 256) whose 40x40-bit digit dot
    fits ``_LIMBDOT_MAX_DOT_ELEMS`` at contraction length k."""
    from qublas_tpu.ops import gemm as G
    from qublas_tpu.qformat import mul_merge

    fa, out, kw = _wide_formats()
    plan = G.exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                        kw["add_formats"], k)
    for mn in range(8192, 0, -256):
        if G.limb_dot_plan(fa, fa, out, plan, k, mn, mn) is not None:
            return mn, k, mn
    raise AssertionError("no 40-bit digit-dot shape fits the cap")


def _wide_formats():
    from qublas_tpu.qformat import OverflowMode, RoundMode, qformat

    fa = qformat(25, 15)                     # 40-bit pair storage
    out = qformat(60, 20, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_TCPL)
    return fa, out, dict(mul_to=qformat(51, 30),
                         add_formats=(qformat(62, 30),))


def _cgemm_formats():
    from qublas_tpu.qformat import OverflowMode, qformat

    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    tags = dict(ab=mid, cd=mid, ba=mid, abc=wide, cdb=wide, bad=wide,
                AB=wide, BC=wide)
    return f, out, (wide,), tags


def phase_wide(limb_shape=None, cgemm_n=2048, strip=2, strip_cols=32,
               seed=2):
    """Proof-lossless 40x40-bit digit dot and the TF complex GEMM."""
    import jax.numpy as jnp

    from qublas_tpu import hostops
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops import cgemm as C
    from qublas_tpu.ops import gemm as G
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.ops.wideint import PairArray
    from qublas_tpu.qformat import mul_merge
    from qublas_tpu.qtensor import QTensor, from_raw

    rng = np.random.default_rng(seed)
    facts = {}

    # 40-bit x 40-bit operands, 80-bit products: the limb-digit dot
    fa, out_fmt, kw = _wide_formats()
    m, k, n = limb_shape or wide_limb_shape()
    plan = G.exact_plan(fa, fa, mul_merge(fa, fa, kw["mul_to"]),
                        kw["add_formats"], k)
    if plan is None or plan.dot_interval.fits64 or \
            G.limb_dot_plan(fa, fa, out_fmt, plan, k, m, n) is None:
        raise AssertionError("40-bit GEMM left the limb-digit dot")
    A = _rand(rng, fa, (m, k), np.int64)
    B = _rand(rng, fa, (k, n), np.int64)
    qa, qb = from_raw(A.astype(object), fa), from_raw(B.astype(object), fa)

    def limb_fn(ah, al, bh, bl):
        r = qgemul(QTensor(PairArray(ah, al), fa),
                   QTensor(PairArray(bh, bl), fa), out_fmt, **kw)
        return r.data.limbs

    args = (qa.data.hi, qa.data.lo, qb.data.hi, qb.data.lo)
    limbs, stats, _ = compile_and_run(limb_fn, *args)
    if not any("'s8', 's8'" in d for d in stats["dots"]):
        raise AssertionError(f"no int8 digit dot: {stats['dots']}")
    _assert_equal("limb eager vs jit", np.asarray(limb_fn(*args)),
                  np.asarray(limbs))
    got = _limbs_to_ints(np.asarray(limbs)[:, :strip, :strip_cols], out_fmt)
    want = hostops.qgemul(
        [[(int(v), fa) for v in row] for row in A[:strip]],
        [[(int(v), fa) for v in row[:strip_cols]] for row in B],
        out_fmt, **kw)
    want = [[c[0] for c in row] for row in want]
    if got != want:
        raise AssertionError("limb-digit GEMM differs from the oracle")
    stats.update(route="_fast_gemm_limb (balanced int8 digit dot)",
                 shape=[m, k, n])
    facts["limb_40x40"] = stats

    # TF complex GEMM on int8 lanes: _tf_int8_distributed
    f, cout, layers, tags = _cgemm_formats()
    n3 = cgemm_n
    parts = [_rand(rng, f, (n3, n3), np.int8) for _ in range(4)]
    info = {}

    def tf_fn(ar, ai, br, bi):
        r = C._fast_cgemul(
            QComplexTensor(QTensor(ar, f), QTensor(ai, f)),
            QComplexTensor(QTensor(br, f), QTensor(bi, f)),
            cout[0], cout[1], "tf", layers, layers, tags, info=info)
        public = C.cgemul(QComplexTensor(QTensor(ar, f), QTensor(ai, f)),
                          QComplexTensor(QTensor(br, f), QTensor(bi, f)),
                          cout, algo="tf", add_formats=layers, **tags)
        return r.real.data, r.imag.data, public.real.data, public.imag.data

    dparts = tuple(jnp.asarray(p) for p in parts)
    res, stats, _ = compile_and_run(tf_fn, *dparts)
    if info.get("domain") != "i32" or info.get("tf") != "int8":
        raise AssertionError(f"TF cgemul took {info}, expected the int8 "
                             f"distributed dots")
    _assert_equal("cgemul public vs fast (real)", res[2], res[0])
    _assert_equal("cgemul public vs fast (imag)", res[3], res[1])
    for e, j in zip(tf_fn(*dparts), res):
        _assert_equal("cgemul eager vs jit", np.asarray(e), np.asarray(j))
    ar, ai, br, bi = parts
    a_rows = [[((int(ar[i, p]), f), (int(ai[i, p]), f)) for p in range(n3)]
              for i in range(strip)]
    b_rows = [[((int(br[p, j]), f), (int(bi[p, j]), f))
               for j in range(strip_cols)] for p in range(n3)]
    want = hostops.cgemul(a_rows, b_rows, cout, algo="tf",
                          add_formats=layers, **tags)
    want_r = [[c[0][0] for c in row] for row in want]
    want_i = [[c[1][0] for c in row] for row in want]
    _assert_equal("cgemul real vs oracle strip",
                  np.asarray(res[2])[:strip, :strip_cols], want_r)
    _assert_equal("cgemul imag vs oracle strip",
                  np.asarray(res[3])[:strip, :strip_cols], want_i)
    stats.update(route="_tf_int8_distributed (four int8 dots)",
                 shape=[n3, n3, n3])
    facts["cgemul_tf_int8"] = stats
    return facts


def _limbs_to_ints(limbs, fmt):
    """(K, r, c) stacked uint32 limbs -> nested lists of signed ints."""
    from qublas_tpu.ops.limbint import LimbArray
    from qublas_tpu.qtensor import QTensor

    raw = QTensor(LimbArray(limbs), fmt).raw()
    return [[int(v) for v in row] for row in np.asarray(raw, dtype=object)]


SINGLE = (("differential", phase_differential),
          ("lossless", phase_lossless),
          ("tree", phase_tree),
          ("wide", phase_wide))


# ---------------------------------------------------------------------------
# Four cards: the sharded strategies against the single-card bits
# ---------------------------------------------------------------------------

def _spread(arr, devices):
    """Number of distinct devices holding shards of ``arr``."""
    return len({s.device for s in arr.addressable_shards} & set(devices))


def phase_four(devices=None, lossless_n=4096, tree_n=2048, limb_shape=None,
               cgemm_n=2048, reduce_n=1 << 20, seed=3):
    """Every sharded strategy on a (1, 4) mesh and, where dp applies, a
    (2, 2) mesh, each compared bit for bit with the jitted single-device
    call on the first device.  Prints one line per case as it passes."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _formats
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops.cgemm import cgemul
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.ops.reduce import qreduce
    from qublas_tpu.parallel import (make_mesh, shard_qgemul,
                                     sharded_cgemul_k, sharded_qreduce_k)
    from qublas_tpu.qformat import OverflowMode, qformat
    from qublas_tpu.qtensor import QTensor, from_raw

    devices = list(devices or jax.devices()[:4])
    rng = np.random.default_rng(seed)
    fa, wide, mid = _formats()
    ft = qformat(overflow_mode=OverflowMode.SAT_ZERO, **TREE_FMT_ARGS)
    fw, wout, wkw = _wide_formats()
    lm, lk, ln = limb_shape or wide_limb_shape()

    def lane(fmt, shape, dtype):
        return QTensor(jnp.asarray(_rand(rng, fmt, shape, dtype)), fmt)

    xl, wl = lane(fa, (lossless_n,) * 2, np.int8), \
        lane(fa, (lossless_n,) * 2, np.int8)
    xt, wt = lane(ft, (tree_n,) * 2, np.int32), \
        lane(ft, (tree_n,) * 2, np.int32)
    xw = from_raw(_rand(rng, fw, (lm, lk), np.int64).astype(object), fw)
    ww = from_raw(_rand(rng, fw, (lk, ln), np.int64).astype(object), fw)
    lossless = dict(out_fmt=mid, mul_to=wide, add_formats=(wide,))
    cases = [
        ("mn", xt, wt, dict(out_fmt=ft), "mn", {}),
        ("k", xl, wl, lossless, "k", {}),
        ("k_reduce_scatter", xl, wl, lossless, "k",
         {"reduce_scatter": True}),
        ("k_pipelined", xl, wl, lossless, "k_pipelined", {}),
        ("k_limb", xw, ww, dict(out_fmt=wout, **wkw), "k_limb", {}),
        ("k_tree", xt, wt, dict(out_fmt=ft, add_formats=(ft,)), "k_tree",
         {}),
    ]
    meshes = {"1x4": make_mesh(dp=1, tp=4, devices=devices),
              "2x2": make_mesh(dp=2, tp=2, devices=devices)}
    facts = {}
    for tag, a, b, fmts, strategy, extra in cases:
        kw = dict(fmts)
        out_fmt = kw.pop("out_fmt")
        t0 = time.perf_counter()
        ref = jax.jit(lambda x, y, o=out_fmt, kw=kw: qgemul(x, y, o, **kw))(
            a, b)
        ref_leaves = [np.asarray(v)
                      for v in jax.tree_util.tree_leaves(ref.data)]
        for mesh_name, mesh in meshes.items():
            if mesh_name == "2x2" and strategy != "mn":
                continue      # dp splits the batch / M only for mn
            if extra:
                from qublas_tpu.parallel import sharded_qgemul_k
                got = sharded_qgemul_k(a, b, out_fmt, mesh, **kw, **extra)
            else:
                got = shard_qgemul(a, b, out_fmt, mesh, strategy=strategy,
                                   **kw)
            leaves = jax.tree_util.tree_leaves(got.data)
            jax.block_until_ready(leaves)
            spread = min(_spread(v, devices) for v in leaves)
            if spread != 4:
                raise AssertionError(f"{tag}@{mesh_name}: output on "
                                     f"{spread} devices, expected 4")
            for g, w in zip(leaves, ref_leaves):
                _assert_equal(f"{tag}@{mesh_name} vs single device",
                              np.asarray(g), w)
            facts[f"{tag}@{mesh_name}"] = _case_done(
                f"{tag}@{mesh_name}", t0, devices)

    # complex K-sharding (TF on int8 lanes) and the K-sharded reduce
    f, cout, layers, tags = _cgemm_formats()
    ca = QComplexTensor(lane(f, (cgemm_n,) * 2, np.int8),
                        lane(f, (cgemm_n,) * 2, np.int8))
    cb = QComplexTensor(lane(f, (cgemm_n,) * 2, np.int8),
                        lane(f, (cgemm_n,) * 2, np.int8))
    t0 = time.perf_counter()
    ref = jax.jit(lambda x, y: cgemul(x, y, cout, algo="tf",
                                      add_formats=layers, **tags))(ca, cb)
    got = sharded_cgemul_k(ca, cb, cout, meshes["1x4"], algo="tf",
                           add_formats=layers, **tags)
    for part in ("real", "imag"):
        g = getattr(got, part).data
        if _spread(g, devices) != 4:
            raise AssertionError("sharded_cgemul_k output not spread")
        _assert_equal(f"sharded_cgemul_k {part}", np.asarray(g),
                      np.asarray(getattr(ref, part).data))
    facts["sharded_cgemul_k@1x4"] = _case_done("sharded_cgemul_k@1x4", t0,
                                               devices)
    # int8 Q3.4 values summed losslessly in 32-bit layers (the K-sharded
    # reduce needs the lossless proof: 2^20 * 2^3 < 2^23)
    t0 = time.perf_counter()
    xr = lane(fa, (reduce_n,), np.int8)
    red = (qformat(23, 8),)
    ref = jax.jit(lambda x: qreduce(x, red))(xr)
    got = sharded_qreduce_k(xr, red, mesh=meshes["1x4"])
    if _spread(got.data, devices) != 4:
        raise AssertionError("sharded_qreduce_k output not spread")
    _assert_equal("sharded_qreduce_k", np.asarray(got.data),
                  np.asarray(ref.data))
    facts["sharded_qreduce_k@1x4"] = _case_done("sharded_qreduce_k@1x4",
                                                t0, devices)
    return facts


def _case_done(name, t0, devices):
    facts = {"seconds_with_compile": round(time.perf_counter() - t0, 3),
             "peak_bytes": [peak_bytes(d) for d in devices]}
    print(json.dumps({"case": name, "status": "ok", **facts}), flush=True)
    return facts


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def run_phases(phases):
    """Run (name, fn) phases; print one JSON line of facts per phase.
    Returns the names of the phases that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            facts = fn()
            status = "ok"
        except Exception as e:  # noqa: BLE001 - reported, then fails the run
            traceback.print_exc()
            facts, status = {"error": f"{type(e).__name__}: {e}"}, "FAILED"
            failed.append(name)
        print(json.dumps({"phase": name, "status": status,
                          "seconds": round(time.perf_counter() - t0, 3),
                          "peak_bytes": peak_bytes(), **facts},
                         default=str), flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded strategies on four cards, "
                         "and nothing else")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    devices = require_gpu(count)

    import jax

    cache = configure_cache(jax)        # before the first compile
    events = {}
    jax.monitoring.register_event_listener(
        lambda name, **_: events.__setitem__(name, events.get(name, 0) + 1))
    sys.path.insert(0, REPO)
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"compile cache {cache}", flush=True)
    phases = [("four", lambda: phase_four(devices))] if args.four \
        else list(SINGLE)
    failed = run_phases(phases)
    print("compile cache: {} hits, {} misses of {} requests".format(
        *(events.get(f"/jax/compilation_cache/{k}", 0) for k in
          ("cache_hits", "cache_misses", "compile_requests_use_cache"))),
        flush=True)
    cards = parse_gpu_query(gpu_query())[:count]
    if not cards:
        raise SystemExit("chip_smoke: nvidia-smi listed no card")
    for name, limit in cards:
        print(f"{name}, {limit}", flush=True)
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
