"""Limb-domain complex GEMM fast path (round 4 follow-on).

Proof-lossless complex GEMMs whose dots outgrow int32 — wide pair/limb
operands, >int32 dot totals, pair/limb output storage — previously ran the
layered order-preserving path and could only shard mn.  They now collapse
to 3 (TF) or 4 (basic) balanced-digit int8 limb dots with exact limb
shift/combine epilogues (``ops/cgemm.py:_fast_cgemul`` limb branch), and
K-shard through ``sharded_cgemul_k`` with a carry-correct limb psum.
Every case must match the `hostops.cgemul` oracle bit-for-bit: the
losslessness proof makes every association/distribution order identical.
"""

import random

import numpy as np
import pytest

import jax

from qublas_tpu import from_raw, hostops, qformat
from qublas_tpu.complex import QComplexTensor
from qublas_tpu.ops.cgemm import (_fast_cgemul, _part_formats,
                                  _split_layers, cgemul)
from qublas_tpu.qformat import OverflowMode, RoundMode

F40 = qformat(25, 15)
W51 = qformat(51, 30)
ACC = qformat(52, 30)
TAGS_B = dict(ac=W51, bd=W51, ad=W51, bc=W51, acbd=ACC, adbc=ACC)
S26 = qformat(26, 15)
P52 = qformat(52, 30)
TAGS_TF = dict(ab=S26, cd=S26, ba=S26, abc=P52, cdb=P52, bad=P52,
               AB=qformat(53, 30), BC=qformat(53, 30))
LAYERS = (qformat(58, 30),)
OUT_LIMB = qformat(60, 20, round_mode=RoundMode.RND_CONV,
                   overflow_mode=OverflowMode.SAT_TCPL)
OUT_LANE = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
OUT_PAIR = qformat(40, 20, round_mode=RoundMode.RND_NEG_INF,
                   overflow_mode=OverflowMode.SAT_TCPL)


def rand_raws(fmt, n, seed):
    rng = random.Random(f"cgw:{seed}:{fmt.storage_bits}:{n}")
    return np.array([rng.randint(fmt.raw_min, fmt.raw_max)
                     for _ in range(n)], dtype=object)


def make_ops(fr, fi, m, k, n, seed):
    a = QComplexTensor(from_raw(rand_raws(fr, m * k, seed).reshape(m, k), fr),
                       from_raw(rand_raws(fi, m * k, seed + "i")
                                .reshape(m, k), fi))
    b = QComplexTensor(from_raw(rand_raws(fr, k * n, seed + "b")
                                .reshape(k, n), fr),
                       from_raw(rand_raws(fi, k * n, seed + "bi")
                                .reshape(k, n), fi))
    return a, b


def oracle(a, b, out, algo, tags, layers):
    def rows(c):
        re = np.asarray(c.real.raw(), dtype=object)
        im = np.asarray(c.imag.raw(), dtype=object)
        return [[((int(re[i, j]), c.real.fmt), (int(im[i, j]), c.imag.fmt))
                 for j in range(re.shape[1])] for i in range(re.shape[0])]

    return hostops.cgemul(rows(a), rows(b), out, algo=algo,
                          add_formats=layers, **tags)


def assert_matches(got, host):
    gr = np.asarray(got.real.raw(), dtype=object)
    gi = np.asarray(got.imag.raw(), dtype=object)
    for i in range(gr.shape[0]):
        for j in range(gr.shape[1]):
            assert int(gr[i][j]) == host[i][j][0][0], (i, j, "real")
            assert int(gi[i][j]) == host[i][j][1][0], (i, j, "imag")


def probe_domain(a, b, out, algo, tags, layers):
    info = {}
    orf, oif = _part_formats(out)
    rl, il = _split_layers(layers)
    res = _fast_cgemul(a, b, orf, oif, algo, rl, il, tags, info=info)
    return res, info.get("domain")


@pytest.mark.parametrize("algo,tags", [("basic", TAGS_B), ("tf", TAGS_TF)])
@pytest.mark.parametrize("out", [OUT_LIMB, OUT_LANE, OUT_PAIR])
def test_wide_pair_operands(algo, tags, out):
    """40-bit pair operands (80-bit products) across all output storages:
    the limb domain engages and matches the oracle."""
    a, b = make_ops(F40, F40, 2, 8, 3, f"{algo}:{out.storage_bits}")
    res, domain = probe_domain(a, b, out, algo, tags, LAYERS)
    assert res is not None and domain == "limb"
    got = cgemul(a, b, out, algo=algo, add_formats=LAYERS, **tags)
    assert_matches(got, oracle(a, b, out, algo, tags, LAYERS))


def test_lane_operands_wide_dot():
    """int16 lanes whose DOT outgrows int32 (k=64): previously slow-path,
    now the limb-digit dot."""
    f13 = qformat(13, 0)
    w = qformat(27, 0)
    acc = qformat(28, 0)
    tags = dict(ac=w, bd=w, ad=w, bc=w, acbd=acc, adbc=acc)
    layers = (qformat(40, 0),)
    out = qformat(25, 0, overflow_mode=OverflowMode.SAT_TCPL)
    a, b = make_ops(f13, f13, 2, 64, 3, "lane64")
    res, domain = probe_domain(a, b, out, "basic", tags, layers)
    assert res is not None and domain == "limb"
    got = cgemul(a, b, out, algo="basic", add_formats=layers, **tags)
    assert_matches(got, oracle(a, b, out, "basic", tags, layers))


def test_i32_path_still_preferred():
    """A config inside int32 must keep taking the i32 fast path."""
    f34 = qformat(3, 4)
    w = qformat(20, 8)
    t8 = qformat(8, 8)
    tags = dict(ac=t8, bd=t8, ad=t8, bc=t8, acbd=w, adbc=w)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    a, b = make_ops(f34, f34, 2, 4, 3, "i32")
    res, domain = probe_domain(a, b, out, "basic", tags, (w,))
    assert res is not None and domain == "i32"


def test_order_sensitive_stays_slow():
    """No lossless proof -> the fast dispatch refuses (both domains) and
    the layered path still matches the oracle."""
    f = qformat(25, 15)
    a, b = make_ops(f, f, 2, 4, 2, "slow")
    res, domain = probe_domain(a, b, f, "basic", {}, ())
    assert res is None and domain is None
    got = cgemul(a, b, f)
    assert_matches(got, oracle(a, b, f, "basic", {}, ()))


@pytest.mark.parametrize("trial", range(4))
def test_wide_cgemul_fuzz(trial):
    """Random lossless wide complex configs vs the oracle."""
    rng = np.random.RandomState(9200 + trial)
    fr = qformat(int(rng.randint(18, 30)), int(rng.randint(8, 16)))
    fi = qformat(int(rng.randint(18, 30)), int(rng.randint(8, 16)))
    ib = max(fr.int_bits, fi.int_bits) + 1
    pf = max(fr.frac_bits, fi.frac_bits) * 2
    k = int(rng.choice([4, 8, 16]))
    w = qformat(2 * ib + 2, pf)
    acc = qformat(2 * ib + 3, pf)
    tags = dict(ac=w, bd=w, ad=w, bc=w, acbd=acc, adbc=acc)
    layers = (qformat(2 * ib + k.bit_length() + 4, pf),)
    out = qformat(int(rng.randint(20, 55)), int(rng.randint(0, 12)),
                  round_mode=RoundMode(int(rng.randint(0, 7))),
                  overflow_mode=OverflowMode(int(rng.choice([0, 1, 2, 3]))))
    a, b = make_ops(fr, fi, 2, k, 3, f"fz{trial}")
    res, domain = probe_domain(a, b, out, "basic", tags, layers)
    if res is None:
        pytest.skip("config outside the fast envelope")
    got = cgemul(a, b, out, algo="basic", add_formats=layers, **tags)
    assert_matches(got, oracle(a, b, out, "basic", tags, layers))


# ---------------------------------------------------------------------------
# K-sharded wide complex GEMM
# ---------------------------------------------------------------------------

def _mesh_or_skip():
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    from qublas_tpu.parallel import make_mesh

    return make_mesh(dp=2, tp=4)


@pytest.mark.parametrize("algo,tags", [("basic", TAGS_B), ("tf", TAGS_TF)])
def test_sharded_k_wide_cgemul(algo, tags):
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_cgemul_k

    a, b = make_ops(F40, F40, 2, 8, 3, f"sh{algo}")
    got = sharded_cgemul_k(a, b, OUT_LIMB, mesh, algo=algo,
                           add_formats=LAYERS, **tags)
    assert got.real.is_limb
    assert_matches(got, oracle(a, b, OUT_LIMB, algo, tags, LAYERS))


def test_sharded_k_wide_cgemul_pair_out():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_cgemul_k

    a, b = make_ops(F40, F40, 2, 8, 3, "shpair")
    got = sharded_cgemul_k(a, b, OUT_PAIR, mesh, algo="basic",
                           add_formats=LAYERS, **TAGS_B)
    assert got.real.is_pair
    assert_matches(got, oracle(a, b, OUT_PAIR, "basic", TAGS_B, LAYERS))


@pytest.mark.parametrize("rs", [False, True])
def test_sharded_k_wide_cgemul_reduce_scatter(rs):
    """psum AND psum_scatter (N-sharded output) forms of the wide complex
    K-strategy must match the single-chip bits."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_cgemul_k

    a, b = make_ops(F40, F40, 2, 8, 8, f"shrs{rs}")
    got = sharded_cgemul_k(a, b, OUT_LIMB, mesh, algo="basic",
                           add_formats=LAYERS, reduce_scatter=rs, **TAGS_B)
    assert_matches(got, oracle(a, b, OUT_LIMB, "basic", TAGS_B, LAYERS))


def test_sharded_k_i32_cgemul_reduce_scatter():
    """reduce_scatter on the int32-domain complex K-strategy (TF algo)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_cgemul_k

    f34 = qformat(3, 4)
    w = qformat(20, 8)
    mid = qformat(5, 4)
    tags = dict(ab=mid, cd=mid, ba=mid, abc=w, cdb=w, bad=w, AB=w, BC=w)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    a, b = make_ops(f34, f34, 2, 8, 8, "shi32rs")
    got = sharded_cgemul_k(a, b, out, mesh, algo="tf", add_formats=(w,),
                           reduce_scatter=True, **tags)
    assert_matches(got, oracle(a, b, out, "tf", tags, (w,)))


def test_sharded_cgemul_dp_batched():
    """Batch-sharded complex GEMM (dp over the whole mesh): bit-exact for
    every config, wide operands included (each chip runs its batch slice's
    full GEMMs)."""
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_cgemul, sharded_cgemul_dp

    B, m, k, n = 8, 2, 4, 3

    def mk(shape, seed):
        tot = int(np.prod(shape))
        return QComplexTensor(
            from_raw(rand_raws(F40, tot, seed).reshape(shape), F40),
            from_raw(rand_raws(F40, tot, seed + "i").reshape(shape), F40))

    a, b = mk((B, m, k), "dpa"), mk((B, k, n), "dpb")
    got = sharded_cgemul_dp(a, b, OUT_LIMB, mesh, algo="basic",
                            add_formats=LAYERS, **TAGS_B)
    ref = cgemul(a, b, OUT_LIMB, algo="basic", add_formats=LAYERS, **TAGS_B)
    for part in ("real", "imag"):
        g = np.asarray(getattr(got, part).raw(), dtype=object).reshape(-1)
        w = np.asarray(getattr(ref, part).raw(), dtype=object).reshape(-1)
        assert [int(v) for v in g] == [int(v) for v in w], part
    # auto routes batched inputs to dp
    got2 = sharded_cgemul(a, b, OUT_LIMB, mesh, algo="basic",
                          add_formats=LAYERS, **TAGS_B)
    for part in ("real", "imag"):
        g = np.asarray(getattr(got2, part).raw(), dtype=object).reshape(-1)
        w = np.asarray(getattr(ref, part).raw(), dtype=object).reshape(-1)
        assert [int(v) for v in g] == [int(v) for v in w], part


def test_sharded_auto_routes_wide_to_k():
    mesh = _mesh_or_skip()
    from qublas_tpu.parallel import sharded_cgemul

    a, b = make_ops(F40, F40, 2, 8, 3, "shauto")
    got = sharded_cgemul(a, b, OUT_LANE, mesh, algo="basic",
                         add_formats=LAYERS, **TAGS_B)
    assert_matches(got, oracle(a, b, OUT_LANE, "basic", TAGS_B, LAYERS))
