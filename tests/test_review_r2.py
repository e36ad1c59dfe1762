"""Regressions for the round-2 code-review findings."""

import numpy as np
import pytest

from qublas_tpu import anus, hostops, native
from qublas_tpu.ops import elementwise as ew
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import from_raw, scalar


def test_qapprox_on_pair_storage():
    """qapprox must run on 33..64-bit (PairArray) tensors — pair-domain
    select chain, same answers as the exact host path."""
    f40 = QFormat(30, 9)
    f100 = QFormat(100, 9)
    vals = [123456789012, -5, 1 << 20, 0, -(1 << 35)]

    def segs(fmt):
        return [anus.Segment(0.0, [scalar(1.0, fmt)]),
                anus.Segment(1000.0, [scalar(2.0, fmt)]),
                anus.Segment(1e12, [scalar(3.0, fmt)])]

    dev = anus.qapprox(from_raw(np.array(vals, dtype=object), f40),
                       segs(f40))
    assert dev.is_pair
    host = anus.qapprox(from_raw(np.array(vals, dtype=object), f100),
                        segs(f100))
    np.testing.assert_array_equal(dev.to_double(), host.to_double())


def test_qapprox_constant_segments_broadcast():
    """Single-coefficient (constant) segments produce scalar branches that
    must broadcast to the input's shape on every path."""
    f = qformat(4, 4)
    x = from_raw([-20, 5, 100], f)
    r = anus.qapprox(x, [anus.Segment(0.0, [scalar(-1.0, f)]),
                         anus.Segment(1.0, [scalar(0.5, f)]),
                         anus.Segment(10.0, [scalar(7.0, f)])])
    np.testing.assert_array_equal(r.to_double(), [-1.0, 0.5, 7.0])


def test_qtable_wrp_tcpl_sat_entries_not_truncated():
    """WRP_TCPL_SAT table entries legally exceed the declared width
    (identity stub + machine-word wrap) — the packed select tree must not
    truncate them."""
    t = anus.QTable(lambda v: v * 100.0, qformat(3, 4),
                    qformat(3, 4, overflow_mode=OverflowMode.WRP_TCPL_SAT))
    x = from_raw(list(range(-40, 40)), qformat(3, 4))
    got = np.asarray(t(x).raw())
    for raw, g in zip(range(-40, 40), got):
        assert int(g) == t._raws[raw & 0xFF], raw


@pytest.mark.skipif(not native.available(), reason="no native engine")
def test_native_envelope_uses_actual_value_widths():
    """fill(int)-wart raws exceeding their format's storage must not be
    silently wrapped by the native engines' width proofs."""
    a = from_raw(np.array([1 << 500], dtype=object), QFormat(99, 0))
    b = from_raw(np.array([0], dtype=object), QFormat(39, 60))
    to = QFormat(300, 40)
    r = ew.qadd(a, b, to=to)
    want, _ = hostops.qadd(((1 << 500), QFormat(99, 0)),
                           (0, QFormat(39, 60)), to=to)
    assert int(np.asarray(r.raw(), dtype=object).reshape(-1)[0]) == want

    a2 = from_raw(np.array([1 << 62], dtype=object), QFormat(10, 0))
    b2 = from_raw(np.array([3], dtype=object), QFormat(5, 60))
    r2 = ew.qadd(a2, b2, to=QFormat(200, 50))
    want2, _ = hostops.qadd(((1 << 62), QFormat(10, 0)),
                            (3, QFormat(5, 60)), to=QFormat(200, 50))
    assert int(np.asarray(r2.raw(), dtype=object).reshape(-1)[0]) == want2


def test_tile_shape_pads_like_the_kernel():
    """tile_shape's padded extents are whole tiles that cover the operands,
    with power-of-two tile edges no larger than the problem needs."""
    from qublas_tpu.ops import tree_gemm

    for m, n in [(128, 128), (256, 384), (64, 640), (33, 7), (1, 1000)]:
        bm, bn, mp, np_ = tree_gemm.tile_shape(m, n)
        assert mp % bm == 0 and np_ % bn == 0
        assert 0 <= mp - m < bm and 0 <= np_ - n < bn
        assert bm & (bm - 1) == 0 and bn & (bn - 1) == 0


def test_sharded_qreduce_rejects_bad_axes():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.parallel import make_mesh, sharded_qreduce

    mesh = make_mesh(dp=2, tp=4)
    f = qformat(3, 4)
    x = from_raw(np.zeros((8, 16), dtype=int), f)
    with pytest.raises(ValueError):
        sharded_qreduce(x, (), axis=0, mesh=mesh, batch_axis=0)
    # 65..992-bit layer formats are limb-device-resident now (round 4);
    # only truly host-route configs (storage > 992) get the clean error
    with pytest.raises(ValueError):
        sharded_qreduce(x, (QFormat(1000, 50),), axis=1, mesh=mesh)
    # and the limb route must be bit-exact through shard_map
    from qublas_tpu.ops.reduce import qreduce

    wide_layers = (QFormat(100, 50),)
    r = sharded_qreduce(x, wide_layers, axis=1, mesh=mesh)
    ref = qreduce(x, wide_layers, axis=1)
    got = np.asarray(r.raw(), dtype=object).reshape(-1)
    want = np.asarray(ref.raw(), dtype=object).reshape(-1)
    assert r.fmt == ref.fmt
    assert [int(v) for v in got] == [int(v) for v in want]


def test_sharded_cgemul_k_probe_is_cheap_and_correct():
    """The proof probe runs on 1-row x 1-col slices; results still
    bit-exact (guards the tiny-probe refactor)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops.cgemm import cgemul
    from qublas_tpu.parallel import make_mesh, sharded_cgemul_k

    rng = np.random.RandomState(0)
    f = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2

    def rq(shape):
        return from_raw(rng.randint(f.raw_min, f.raw_max + 1, shape), f)

    a = QComplexTensor(rq((4, 16)), rq((4, 16)))
    b = QComplexTensor(rq((16, 8)), rq((16, 8)))
    kw = dict(algo="tf", add_formats=(wide,), ab=mid, cd=mid, ba=mid,
              abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    mesh = make_mesh(dp=2, tp=4)
    y = sharded_cgemul_k(a, b, out, mesh, **kw)
    ref = cgemul(a, b, out, **kw)
    np.testing.assert_array_equal(np.asarray(y.real.raw()),
                                  np.asarray(ref.real.raw()))
    np.testing.assert_array_equal(np.asarray(y.imag.raw()),
                                  np.asarray(ref.imag.raw()))


def test_split_route_rejected_for_pair_stored_operands():
    """route_mul must not pick the split-B int32 trick when an operand is
    pair-stored (35-bit WRP formats have intervals that admit the trick but
    two-limb storage that can't load into one lane) — big-fuzz regression."""
    from qublas_tpu.ops.widths import route_mul

    fa = qformat(-3, 7, overflow_mode=OverflowMode.SAT_ZERO)
    fb = QFormat(11, 23, False, RoundMode.RND_CONV, OverflowMode.WRP_TCPL)
    out = QFormat(9, 21, True, RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL)
    route, _, _ = route_mul(fa, fb, out)
    assert route != "split"
    # and the op computes exactly via the pair route
    rng = np.random.RandomState(0)
    A = np.array([int(rng.randint(fa.raw_min, fa.raw_max + 1))
                  for _ in range(8)], dtype=object)
    B = np.array([int(rng.randint(0, 1 << 34)) for _ in range(8)],
                 dtype=object)
    dev = ew.qmul(from_raw(A, fa), from_raw(B, fb), to=out)
    for x, y, g in zip(A, B, np.asarray(dev.raw(), dtype=object).reshape(-1)):
        want, _ = hostops.qmul((int(x), fa), (int(y), fb), to=out)
        assert int(g) == want


def test_trn_smgn_int32_min_boundary():
    """TRN_SMGN requantize at x = INT32_MIN: the naive -((-x) >> d) wraps
    in int32 lanes (deep-fuzz catch); the bias-add form is exact."""
    from qublas_tpu import hostint

    src = QFormat(15, 16, True, RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL)
    for dst in (QFormat(19, -6, True, RoundMode.TRN_SMGN,
                        OverflowMode.SAT_SMGN),
                QFormat(8, 4, True, RoundMode.TRN_SMGN,
                        OverflowMode.SAT_ZERO),
                QFormat(10, 2, True, RoundMode.TRN_SMGN,
                        OverflowMode.WRP_TCPL)):
        vals = [-(1 << 31), (1 << 31) - 1, -1, 0, -(1 << 30) - 3]
        r = ew.qcast(from_raw(vals, src), dst)
        for v, g in zip(vals, np.asarray(r.raw(), dtype=object).reshape(-1)):
            assert int(g) == hostint.requantize(v, src.frac_bits, dst), \
                (dst, v)


def test_qabs_qneg_int32_min_boundary():
    f32 = QFormat(20, 11, True, RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL)
    vals = [-(1 << 31), (1 << 31) - 1, 5, -5, 0]
    x = from_raw(vals, f32)
    ab, ng = ew.qabs(x), ew.qneg(x)
    for v, ga, gn in zip(vals,
                         np.asarray(ab.raw(), dtype=object).reshape(-1),
                         np.asarray(ng.raw(), dtype=object).reshape(-1)):
        assert int(ga) == hostops.qabs((v, f32))[0]
        assert int(gn) == hostops.qneg((v, f32))[0]


# ---------------------------------------------------------------------------
# Round-2 follow-up review findings
# ---------------------------------------------------------------------------

def test_qapprox_below_range_breakpoint_never_selects():
    """A breakpoint below every storable raw must select NOTHING — the old
    clamp-to-word-minimum made elements at exactly raw-min take the dead
    segment (device select flipped vs the host oracle)."""
    # limb storage (128-bit): raw-min element at the word boundary
    f = qformat(87, 40)
    x = from_raw(np.array([-(1 << 127), 0], dtype=object), f)
    assert x.is_limb
    segs = [anus.Segment(-1e60, [scalar(1.0, f)]),
            anus.Segment(1e60, [scalar(2.0, f)])]
    dev = anus.qapprox(x, segs)
    host = anus.qapprox(from_raw(np.array([-(1 << 127), 0], dtype=object),
                                 qformat(300, 40)), segs)
    assert [int(v) for v in np.asarray(dev.raw(), dtype=object)] == \
        [int(v) for v in np.asarray(host.raw(), dtype=object)]
    # pair storage (64-bit word)
    f2 = QFormat(30, 9)  # 40-bit storage -> pair
    x2 = from_raw(np.array([-(1 << 39), 3], dtype=object), f2)
    assert x2.is_pair
    segs2 = [anus.Segment(-1e30, [scalar(1.0, f2)]),
             anus.Segment(1e30, [scalar(2.0, f2)])]
    dev2 = anus.qapprox(x2, segs2)
    host2 = anus.qapprox(from_raw(np.array([-(1 << 39), 3], dtype=object),
                                  qformat(300, 9)), segs2)
    assert [int(v) for v in np.asarray(dev2.raw(), dtype=object)] == \
        [int(v) for v in np.asarray(host2.raw(), dtype=object)]
    # i32 lane storage
    f3 = qformat(10, 8)
    x3 = from_raw(np.array([-(1 << 18), 5], dtype=object), f3)
    segs3 = [anus.Segment(-1e12, [scalar(1.0, f3)]),
             anus.Segment(1e12, [scalar(2.0, f3)])]
    dev3 = anus.qapprox(x3, segs3)
    host3 = anus.qapprox(from_raw(np.array([-(1 << 18), 5], dtype=object),
                                  qformat(300, 8)), segs3)
    assert [int(v) for v in np.asarray(dev3.raw(), dtype=object)] == \
        [int(v) for v in np.asarray(host3.raw(), dtype=object)]


def test_checkpoint_empty_wide_tensor_round_trips(tmp_path):
    from qublas_tpu import checkpoint

    p = str(tmp_path / "empty.npz")
    t = from_raw(np.array([], dtype=object).reshape(0,), qformat(60, 40))
    checkpoint.save(p, {"w": t, "x": from_raw(np.array([], dtype=object)
                                              .reshape(2, 0), qformat(200, 9))})
    r = checkpoint.load(p)
    assert r["w"].shape == (0,) and r["w"].fmt == t.fmt
    assert r["x"].shape == (2, 0)


def test_qabs_qneg_word_minimum_routes_exact():
    """Negating a storage-word-minimum raw is not representable in the
    output's device word — the op must route to host and return the exact
    (unwrapped) oracle value, never a wrapped store."""
    cases = [
        # limb WRP_TCPL_SAT: 96-bit storage -> 128-bit word, iv covers it
        QFormat(55, 40, True, RoundMode.TRN_TCPL, OverflowMode.WRP_TCPL_SAT),
        # lane WRP_TCPL_SAT: 21-bit storage -> int32 word
        QFormat(10, 10, True, RoundMode.TRN_TCPL, OverflowMode.WRP_TCPL_SAT),
        # pair WRP_TCPL_SAT: 40-bit storage -> 64-bit word
        QFormat(30, 9, True, RoundMode.TRN_TCPL, OverflowMode.WRP_TCPL_SAT),
    ]
    words = [128, 32, 64]
    for f, w in zip(cases, words):
        vals = [-(1 << (w - 1)), (1 << (w - 1)) - 1, -7, 0]
        x = from_raw(np.array(vals, dtype=object), f)
        ab, ng = ew.qabs(x), ew.qneg(x)
        for v, ga, gn in zip(vals,
                             np.asarray(ab.raw(), dtype=object).reshape(-1),
                             np.asarray(ng.raw(), dtype=object).reshape(-1)):
            assert int(ga) == hostops.qabs((v, f))[0], (f, v)
            assert int(gn) == hostops.qneg((v, f))[0], (f, v)


def test_sharded_mn_lane_operands_wide_mul_to_raises_cleanly():
    """Lane-stored int8 operands with a host-route mul_to (1203-bit product
    format — past the round-4 992-bit device limb cap) must get the clean
    'outgrows device lanes' ValueError, not a raw tracer crash inside
    shard_map."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.parallel import make_mesh, sharded_qgemul_mn

    mesh = make_mesh(dp=2, tp=4)
    f8 = qformat(3, 4)
    A = from_raw(np.zeros((4, 8), dtype=int), f8)
    B = from_raw(np.zeros((8, 4), dtype=int), f8)
    with pytest.raises(ValueError, match="outgrows device lanes"):
        sharded_qgemul_mn(A, B, qformat(3, 4), mesh,
                          mul_to=QFormat(1200, 2))


# ---------------------------------------------------------------------------
# Round-2 session-3 review findings
# ---------------------------------------------------------------------------

def test_sharded_mn_accepts_list_add_formats():
    """Program-cache keys must freeze unhashable args: a list add_formats
    crashed the cache lookup with TypeError after caching was added."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.parallel import make_mesh, sharded_qgemul_mn

    mesh = make_mesh(dp=2, tp=4)
    f8 = qformat(3, 4)
    A = from_raw(np.arange(-16, 16, dtype=int).reshape(4, 8), f8)
    B = from_raw(np.arange(32, dtype=int).reshape(8, 4) - 16, f8)
    out = qformat(10, 6)
    got = sharded_qgemul_mn(A, B, out, mesh, add_formats=[qformat(12, 6)])
    ref = qgemul(A, B, out, add_formats=(qformat(12, 6),))
    assert (np.asarray(got.raw()) == np.asarray(ref.raw())).all()


def test_qtable_value_semantics():
    """Two separately built identical QTables must compare/hash equal (so
    compiled-program caches hit across instances); different ROMs differ."""
    f = qformat(3, 4)
    t1 = anus.QTable(anus.rsqrt_func, f)
    t2 = anus.QTable(anus.rsqrt_func, f)
    t3 = anus.QTable(anus.reciprocal_func, f)
    assert t1 == t2 and hash(t1) == hash(t2)
    assert t1 != t3


def test_stream_gate_counts_batch_dims():
    """The streaming gate must include leading batch dims in the product-
    tensor size: a big-batch small-mn GEMM is exactly the case whose layered
    materialization explodes."""
    from qublas_tpu.ops import gemm

    fa = qformat(30, 9)
    # batch 8192 x [2, 128] @ [128, 2]: m*k*n = 512 elements but the
    # batched product tensor is 8192x bigger -- the gate must see it
    A = from_raw(np.zeros((8192, 2, 128), dtype=int), fa)
    B = from_raw(np.zeros((128, 2), dtype=int), fa)
    out = qformat(33, 9)
    res = gemm._stream_gemm_wide(A, B, out, None, (), False)
    assert res is not None
    ref = gemm.qgemul(A, B, out)
    assert res.shape == ref.shape and res.fmt == ref.fmt


def test_probe_error_chains_cause():
    """The clean 'outgrows device lanes' error must chain the underlying
    tracer error on first (uncached) failure."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.parallel import make_mesh, sharded_qgemul_mn
    from qublas_tpu.parallel import sharding as sh

    sh._PROBE_CACHE.clear()
    mesh = make_mesh(dp=2, tp=4)
    f8 = qformat(3, 4)
    A = from_raw(np.zeros((4, 8), dtype=int), f8)
    B = from_raw(np.zeros((8, 4), dtype=int), f8)
    with pytest.raises(ValueError, match="outgrows device lanes") as ei:
        sharded_qgemul_mn(A, B, qformat(3, 4), mesh,
                          mul_to=QFormat(1200, 2))
    assert ei.value.__cause__ is not None


def test_k_strategies_reject_wide_output_formats():
    """K-strategy blocks write int32 lanes; a pair/limb-storage output
    format must get a clean ValueError — before the fix astype(None)
    silently produced float32 raws (low bits destroyed)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.parallel import (
        make_mesh, sharded_qgemul_k, sharded_qgemul_k_pipelined,
        sharded_qreduce_k,
    )

    mesh = make_mesh(dp=2, tp=4)
    f8 = qformat(3, 4)
    wide_out = qformat(30, 9)  # 40-bit storage: pair
    A = from_raw(np.zeros((4, 8), dtype=int), f8)
    B = from_raw(np.zeros((8, 8), dtype=int), f8)
    with pytest.raises(ValueError, match="int32 lanes"):
        sharded_qgemul_k(A, B, wide_out, mesh, mul_to=qformat(20, 8),
                         add_formats=(qformat(20, 8),))
    with pytest.raises(ValueError, match="int32 lanes"):
        sharded_qgemul_k_pipelined(A, B, wide_out, mesh,
                                   mul_to=qformat(20, 8),
                                   add_formats=(qformat(20, 8),))
    # qreduce_k: int8 input whose lossless tree lands in a >32-bit format
    x = from_raw(np.zeros((32,), dtype=int), f8)
    with pytest.raises(ValueError, match="int32 lanes"):
        sharded_qreduce_k(x, (qformat(30, 9),), mesh=mesh)


def test_sharded_cgemul_mn_host_route_raises_cleanly():
    """Complex configs that fall off device lanes must raise the clean
    error, not a TracerArrayConversionError inside shard_map."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.parallel import make_mesh, sharded_cgemul_mn

    mesh = make_mesh(dp=2, tp=4)
    fw = qformat(760, 340)   # 1101-bit storage: host kind (401-bit became
    #                           device limb storage in round 4)
    re = from_raw(np.ones((4, 4), dtype=object), fw)
    im = from_raw(np.ones((4, 4), dtype=object), fw)
    ca = QComplexTensor(re, im)
    with pytest.raises(ValueError, match="outgrows device lanes"):
        sharded_cgemul_mn(ca, ca, (fw, fw), mesh)


def test_qapprox_breakpoint_compares_rounded_double():
    """The reference selects segments by input.toDouble() < breakpoint —
    the ROUNDED double.  raw = 2^60 - 1 rounds to exactly 2^60, so it must
    NOT take a segment with breakpoint 2^60 (exact-rational compare said
    it did).  All three storage kinds vs the host oracle."""
    cases = [
        (qformat(59, 0), 64, [(1 << 60) - 1, (1 << 59) - 1, 5]),   # pair
        (qformat(89, 0), 96, [(1 << 90) - 1, (1 << 60) - 1, 5]),   # limb
    ]
    for f, _, raws in cases:
        x = from_raw(np.array(raws, dtype=object), f)
        assert not x.is_host
        bp = float(2 ** (raws[0].bit_length()))  # = rounded(raws[0])
        segs = [anus.Segment(bp, [scalar(1.0, f)]),
                anus.Segment(float("inf"), [scalar(2.0, f)])]
        dev = anus.qapprox(x, segs)
        host = anus.qapprox(from_raw(np.array(raws, dtype=object),
                                     qformat(300, 0)), segs)
        got = [int(v) for v in np.asarray(dev.raw(), dtype=object)]
        want = [int(v) for v in np.asarray(host.raw(), dtype=object)]
        assert got == want, (f, got, want)
    # lane storage can't hold >53-bit raws, but the bisected threshold must
    # still agree with the oracle on exact-boundary comparisons
    f = qformat(20, 8)
    x = from_raw([256, 255, -300], f)
    segs = [anus.Segment(1.0, [scalar(1.0, f)]),
            anus.Segment(float("inf"), [scalar(2.0, f)])]
    dev = anus.qapprox(x, segs)
    host = anus.qapprox(from_raw(np.array([256, 255, -300], dtype=object),
                                 qformat(300, 8)), segs)
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64),
                                  np.asarray(host.raw(), dtype=object)
                                  .astype(np.int64))


def test_requant_stats_wide_shift_and_int32_min():
    """d >= 32 must route to the exact host evaluation (the lane path's
    shift would assert/UB), and max_abs must survive INT32_MIN (jnp.abs
    wraps on int32 lanes)."""
    from qublas_tpu import diagnostics

    # shift distance 32: host route, counts match a hand computation
    x = from_raw([3, -(1 << 20), 0], QFormat(-1, 32))
    st = diagnostics.requant_stats(x, QFormat(32, 0, True,
                                              RoundMode.RND_POS_INF,
                                              OverflowMode.SAT_TCPL))
    assert int(st.total) == 3
    assert int(st.rounded) == 2          # 3 and -(1<<20) drop nonzero bits
    # INT32_MIN magnitude: 2^31, not the wrapped negative
    y = from_raw([-(1 << 31), 5], QFormat(15, 16))
    st2 = diagnostics.requant_stats(y, QFormat(15, 16))
    assert int(st2.max_abs) == 1 << 31


def test_checkpoint_dotted_keys_do_not_collide(tmp_path):
    """{'a.b': t1, 'a': {'b': t2}} used to produce the same array key and
    silently overwrite one tensor with the other."""
    from qublas_tpu import checkpoint

    f = qformat(3, 4)
    t1 = from_raw([1, 2, 3], f)
    t2 = from_raw([9, 8, 7], f)
    p = str(tmp_path / "c.npz")
    checkpoint.save(p, {"a.b": t1, "a": {"b": t2}})
    r = checkpoint.load(p)
    np.testing.assert_array_equal(np.asarray(r["a.b"].raw()), [1, 2, 3])
    np.testing.assert_array_equal(np.asarray(r["a"]["b"].raw()), [9, 8, 7])


def test_real_op_complex_dispatches_reflected():
    """r * c / r + c / r - c must reach rc_mul/rc_add/rc_sub
    (QuBLAS.h:3600-3663), not crash inside QTensor's elementwise coercion."""
    from qublas_tpu import complex as qc
    from qublas_tpu.qtensor import from_float

    f = qformat(6, 6)
    r = from_float([2.0, -1.5], f)
    c = qc.QComplexTensor(from_float([1.0, 3.0], f),
                          from_float([0.5, -2.0], f))
    got = r * c
    want = qc.rc_mul(r, c)
    np.testing.assert_array_equal(np.asarray(got.real.raw()),
                                  np.asarray(want.real.raw()))
    np.testing.assert_array_equal(np.asarray(got.imag.raw()),
                                  np.asarray(want.imag.raw()))
    gs = r - c
    ws = qc.rc_sub(r, c)
    np.testing.assert_array_equal(np.asarray(gs.real.raw()),
                                  np.asarray(ws.real.raw()))
    ga = r + c
    wa = qc.rc_add(r, c)
    np.testing.assert_array_equal(np.asarray(ga.imag.raw()),
                                  np.asarray(wa.imag.raw()))


def test_from_bits_scalar_validates_length():
    from qublas_tpu import bitstream

    f = qformat(3, 4)  # width 8
    with pytest.raises(ValueError, match="expected 8"):
        bitstream.from_bits("1" * 11, f)
    with pytest.raises(ValueError, match="expected 8"):
        bitstream.from_bits("101", f)
    assert int(bitstream.from_bits("00000101", f).raw()) == 5


def test_i128_engine_extreme_shifts():
    """Requantize shifts d >= 127 through the narrow (i128) native engine:
    shifting __int128 by >= 128 is UB (x86 wraps the count) and returned
    garbage before the guard.  All modes vs the exact host model."""
    from qublas_tpu import hostint

    src = QFormat(-120, 150)
    vals = [123456789, -987654321, (1 << 30) - 1, -(1 << 30), 0]
    for rm in RoundMode:
        dst = QFormat(8, 8, True, rm, OverflowMode.SAT_TCPL)
        res = native.requantize(np.array(vals, dtype=np.int64), src, dst)
        if res is None:
            continue
        for v, g in zip(vals, res):
            want = hostint.int_convert(
                hostint.frac_convert(v, 150, 8, rm), dst)
            assert int(g) == want, (rm, v, int(g), want)
    # the production qmul route (host pair, d=152) and qdiv (num >> 144)
    f = QFormat(-50, 80)
    a = from_raw([5, -7, 1 << 29, -(1 << 29)], f)
    b = from_raw([3, 11, -13, 17], f)
    r = ew.qmul(a, b, to=QFormat(8, 8))
    for x, y, g in zip([5, -7, 1 << 29, -(1 << 29)], [3, 11, -13, 17],
                       np.asarray(r.raw(), dtype=object).reshape(-1)):
        assert int(g) == hostops.qmul((x, f), (y, f), to=QFormat(8, 8))[0]
    fd = QFormat(10, 4)
    to = QFormat(200, -140, True, RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL)
    rr = ew.qdiv(from_raw([100, -100, 7], fd), from_raw([3, 7, -2], fd),
                 to=to)
    for x, y, g in zip([100, -100, 7], [3, 7, -2],
                       np.asarray(rr.raw(), dtype=object).reshape(-1)):
        assert int(g) == hostops.qdiv((x, fd), (y, fd), to=to)[0]


def test_cgemul_two_format_tuple_means_two_layers():
    """add_formats=(QF1, QF2) is TWO tree layers (each applied to both
    parts), matching qgemul and the hostops oracle — the device path used
    to read it as one (real, imag) pair and silently diverged."""
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.ops.cgemm import cgemul
    from qublas_tpu.qtensor import from_float

    rng = np.random.RandomState(3)
    f = qformat(4, 4)
    k = 3

    def rq(shape):
        return from_raw(rng.randint(f.raw_min, f.raw_max + 1, shape), f)

    a = QComplexTensor(rq((2, k)), rq((2, k)))
    b = QComplexTensor(rq((k, 2)), rq((k, 2)))
    layers = (qformat(3, 2), qformat(9, 6))  # lossy layer 0: order matters
    out = qformat(6, 4)
    dev = cgemul(a, b, out, algo="basic", add_formats=layers)

    def rows(c):
        re = np.asarray(c.real.raw())
        im = np.asarray(c.imag.raw())
        return [[((int(re[i, j]), c.real.fmt), (int(im[i, j]), c.imag.fmt))
                 for j in range(re.shape[1])] for i in range(re.shape[0])]

    host = hostops.cgemul(rows(a), rows(b), out, algo="basic",
                          add_formats=layers)
    for i in range(2):
        for j in range(2):
            assert int(np.asarray(dev.real.raw())[i, j]) == host[i][j][0][0]
            assert int(np.asarray(dev.imag.raw())[i, j]) == host[i][j][1][0]


def test_wrp_tcpl_out_interval_is_sound():
    """requant_out_interval must not model signed WRP_TCPL as a clamp: an
    overflowing side wraps anywhere in the format range."""
    from qublas_tpu.ops.widths import Interval, requant_out_interval

    fmt = QFormat(10, 4, True, RoundMode.TRN_TCPL, OverflowMode.WRP_TCPL)
    # an all-positive interval overflowing raw_max: wrapped values reach
    # raw_min, so the sound interval is the full format range
    out, _ = requant_out_interval(Interval(0, 1 << 40), 4, fmt)
    assert out.lo == fmt.raw_min and out.hi == fmt.raw_max
    # contained interval stays tight (identity)
    out2, _ = requant_out_interval(Interval(5, 100), 4, fmt)
    assert (out2.lo, out2.hi) == (5, 100)


def test_reference_shuffle_raises_beyond_envelope():
    from qublas_tpu import refrand

    big = from_raw(np.zeros(70000, dtype=np.int64), qformat(3, 4))
    with pytest.raises(ValueError, match="n\\^2 < 2\\^32"):
        refrand.reference_shuffle(big, gen=refrand.MT19937(1))


def test_host_binary_empty_operands():
    """Zero-size host-route operands must produce an empty tensor with the
    statically-derived output format (the per-element loop never runs)."""
    f300 = qformat(250, 60)   # >256-bit storage: host route
    e = from_raw(np.empty((0,), dtype=object), f300)
    r = ew.qmul(e, e)
    assert r.shape == (0,)
    want_fmt = ew.qmul(from_raw(np.array([1], dtype=object), f300),
                       from_raw(np.array([1], dtype=object), f300)).fmt
    assert r.fmt == want_fmt
    u = ew.qneg(e)
    assert u.shape == (0,) and u.fmt is not None


def test_plan_tree_drain_matches_drain_ops():
    """plan_tree's drain schedule must be drain_ops' output verbatim for
    every k (single source of the binary-carry ragged edge)."""
    from qublas_tpu.ops.tree_gemm import drain_ops, plan_tree
    from qublas_tpu.qformat import mul_merge

    f = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    for k in list(range(1, 40)) + [63, 64, 65, 100, 512]:
        plan = plan_tree(f, f, mul_merge(f, f), (), k, f)
        if plan is None:
            continue
        assert list(plan.drain) == drain_ops(k, plan.levels), k


def _mesh8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual mesh")
    from qublas_tpu.parallel import make_mesh

    return make_mesh(dp=2, tp=4)


def test_k_shard_requires_epilogue_lane_proof():
    """An epilogue whose requantize intermediates outgrow int32 (upshift
    toward a much larger frac_bits) must be rejected by the K strategies
    and routed to mn by auto — the single-chip gate's missing mirror."""
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.parallel import (
        shard_qgemul, sharded_qgemul_k, sharded_qgemul_k_pipelined,
    )

    mesh = _mesh8()
    f8 = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(1, 29)     # d = 8 - 29 = -21: x << 21 wraps int32 lanes
    rng = np.random.RandomState(0)
    A = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (4, 8)), f8)
    B = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (8, 8)), f8)
    with pytest.raises(ValueError, match="outgrows int32 lanes"):
        sharded_qgemul_k(A, B, out, mesh, mul_to=wide, add_formats=(wide,))
    with pytest.raises(ValueError, match="outgrows int32 lanes"):
        sharded_qgemul_k_pipelined(A, B, out, mesh, mul_to=wide,
                                   add_formats=(wide,))
    # auto must fall back to mn and match the single-chip result
    got = shard_qgemul(A, B, out, mesh, mul_to=wide, add_formats=(wide,))
    ref = qgemul(A, B, out, mul_to=wide, add_formats=(wide,))
    assert got.fmt == ref.fmt
    g = np.asarray(got.raw(), dtype=object).reshape(-1)
    w = np.asarray(ref.raw(), dtype=object).reshape(-1)
    assert [int(v) for v in g] == [int(v) for v in w]


def test_shard_qgemul_transposes_applied():
    """transpose_a/b must transform the operands (the K path used to drop
    them silently via **kw)."""
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.parallel import shard_qgemul

    mesh = _mesh8()
    f8 = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    rng = np.random.RandomState(1)
    A = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (8, 4)), f8)
    B = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (8, 8)), f8)
    got = shard_qgemul(A, B, out, mesh, mul_to=wide, add_formats=(wide,),
                       transpose_a=True)
    ref = qgemul(A, B, out, mul_to=wide, add_formats=(wide,),
                 transpose_a=True, use_pallas=False)
    np.testing.assert_array_equal(np.asarray(got.raw()),
                                  np.asarray(ref.raw()))


def test_auto_k_indivisible_falls_back_to_mn():
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.parallel import shard_qgemul

    mesh = _mesh8()   # tp=4
    f8 = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    rng = np.random.RandomState(2)
    A = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (4, 6)), f8)
    B = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (6, 8)), f8)
    got = shard_qgemul(A, B, out, mesh, mul_to=wide, add_formats=(wide,))
    ref = qgemul(A, B, out, mul_to=wide, add_formats=(wide,),
                 use_pallas=False)
    np.testing.assert_array_equal(np.asarray(got.raw()),
                                  np.asarray(ref.raw()))


def test_reduce_scatter_checks_n_divisibility():
    from qublas_tpu.parallel import sharded_qgemul_k

    mesh = _mesh8()
    f8 = qformat(3, 4)
    wide = qformat(20, 8)
    out = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    A = from_raw(np.zeros((4, 8), dtype=int), f8)
    B = from_raw(np.zeros((8, 6), dtype=int), f8)   # N=6, tp=4
    with pytest.raises(ValueError, match="N=6 not divisible"):
        sharded_qgemul_k(A, B, out, mesh, mul_to=wide,
                         add_formats=(wide,), reduce_scatter=True)


def test_sharded_mn_epilogue_lut_labels_result_format():
    from qublas_tpu.anus import build_table, sqrt_func
    from qublas_tpu.ops.gemm import qgemul
    from qublas_tpu.parallel import sharded_qgemul_mn

    mesh = _mesh8()
    f8 = qformat(3, 4)
    wide = qformat(20, 8)
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = build_table(sqrt_func, mid, wide)   # LUT output format differs
    rng = np.random.RandomState(3)
    A = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (4, 8)), f8)
    B = from_raw(rng.randint(f8.raw_min, f8.raw_max + 1, (8, 8)), f8)
    got = sharded_qgemul_mn(A, B, mid, mesh, mul_to=wide,
                            add_formats=(wide,), epilogue_lut=table)
    ref = qgemul(A, B, mid, mul_to=wide, add_formats=(wide,),
                 epilogue_lut=table, use_pallas=False)
    assert got.fmt == ref.fmt == wide
    np.testing.assert_array_equal(np.asarray(got.raw()),
                                  np.asarray(ref.raw()))


def test_bitstream_0d_round_trip_with_orders():
    from qublas_tpu import bitstream

    f = qformat(3, 4)
    x0 = from_raw(np.array(5, dtype=object), f)
    s = bitstream.to_bits(x0, tensor_order=bitstream.r2l(2))
    back = bitstream.from_bits(s, f, shape=(),
                               tensor_order=bitstream.r2l(2))
    assert int(np.asarray(back.raw())) == 5


def test_wrp_tcpl_sat_word_wrap_bounds_exactness_proof():
    """WRP_TCPL_SAT is the identity STUB, but the store wraps at the
    machine word: a product format whose upshifted values exceed the word
    wraps per element, so the integer-matmul fast path's exactness proof must bound
    its identity range by the word — big-fuzz catch (the dot of unwrapped
    values diverged from the oracle)."""
    from qublas_tpu.ops.gemm import qgemul

    fa = QFormat(-6, 11, False, RoundMode.RND_INF, OverflowMode.SAT_ZERO)
    fb = QFormat(13, -7, True, RoundMode.RND_CONV, OverflowMode.WRP_TCPL)
    out = QFormat(13, 7, True, RoundMode.RND_INF, OverflowMode.SAT_ZERO)
    mul_to = QFormat(-6, 26, False, RoundMode.RND_INF,
                     OverflowMode.WRP_TCPL_SAT)
    k = 4
    A = np.array([12, 15, 21, 0], dtype=object)   # 15*59 << 22 wraps int32
    B = np.array([3, 59, 3, 39], dtype=object)
    dev = qgemul(from_raw(A.reshape(1, k), fa),
                 from_raw(B.reshape(k, 1), fb), out, mul_to=mul_to)
    host = hostops.qgemul([[(int(A[j]), fa) for j in range(k)]],
                          [[(int(B[j]), fb)] for j in range(k)],
                          out, mul_to=mul_to)
    assert int(np.asarray(dev.raw(), dtype=object).reshape(-1)[0]) == \
        host[0][0][0] == -320
