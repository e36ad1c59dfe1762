"""Streaming binary-carry tree GEMM vs the host golden model.

The schedule must reproduce the reference's balanced-tree pairing and
odd-tail converting assignments for every k (QuBLAS.h:4960-4990), so k
values around powers of two are the interesting cases.
"""

import numpy as np
import pytest

from qublas_tpu import hostops
from qublas_tpu.ops import tree_gemm
from qublas_tpu.ops.gemm import qgemul
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge, qformat
from qublas_tpu.qtensor import from_raw

rng = np.random.RandomState(77)

F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
F44 = qformat(4, 4)


def host_ref(A, B, fa, fb, out, **kw):
    m, k = A.shape
    _, n = B.shape
    ar = [[(int(A[i, p]), fa) for p in range(k)] for i in range(m)]
    br = [[(int(B[p, j]), fb) for j in range(n)] for p in range(k)]
    return np.array([[c[0] for c in row]
                     for row in hostops.qgemul(ar, br, out, **kw)])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 33])
def test_scan_matches_host_canonical(k):
    A = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (3, k))
    B = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (k, 4))
    mf = mul_merge(F88Z, F88Z, None, False)
    plan = tree_gemm.plan_tree(F88Z, F88Z, mf, (), k, F88Z)
    assert plan is not None
    got = np.asarray(tree_gemm.tree_gemm_scan(
        from_raw(A, F88Z).data, from_raw(B, F88Z).data, plan, F88Z))
    np.testing.assert_array_equal(got, host_ref(A, B, F88Z, F88Z, F88Z))


@pytest.mark.parametrize("k", [3, 6, 11, 16])
def test_scan_matches_host_layered(k):
    mul_to = qformat(5, 5, overflow_mode=OverflowMode.SAT_ZERO)
    layers = (qformat(6, 4, round_mode=RoundMode.RND_CONV), qformat(5, 2))
    out = qformat(6, 3)
    A = rng.randint(F44.raw_min, F44.raw_max + 1, (4, k))
    B = rng.randint(F44.raw_min, F44.raw_max + 1, (k, 3))
    mf = mul_merge(F44, F44, mul_to, False)
    plan = tree_gemm.plan_tree(F44, F44, mf, layers, k, out)
    assert plan is not None
    got = np.asarray(tree_gemm.tree_gemm_scan(
        from_raw(A, F44).data, from_raw(B, F44).data, plan, out))
    np.testing.assert_array_equal(
        got, host_ref(A, B, F44, F44, out, mul_to=mul_to, add_formats=layers))


def test_qgemul_dispatches_tree_scan():
    """qgemul's general path now uses the streaming evaluation — same bits
    as the layered fallback and the host model."""
    k = 13
    A = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (5, k))
    B = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (k, 6))
    dev = qgemul(from_raw(A, F88Z), from_raw(B, F88Z), F88Z)
    np.testing.assert_array_equal(
        np.asarray(dev.raw(), dtype=np.int64),
        host_ref(A, B, F88Z, F88Z, F88Z))


def _tiled_vs_scan(m, k, n, layers=(), **kw):
    A = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (m, k))
    B = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (k, n))
    mf = mul_merge(F88Z, F88Z, None, False)
    plan = tree_gemm.plan_tree(F88Z, F88Z, mf, layers, k, F88Z)
    a, b = from_raw(A, F88Z).data, from_raw(B, F88Z).data
    scan = np.asarray(tree_gemm.tree_gemm_scan(a, b, plan, F88Z))
    kw.setdefault("interpret", True)
    tiled = np.asarray(tree_gemm.tree_gemm_tiled(a, b, plan, F88Z, **kw))
    assert tiled.shape == (m, n) and tiled.dtype == scan.dtype
    np.testing.assert_array_equal(tiled, scan)
    return A, B, tiled


@pytest.mark.parametrize("k", [64, 128, 320])
def test_tiled_kernel_matches_scan(k):
    """The GPU kernel (Pallas interpreter here) against the scan."""
    _tiled_vs_scan(64, k, 64)


def test_tiled_kernel_layered_formats():
    layers = (qformat(9, 6, round_mode=RoundMode.RND_CONV), qformat(10, 4))
    _tiled_vs_scan(64, 128, 64, layers)


@pytest.mark.parametrize("m,k,n", [(5, 1, 3), (8, 2, 8), (33, 24, 40),
                                   (16, 37, 16), (40, 47, 70)])
def test_tiled_kernel_ragged(m, k, n):
    """Odd k (leftover products and odd-tail drains) and m, n padded to
    whole tiles, against the host golden model."""
    A, B, tiled = _tiled_vs_scan(m, k, n)
    np.testing.assert_array_equal(tiled, host_ref(A, B, F88Z, F88Z, F88Z))


@pytest.mark.parametrize("tile,blk", [(16, 4), (8, 16), (32, 1)])
def test_tiled_kernel_tile_settings(tile, blk):
    _tiled_vs_scan(24, 41, 40, tile=tile, blk=blk)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (40, 2047, 70)])
def test_tiled_kernel_compiled_on_gpu(m, k, n, gpu_device):
    """The kernel as the GPU compiles it (no interpreter) against the scan;
    runs with QUBLAS_TEST_BACKEND=cuda."""
    _tiled_vs_scan(m, k, n, interpret=False)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (40, 47, 70), (8, 2047, 8)])
def test_tiled_kernel_lowers_for_cuda(m, k, n):
    """The kernel's Triton lowering runs without a card: a lowering error
    (an op Triton cannot take) shows here, on the CPU."""
    import jax
    import jax.numpy as jnp

    plan = tree_gemm.plan_tree(F88Z, F88Z, mul_merge(F88Z, F88Z), (), k,
                               F88Z)
    lowered = jax.jit(lambda a, b: tree_gemm.tree_gemm_tiled(
        a, b, plan, F88Z)).trace(
        jax.ShapeDtypeStruct((m, k), jnp.int32),
        jax.ShapeDtypeStruct((k, n), jnp.int32)).lower(
        lowering_platforms=("cuda",))
    assert "tree_gemm_tiled" in lowered.as_text()


@pytest.mark.parametrize("m,n,tile,want", [
    (2048, 2048, 32, (32, 32, 2048, 2048)),
    (5, 3, 32, (8, 4, 8, 4)),
    (40, 70, 32, (32, 32, 64, 96)),
    (1, 1, 32, (1, 1, 1, 1)),
    (100, 17, 16, (16, 16, 112, 32)),
])
def test_tile_shape(m, n, tile, want):
    assert tree_gemm.tile_shape(m, n, tile) == want


def _gpu_dispatch(monkeypatch):
    """Make qgemul see a GPU default backend and run the kernel in the
    interpreter; returns the list of calls it made to the kernel."""
    import jax

    calls = []
    kernel = tree_gemm.tree_gemm_tiled

    def interpreted(*args, **kw):
        calls.append(args[0].shape)
        return kernel(*args, interpret=True, **kw)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(tree_gemm, "tree_gemm_tiled", interpreted)
    return calls


@pytest.mark.parametrize("use_pallas,taken", [(None, True), (True, True),
                                              (False, False)])
def test_qgemul_takes_the_kernel_on_gpu(use_pallas, taken, monkeypatch):
    calls = _gpu_dispatch(monkeypatch)
    A = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (6, 19))
    B = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (19, 5))
    dev = qgemul(from_raw(A, F88Z), from_raw(B, F88Z), F88Z,
                 use_pallas=use_pallas)
    assert bool(calls) == taken
    np.testing.assert_array_equal(np.asarray(dev.raw(), dtype=np.int64),
                                  host_ref(A, B, F88Z, F88Z, F88Z))


def test_qgemul_batched_kernel_on_gpu(monkeypatch):
    calls = _gpu_dispatch(monkeypatch)
    A = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (2, 3, 9))
    B = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (2, 9, 4))
    dev = np.asarray(qgemul(from_raw(A, F88Z), from_raw(B, F88Z),
                            F88Z).raw(), dtype=np.int64)
    assert calls
    for i in range(2):
        np.testing.assert_array_equal(dev[i],
                                      host_ref(A[i], B[i], F88Z, F88Z, F88Z))


def _virtual_mesh(dp):
    import jax

    from qublas_tpu.parallel import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual mesh")
    return make_mesh(dp=dp, tp=4 // dp, devices=jax.devices()[:4])


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_mn_kernel_lowers_for_cuda(dp, monkeypatch):
    """mn tiles run the kernel inside shard_map: its output must carry the
    operands' varying mesh axes, and the sharded program lowers for the
    GPU (the Pallas interpreter cannot run under this shard_map)."""
    import jax
    import jax.numpy as jnp

    from qublas_tpu.parallel import shard_qgemul
    from qublas_tpu.qtensor import QTensor

    mesh = _virtual_mesh(dp)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    lowered = jax.jit(lambda a, b: shard_qgemul(
        QTensor(a, F88Z), QTensor(b, F88Z), F88Z, mesh,
        strategy="mn").data).trace(
        jax.ShapeDtypeStruct((8, 64), jnp.int32),
        jax.ShapeDtypeStruct((64, 8), jnp.int32)).lower(
        lowering_platforms=("cuda",))
    assert "tree_gemm_tiled" in lowered.as_text()


def test_sharded_k_tree_takes_the_kernel_on_gpu(monkeypatch):
    """k_tree's local folds run the kernel inside shard_map; bits match
    the single-device scan."""
    from qublas_tpu.parallel import shard_qgemul

    mesh = _virtual_mesh(1)
    calls = _gpu_dispatch(monkeypatch)
    A = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (8, 64))
    B = rng.randint(F88Z.raw_min, F88Z.raw_max + 1, (64, 8))
    a, b = from_raw(A, F88Z), from_raw(B, F88Z)
    got = shard_qgemul(a, b, F88Z, mesh, strategy="k_tree",
                       add_formats=(F88Z,))
    assert calls
    want = qgemul(a, b, F88Z, add_formats=(F88Z,), use_pallas=False)
    np.testing.assert_array_equal(np.asarray(got.raw()),
                                  np.asarray(want.raw()))


def test_qgemul_stays_on_scan_off_gpu():
    """On any other backend qgemul never reaches the kernel (no interpret
    mode on its own)."""
    import jax

    from qublas_tpu.qtensor import QTensor

    assert jax.default_backend() != "gpu"
    jaxpr = str(jax.make_jaxpr(lambda a, b: qgemul(
        QTensor(a, F88Z), QTensor(b, F88Z), F88Z).data)(
        np.zeros((4, 8), np.int32), np.zeros((8, 4), np.int32)))
    assert "pallas_call" not in jaxpr and "scan" in jaxpr


def test_plan_rejects_host_only_formats():
    wide = qformat(40, 40)
    assert tree_gemm.plan_tree(wide, wide, mul_merge(wide, wide),
                               (), 4, wide) is None


def test_batched_scan():
    k = 9
    A = rng.randint(F44.raw_min, F44.raw_max + 1, (2, 3, k))
    B = rng.randint(F44.raw_min, F44.raw_max + 1, (2, k, 3))
    out = qformat(5, 3)
    mf = mul_merge(F44, F44, None, False)
    plan = tree_gemm.plan_tree(F44, F44, mf, (), k, out)
    got = np.asarray(tree_gemm.tree_gemm_scan(
        from_raw(A, F44).data, from_raw(B, F44).data, plan, out))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], host_ref(A[i], B[i], F44, F44, out))


# ---------------------------------------------------------------------------
# Prefix-lossless hybrid (block integer dots + elementwise tail)
# ---------------------------------------------------------------------------

def _hybrid_cfg():
    from qublas_tpu.qformat import OverflowMode, qformat

    fa = fb = qformat(3, 4)
    mul_to = qformat(7, 8)
    layers = (qformat(8, 8), qformat(9, 8), qformat(10, 8), qformat(11, 8),
              qformat(6, 4, overflow_mode=OverflowMode.SAT_ZERO))
    out = qformat(5, 4)
    return fa, fb, mul_to, layers, out


@pytest.mark.parametrize("k", [16, 48, 64, 80, 176])
def test_hybrid_matches_oracle(k):
    """Hybrid plan (lossless prefix -> block dots, lossy tail -> folds)
    must be bit-identical to the host golden tree, incl. odd block counts."""
    from qublas_tpu.qformat import mul_merge

    fa, fb, mul_to, layers, out = _hybrid_cfg()
    hp = tree_gemm.plan_hybrid(fa, fb, mul_merge(fa, fb, mul_to), layers,
                               k, out)
    assert hp is not None and hp.s == 16 and hp.level == 4
    rng2 = np.random.RandomState(k)
    m, n = 4, 5
    A = rng2.randint(fa.raw_min, fa.raw_max + 1, (m, k))
    B = rng2.randint(fb.raw_min, fb.raw_max + 1, (k, n))
    dev = qgemul(from_raw(A, fa), from_raw(B, fb), out, mul_to=mul_to,
                 add_formats=layers)
    ar = [[(int(A[i, p]), fa) for p in range(k)] for i in range(m)]
    br = [[(int(B[p, j]), fb) for j in range(n)] for p in range(k)]
    host = hostops.qgemul(ar, br, out, mul_to, layers)
    g = np.asarray(dev.raw())
    for i in range(m):
        for j in range(n):
            assert int(g[i, j]) == host[i][j][0], (k, i, j)


def test_hybrid_with_frac_growth_shift():
    """Prefix layers that raise frac precision (dl > 0) stay exact: the
    block dot is shifted into the level format's scale."""
    from qublas_tpu.qformat import OverflowMode, mul_merge, qformat

    fa = fb = qformat(3, 4)
    mul_to = qformat(7, 10)                 # frac 10 > 8: dl = 2
    layers = (qformat(8, 11), qformat(9, 12), qformat(10, 12),
              qformat(5, 6, overflow_mode=OverflowMode.SAT_ZERO))
    out = qformat(5, 5)
    k = 32
    hp = tree_gemm.plan_hybrid(fa, fb, mul_merge(fa, fb, mul_to), layers,
                               k, out)
    assert hp is not None and hp.dl > 0
    rng2 = np.random.RandomState(1)
    A = rng2.randint(fa.raw_min, fa.raw_max + 1, (3, k))
    B = rng2.randint(fb.raw_min, fb.raw_max + 1, (k, 4))
    dev = qgemul(from_raw(A, fa), from_raw(B, fb), out, mul_to=mul_to,
                 add_formats=layers)
    ar = [[(int(A[i, p]), fa) for p in range(k)] for i in range(3)]
    br = [[(int(B[p, j]), fb) for j in range(4)] for p in range(k)]
    host = hostops.qgemul(ar, br, out, mul_to, layers)
    g = np.asarray(dev.raw())
    for i in range(3):
        for j in range(4):
            assert int(g[i, j]) == host[i][j][0]


def test_hybrid_not_planned_for_immediately_lossy():
    """The canonical config (product quantize drops bits) must not plan a
    hybrid — it stays on the tiled/scan tree kernels."""
    from qublas_tpu.qformat import OverflowMode, mul_merge, qformat

    f = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    assert tree_gemm.plan_hybrid(f, f, mul_merge(f, f), (), 512, f) is None


def test_hybrid_batched():
    fa, fb, mul_to, layers, out = _hybrid_cfg()
    rng2 = np.random.RandomState(7)
    A = rng2.randint(fa.raw_min, fa.raw_max + 1, (2, 3, 32))
    B = rng2.randint(fb.raw_min, fb.raw_max + 1, (2, 32, 4))
    dev = qgemul(from_raw(A, fa), from_raw(B, fb), out, mul_to=mul_to,
                 add_formats=layers)
    for bi in range(2):
        one = qgemul(from_raw(A[bi], fa), from_raw(B[bi], fb), out,
                     mul_to=mul_to, add_formats=layers)
        np.testing.assert_array_equal(np.asarray(dev.raw())[bi],
                                      np.asarray(one.raw()))
