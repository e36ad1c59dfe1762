"""Multi-device / multi-host sharded quantized GEMM.

The reference is a single-threaded header with no distribution of any kind
(SURVEY.md §2.19); these are the build-plan components mandated by
BASELINE.json's north star: tensor-sharded Qgemul operands across the
devices of a host with reduce-scatter / all-gather over the device
interconnect (NVLink), and DP-style batched GEMM streaming across hosts.

Design (scaling-book recipe): pick a `Mesh`, annotate shardings, let XLA
insert collectives.  Three strategies, chosen by bit-exactness constraints:

* ``"mn"`` — shard M over ``dp`` and N over ``tp``; A's rows and B's columns
  all-gather as needed by XLA.  **Always bit-exact**, including the
  order-sensitive quantized-accumulation configs, because every output
  element's full dot product is computed on one chip with the same tree
  order as the single-chip path.

* ``"k"`` — shard the contraction dim over ``tp``; each chip computes a
  partial int32 dot, partials combine with ``psum`` (all-reduce) or
  ``psum_scatter`` (reduce-scatter, N-sharded output), and the requantize
  epilogue runs on the summed value.  Valid **only** under an exactness
  proof (:func:`qublas_tpu.ops.gemm.exact_plan`): integer adds must be
  provably lossless so the cross-chip summation order cannot change bits.
  The proof is checked at trace time and the call falls back to ``"mn"``
  when it fails.

* ``"dp"`` — shard leading batch dims; each chip runs independent GEMMs
  (multi-host batch streaming).

* ``"k_tree"`` (round 5) — K-shard an ORDER-SENSITIVE tree: split the
  contraction dim on level-``s`` subtree boundaries (``2^s | k``), fold
  complete subtrees per device with the global layer formats, all_gather
  the ``k/2^s`` node values, finish the top layers with shifted TypeAt
  formats.  **Bit-exact for every config by construction** (no proof
  gate) — closes the asymmetry where rounding/saturating accumulations
  could only shard mn/dp.

All functions operate on :class:`~qublas_tpu.qtensor.QTensor` (a pytree), so
they compose with ``jax.jit`` / ``jax.shard_map`` like any array program.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import wideint as W
from ..ops.gemm import exact_plan, pair_dot_2d, qgemul
from ..ops.widths import Interval, dtype_for, fmt_interval
from ..qformat import QFormat, mul_merge
from ..qtensor import QTensor

__all__ = ["make_mesh", "shard_qgemul", "sharded_qgemul_k",
           "sharded_qgemul_k_tree",
           "sharded_qgemul_k_pipelined", "sharded_qgemul_k_wide",
           "sharded_qgemul_k_wide_pipelined", "sharded_qgemul_k_limb",
           "sharded_qgemul_k_limb_pipelined", "sharded_qgemul_mn",
           "sharded_qgemul_dp", "init_distributed",
           "sharded_cgemul", "sharded_cgemul_mn", "sharded_cgemul_k",
           "sharded_cgemul_k_tree", "sharded_cgemul_dp",
           "sharded_qreduce", "sharded_qreduce_k", "sharded_qreduce_k_tree"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize the multi-host JAX runtime (the cross-host side of the
    BASELINE north star: "batched quantized GEMM streams continuously
    across hosts").

    Pass the coordinator address, process count and this process's id
    (nothing auto-detects them on a plain GPU host); returns the global
    device count.  After this, :func:`make_mesh` over ``jax.devices()``
    spans hosts — dp across the network, tp across a host's NVLink — and
    the shard_map programs below run unchanged (XLA routes collectives over
    the right fabric per the mesh layout).
    """
    import jax

    if num_processes is not None and num_processes > 1 or \
            coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return len(jax.devices())


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (dp, tp) device mesh.  ``tp`` defaults to all remaining
    devices.  The devices are reshaped in order with no topology, which
    suits all-to-all NVLink within a host; across hosts ``jax.devices()``
    lists each host's devices together, so dp maps across hosts and tp
    within one."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if tp is None:
        tp = len(devices) // dp
    if dp * tp != len(devices):
        raise ValueError(f"{len(devices)} devices != dp({dp}) * tp({tp})")
    return Mesh(devices.reshape(dp, tp), ("dp", "tp"))


def _freeze(x):
    """Recursively hashable view of a config value (lists/dicts -> tuples)."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    return x


class _LRU:
    """Small bounded LRU over an insertion-ordered dict — the one
    implementation both module caches share (program cache and probe
    cache previously hand-rolled the same pop/re-insert/evict idiom)."""

    def __init__(self, max_items: int):
        self.max_items = max_items
        self._d: dict = {}

    def get(self, key):
        v = self._d.pop(key, None)
        if v is not None:
            self._d[key] = v       # re-insert: most recently used
        return v

    def put(self, key, value) -> None:
        self._d.pop(key, None)
        while len(self._d) >= self.max_items:
            self._d.pop(next(iter(self._d)))
        self._d[key] = value

    def __len__(self):
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()


_PROGRAM_CACHE = _LRU(512)

# probe keys include operand *shapes*: shape churn in a long-lived
# process must stay bounded
_PROBE_CACHE = _LRU(2048)


def _cached(key, build):
    """Memoize jitted shard_map programs by static config.  The entry
    points below construct their ``block`` closures per call; without this
    cache every call would re-trace and re-compile the whole sharded
    program (for 3-limb GEMMs that is minutes of compile per call).

    Every key component is passed through :func:`_freeze` so callers may
    hand in lists (e.g. ``add_formats``) without tripping hashability, and
    the cache is LRU-bounded so pathological key churn cannot retain
    compiled programs forever."""
    key = _freeze(key)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = jax.jit(build())
    _PROGRAM_CACHE.put(key, fn)
    return fn


def _probe_cache_get(key):
    return _PROBE_CACHE.get(key)


def _probe_cache_put(key, verdict) -> None:
    _PROBE_CACHE.put(key, verdict)


def _check_traceable(pa: QTensor, pb: QTensor, out_fmt, mul_to, add_formats,
                     kw, who: str) -> None:
    """Trace-time probe on 1-element slices: configs whose routes fall off
    the device (host Python-int paths) cannot run inside shard_map — fail
    with a clean error instead of a tracer crash.  The probe is skipped
    only for all-lane configs (lane operands AND every explicit format
    lane-stored): their products/sums fit the pair/limb working envelope,
    so those routes never go host.  A wide ``mul_to``/``out_fmt``/
    ``add_formats`` entry CAN push a lane-operand GEMM onto the host route,
    so any non-lane format forces the probe too."""
    from ..ops.widths import storage_kind

    fmts = [out_fmt] + ([mul_to] if mul_to is not None else []) \
        + list(add_formats)
    if not (pa.is_pair or pb.is_pair or pa.is_limb or pb.is_limb
            or any(storage_kind(f) != "lane" for f in fmts)):
        return
    key = _freeze((pa.fmt, pb.fmt, out_fmt, mul_to, add_formats, kw,
                   pa.shape, pb.shape, who))
    verdict = _probe_cache_get(key)
    if verdict is None:
        try:
            jax.eval_shape(
                lambda ad, bd: qgemul(QTensor(ad, pa.fmt),
                                      QTensor(bd, pb.fmt),
                                      out_fmt, mul_to=mul_to,
                                      add_formats=add_formats, **kw).data,
                pa.data, pb.data)
            _probe_cache_put(key, True)
            return
        except (jax.errors.TracerArrayConversionError,
                jax.errors.ConcretizationTypeError) as e:
            _probe_cache_put(key, False)
            raise ValueError(
                f"this GEMM config outgrows device lanes (host route); "
                f"{who} cannot run it inside shard_map") from e
    if verdict is False:
        raise ValueError(
            f"this GEMM config outgrows device lanes (host route); "
            f"{who} cannot run it inside shard_map")


def _in_spec(t: QTensor, spec: P) -> P:
    """Adjust an element-rank PartitionSpec to ``t``'s storage leaf: limb
    tensors stack K uint32 limbs on a LEADING axis (ops/limbint.py), so the
    leaf needs a leading None; pair tensors have two element-rank leaves
    that take the spec as-is."""
    return P(None, *spec) if t.is_limb else spec


def _out_spec(fmt: QFormat, spec: P) -> P:
    """Same adjustment for an output leaf, decided by the format's storage
    kind (static at trace time)."""
    from ..ops.widths import storage_kind

    return P(None, *spec) if storage_kind(fmt) == "limb" else spec


def _device_put(t: QTensor, mesh: Mesh, spec: P) -> QTensor:
    return QTensor(jax.device_put(t.data,
                                  NamedSharding(mesh, _in_spec(t, spec))),
                   t.fmt)


def shard_qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                 mul_to=None, add_formats=(), strategy: str = "auto",
                 **kw) -> QTensor:
    """Sharded C = A @ B.  See module docstring for strategy semantics."""
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    add_formats = tuple(add_formats)
    # apply transposes up front: the strategy functions shard and compute
    # on the effective operands (and auto's K must be the post-transpose
    # contraction dim)
    ta, tb = kw.pop("transpose_a", False), kw.pop("transpose_b", False)
    if ta or tb:
        from ..ops.gemm import _transpose

        a, b = _transpose(a, ta), _transpose(b, tb)
    if strategy == "auto":
        if a.ndim > 2:
            strategy = "dp"
        else:
            from ..ops.gemm import _device_epilogue_ok

            mul_fmt = mul_merge(a.fmt, b.fmt, mul_to,
                                kw.get("mul_full_prec", False))
            plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats,
                              a.shape[-1])
            # K needs int32 partial dots + the full int32-lane epilogue
            # proof (the same gate as the single-device fast path) +
            # a tp-divisible contraction dim.  Proof-lossless dots beyond
            # int32 prefer the LIMB strategy (mirroring the single-device
            # dispatch order: its per-device balanced-digit int8 partial
            # dots stay int8 matmuls whatever the operand width) with
            # k_wide as the fallback; otherwise mn is always valid
            if plan is not None and _device_epilogue_ok(plan, out_fmt) \
                    and a.shape[-1] % mesh.shape["tp"] == 0:
                strategy = "k"
            elif _k_limb_plan(a, b, out_fmt, mul_to, add_formats,
                              kw.get("mul_full_prec", False),
                              mesh.shape["tp"], plan=plan) is not None:
                strategy = "k_limb"
            elif _k_wide_plan(a, b, out_fmt, mul_to, add_formats,
                              kw.get("mul_full_prec", False),
                              mesh.shape["tp"], plan=plan) is not None:
                strategy = "k_wide"
            else:
                # order-sensitive (or envelope-excluded) config: the
                # subtree-aligned tree split K-shards it bit-exactly with
                # no proof.  mn moves ZERO collective bytes at its layout
                # (SCALING_MODEL.json), so auto keeps it when it can
                # shard the output; k_tree takes over when mn is
                # infeasible (m/n not divisible by the mesh) or the shape
                # is k-dominated, provided the split is deep enough that
                # the node gather stays small (s >= 3: <= k/8 values)
                # and the config traces on device
                strategy = "mn"
                m_, n_ = a.shape[0], b.shape[-1]
                k_ = a.shape[-1]
                mn_ok = m_ % mesh.shape["dp"] == 0 \
                    and n_ % mesh.shape["tp"] == 0
                s, _q, _E, _nn = _k_tree_split(k_, mesh.shape["tp"])
                if s >= 3 and (not mn_ok or k_ >= 8 * max(m_, n_)):
                    try:
                        _check_traceable(a[0:1, :], b[:, 0:1], out_fmt,
                                         mul_to, add_formats,
                                         dict(mul_full_prec=kw.get(
                                             "mul_full_prec", False)),
                                         "shard_qgemul auto k_tree")
                        strategy = "k_tree"
                    except ValueError:
                        pass
    if strategy == "k_limb":
        return sharded_qgemul_k_limb(a, b, out_fmt, mesh, mul_to=mul_to,
                                     add_formats=add_formats, **kw)
    if strategy == "k_limb_pipelined":
        return sharded_qgemul_k_limb_pipelined(a, b, out_fmt, mesh,
                                               mul_to=mul_to,
                                               add_formats=add_formats, **kw)
    if strategy == "k_wide":
        return sharded_qgemul_k_wide(a, b, out_fmt, mesh, mul_to=mul_to,
                                     add_formats=add_formats, **kw)
    if strategy == "k_wide_pipelined":
        return sharded_qgemul_k_wide_pipelined(a, b, out_fmt, mesh,
                                               mul_to=mul_to,
                                               add_formats=add_formats, **kw)
    if strategy == "k_tree":
        return sharded_qgemul_k_tree(a, b, out_fmt, mesh, mul_to=mul_to,
                                     add_formats=add_formats, **kw)
    if strategy == "k":
        return sharded_qgemul_k(a, b, out_fmt, mesh, mul_to=mul_to,
                                add_formats=add_formats, **kw)
    if strategy == "k_pipelined":
        return sharded_qgemul_k_pipelined(a, b, out_fmt, mesh, mul_to=mul_to,
                                          add_formats=add_formats, **kw)
    if strategy == "mn":
        return sharded_qgemul_mn(a, b, out_fmt, mesh, mul_to=mul_to,
                                 add_formats=add_formats, **kw)
    if strategy == "dp":
        return sharded_qgemul_dp(a, b, out_fmt, mesh, mul_to=mul_to,
                                 add_formats=add_formats, **kw)
    raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# M/N sharding — bit-exact for every config
# ---------------------------------------------------------------------------

def sharded_qgemul_mn(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                      mul_to=None, add_formats=(), **kw) -> QTensor:
    """Shard M over dp, N over tp; each chip computes full dot products for
    its output tile, so any accumulation config stays bit-exact.  Wide
    (pair/limb) operands and outputs shard like any other storage; configs
    that outgrow the device limb envelope raise cleanly (host routes cannot
    run inside shard_map)."""
    _check_traceable(a[0:1, :], b[:, 0:1], out_fmt, mul_to, add_formats, kw,
                     "sharded_qgemul_mn")
    a = _device_put(a, mesh, P("dp", None))
    b = _device_put(b, mesh, P(None, "tp"))
    in_a = _in_spec(a, P("dp", None))
    in_b = _in_spec(b, P(None, "tp"))
    lut = kw.get("epilogue_lut")
    res_fmt = lut.out_fmt if lut is not None else out_fmt
    out_s = _out_spec(res_fmt, P("dp", "tp"))
    fa, fb = a.fmt, b.fmt

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_a, in_b),
                 out_specs=out_s)
        def block(ad, bd):
            return qgemul(QTensor(ad, fa), QTensor(bd, fb), out_fmt,
                          mul_to=mul_to, add_formats=add_formats, **kw).data
        return block

    fn = _cached(("mn", fa, fb, out_fmt, mul_to, add_formats, _freeze(kw),
                  mesh, in_a, in_b, out_s), build)
    return QTensor(fn(a.data, b.data), res_fmt)


# ---------------------------------------------------------------------------
# K sharding — exactness-proof regime; psum/reduce-scatter over the mesh
# ---------------------------------------------------------------------------

def sharded_qgemul_k(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                     mul_to=None, add_formats=(), mul_full_prec=False,
                     reduce_scatter: bool = False,
                     epilogue_lut=None) -> QTensor:
    """Shard the contraction dim over ``tp``.  Each chip computes a partial
    int32 dot on its K-slice, then partials sum over the mesh — ``psum``
    (output replicated over tp) or ``psum_scatter`` (reduce-scatter, output
    N-sharded over tp, the TP-style layout that feeds a subsequent
    K-sharded GEMM).  The requantize epilogue runs *after* the collective,
    overlapping XLA's collective pipelining with the next tile's compute.

    Requires the lossless-accumulation proof; raises otherwise (the caller
    or :func:`shard_qgemul` should fall back to ``"mn"``).
    """
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
    plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats, k)
    if plan is None:
        raise ValueError(
            "K-sharding needs a lossless accumulation proof; this config's "
            "tree is order-sensitive — use strategy='mn'")
    if not plan.dot_interval.fits32:
        raise ValueError("dot interval exceeds int32; use strategy='mn'")
    if k % tp:
        raise ValueError(f"K={k} not divisible by tp={tp}")
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")

    out_dtype = dtype_for(out_fmt)
    if out_dtype is None:
        raise ValueError(
            "K-sharding writes int32 lanes; this output format needs "
            "wider storage - use strategy='mn'")
    from ..ops.widths import route_requant

    if route_requant(plan.dot_interval, plan.prod_frac, out_fmt) != "i32":
        # same epilogue gate as the single-device fast path: the
        # requantize intermediates (e.g. an upshift toward a larger
        # frac_bits) must provably fit int32 lanes, or the wrap would
        # silently diverge from the oracle
        raise ValueError(
            "the requantize epilogue outgrows int32 lanes for this "
            "config - use strategy='mn'")
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    prod_frac = plan.prod_frac

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(None, "tp"), P("tp", None)),
                 out_specs=P(None, "tp") if reduce_scatter else P(None, None))
        def block(ad, bd):
            x = ad if ad.dtype == jnp.int8 else ad.astype(jnp.int32)
            y = bd if bd.dtype == jnp.int8 else bd.astype(jnp.int32)
            partial_dot = jnp.matmul(x, y, preferred_element_type=jnp.int32)
            if reduce_scatter:
                dot = jax.lax.psum_scatter(partial_dot, "tp",
                                           scatter_dimension=1, tiled=True)
            else:
                dot = jax.lax.psum(partial_dot, "tp")
            raw = W.requantize_i32(dot, prod_frac, out_fmt)
            raw = raw.astype(out_dtype)
            if epilogue_lut is not None:
                # ANUS ROM fused after the collective: each chip maps its
                # own output tile, so the LUT rides every K strategy
                raw = epilogue_lut(QTensor(raw, out_fmt)).data
            return raw
        return block

    fn = _cached(("k", prod_frac, out_fmt, bool(reduce_scatter),
                  epilogue_lut, mesh), build)
    res_fmt = out_fmt if epilogue_lut is None else epilogue_lut.out_fmt
    return QTensor(fn(a.data, b.data), res_fmt)


def sharded_qgemul_k_pipelined(a: QTensor, b: QTensor, out_fmt: QFormat,
                               mesh: Mesh, mul_to=None, add_formats=(),
                               mul_full_prec=False,
                               epilogue_lut=None) -> QTensor:
    """K-sharded GEMM as a *decomposed reduce-scatter matmul*: the
    transfer overlaps the matmul compute (SURVEY.md §7 hard part 5).

    Each of the ``tp`` steps computes one output N-block's partial dot while
    the accumulator ring-rotates via ``ppermute`` — XLA schedules the async
    collective-permute of step *i* concurrently with the matmul of step
    *i+1*, hiding the interconnect latency instead of serializing a bulk
    ``psum`` after all compute (the classic latency-hiding collective
    matmul from the scaling playbook).  At step ``i`` device ``d`` computes
    the block destined to land on device ``d`` after the remaining
    ``tp-1-i`` rotations.

    Output is N-sharded over ``tp`` (reduce-scatter layout).  Same
    exactness-proof requirement as :func:`sharded_qgemul_k`.
    """
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    n = b.shape[-1]
    mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
    plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats, k)
    if plan is None or not plan.dot_interval.fits32:
        raise ValueError(
            "pipelined K-sharding needs a lossless accumulation proof; "
            "use strategy='mn' for order-sensitive configs")
    if k % tp or n % tp:
        raise ValueError(f"K={k} and N={n} must divide tp={tp}")
    bn = n // tp
    out_dtype = dtype_for(out_fmt)
    if out_dtype is None:
        raise ValueError(
            "K-sharding writes int32 lanes; this output format needs "
            "wider storage - use strategy='mn'")
    from ..ops.widths import route_requant

    if route_requant(plan.dot_interval, plan.prod_frac, out_fmt) != "i32":
        raise ValueError(
            "the requantize epilogue outgrows int32 lanes for this "
            "config - use strategy='mn'")
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    perm = [(j, (j + 1) % tp) for j in range(tp)]
    prod_frac = plan.prod_frac

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(None, "tp"), P("tp", None)),
                 out_specs=P(None, "tp"))
        def block(ad, bd):
            x = ad if ad.dtype == jnp.int8 else ad.astype(jnp.int32)
            y = bd if bd.dtype == jnp.int8 else bd.astype(jnp.int32)
            idx = jax.lax.axis_index("tp")
            m_loc = x.shape[0]
            acc = jnp.zeros((m_loc, bn), dtype=jnp.int32)
            for i in range(tp):
                blk = (idx + tp - 1 - i) % tp
                yb = jax.lax.dynamic_slice_in_dim(y, blk * bn, bn, axis=1)
                p = jnp.matmul(x, yb, preferred_element_type=jnp.int32)
                acc = jax.lax.ppermute(acc, "tp", perm) + p
            raw = W.requantize_i32(acc, prod_frac, out_fmt)
            raw = raw.astype(out_dtype)
            if epilogue_lut is not None:
                raw = epilogue_lut(QTensor(raw, out_fmt)).data
            return raw
        return block

    fn = _cached(("kp", prod_frac, out_fmt, epilogue_lut, mesh, bn), build)
    res_fmt = out_fmt if epilogue_lut is None else epilogue_lut.out_fmt
    return QTensor(fn(a.data, b.data), res_fmt)


# ---------------------------------------------------------------------------
# Subtree-aligned K sharding — ORDER-SENSITIVE configs (no proof needed)
# ---------------------------------------------------------------------------

def _k_tree_split(k: int, tp: int):
    """Split geometry for :func:`sharded_qgemul_k_tree`.

    Picks the deepest subtree level ``s`` such that (a) ``2^s | k`` — so
    level-``s`` node boundaries are global-tree-aligned and no pass-through
    exists below level ``s`` (every layer ``l < s`` has size ``(k/2^s) *
    2^(s-l)``, even) — and (b) ``2^s <= k // tp`` — so the per-device span
    stays balanced.  Returns ``(s, q, E, n_nodes)``: each device folds ``q``
    complete ``2^s``-element subtrees over its ``E = q * 2^s``-element
    K-span (the k axis zero-pads to ``tp * E``; pad elements fill whole
    level-``s`` node slots past ``n_nodes = k / 2^s`` and are sliced off
    after the gather, so they never mix into real nodes)."""
    v2 = (k & -k).bit_length() - 1
    cap = max((k // tp).bit_length() - 1, 0)
    s = min(v2, cap)
    q = -(-k // (tp << s))
    return s, q, q << s, k >> s


def _node_format(mul_fmt: QFormat, add_formats, s: int) -> QFormat:
    """Format of a level-``s`` tree node: fold the per-layer TypeAt formats
    (QuBLAS.h:4913) from the product format through layers ``0..s-1``."""
    from ..ops.reduce import layer_format
    from ..qformat import add_merge

    fmt = mul_fmt
    for l in range(s):
        lf = layer_format(add_formats, l)
        fmt = lf if lf is not None else add_merge(fmt, fmt)
    return fmt


def _shift_layers(add_formats, s: int):
    """Layer formats as seen from level ``s`` upward (TypeAt is
    ``min(layer, len-1)``, so the shifted view is a suffix that repeats its
    last element)."""
    if not add_formats or s == 0:
        return tuple(add_formats)
    return tuple(add_formats[min(s + i, len(add_formats) - 1)]
                 for i in range(max(len(add_formats) - s, 1)))


def _pad_k(t: QTensor, axis: int, pad: int) -> QTensor:
    """Zero-pad a QTensor along ``axis`` (lane / pair / limb storage).
    Zero raws are valid in every format, and pad elements only ever fill
    whole pad node slots (see :func:`_k_tree_split`)."""
    from ..ops import limbint as L

    if pad == 0:
        return t
    widths = [(0, 0)] * t.ndim
    widths[axis] = (0, pad)
    if t.is_pair:
        return QTensor(W.PairArray(jnp.pad(t.data.hi, widths),
                                   jnp.pad(t.data.lo, widths)), t.fmt)
    if t.is_limb:
        return QTensor(L.LimbArray(jnp.pad(t.data.limbs,
                                           [(0, 0)] + widths)), t.fmt)
    return QTensor(jnp.pad(t.data, widths), t.fmt)


def _gather_nodes(t: QTensor):
    """all_gather a node-leading QTensor over ``tp`` (node axis 0)."""
    from ..ops import limbint as L

    if t.is_pair:
        return QTensor(W.PairArray(
            jax.lax.all_gather(t.data.hi, "tp", axis=0, tiled=True),
            jax.lax.all_gather(t.data.lo, "tp", axis=0, tiled=True)), t.fmt)
    if t.is_limb:
        return QTensor(L.LimbArray(
            jax.lax.all_gather(t.data.limbs, "tp", axis=1, tiled=True)),
            t.fmt)
    return QTensor(jax.lax.all_gather(t.data, "tp", axis=0, tiled=True),
                   t.fmt)


def _ppermute_qt(t: QTensor, perm):
    """ppermute every storage leaf of a QTensor over ``tp``."""
    from ..ops import limbint as L

    def pp(x):
        return jax.lax.ppermute(x, "tp", perm)

    if t.is_pair:
        return QTensor(W.PairArray(pp(t.data.hi), pp(t.data.lo)), t.fmt)
    if t.is_limb:
        return QTensor(L.LimbArray(pp(t.data.limbs)), t.fmt)
    return QTensor(pp(t.data), t.fmt)


def _butterfly_fold(v: QTensor, add_formats, s: int, tp: int):
    """ppermute-butterfly top fold: log2(tp) exchange+merge rounds.

    Each round ``lvl`` pairs device ``d`` with ``d ^ 2^lvl`` — exactly the
    global tree's level-``s+lvl`` pairing of node values — and BOTH
    partners compute the quantized merge (lower index = left operand), so
    the final value ends replicated.  Moves ``log2(tp)`` node volumes per
    device instead of the all_gather's ``tp-1`` (32x less interconnect traffic at
    256 chips) and does ``log2(tp)`` merge folds instead of ``tp-1``."""
    from ..ops import elementwise as ew
    from ..ops.reduce import layer_format

    for lvl in range(tp.bit_length() - 1):
        stride = 1 << lvl
        perm = [(d, d ^ stride) for d in range(tp)]
        pv = _ppermute_qt(v, perm)
        # the tree merge is a quantized ADD of same-format operands —
        # commutative, so no left/right ordering select is needed
        v = ew.qadd(v, pv, to=layer_format(add_formats, s + lvl))
    return v


def sharded_qgemul_k_tree(a: QTensor, b: QTensor, out_fmt: QFormat,
                          mesh: Mesh, mul_to=None, add_formats=(),
                          mul_full_prec=False, epilogue_lut=None,
                          use_pallas=None,
                          butterfly: Optional[bool] = None) -> QTensor:
    """K-shard an ORDER-SENSITIVE tree GEMM — subtree-aligned, bit-exact by
    construction (round-5: closes the last parallelism asymmetry; every
    other K strategy is gated on a losslessness proof).

    The reference's canonical per-layer-quantized accumulation
    (QuBLAS.h:4960-4990, BASELINE config 1) is association-order-sensitive,
    so partials cannot psum.  But the tree is hierarchical: with the
    contraction dim split on level-``s`` subtree boundaries (``2^s | k``),
    each device folds its complete subtrees locally with the global layer
    formats (layers ``0..s-1`` — no odd tails exist below level ``s``),
    the ``k/2^s`` level-``s`` node values all_gather over the mesh (tiny:
    ``m x n x k/2^s`` elements), and the top layers fold with the shifted
    TypeAt formats via :func:`~qublas_tpu.ops.reduce.qreduce` — whose
    odd-tail converting-assignment rules reproduce the global tree's
    levels ``s..`` exactly, including ragged (non-power-of-2) ``k``.

    Any ``k >= 1`` and any ``tp`` are admitted (zero-pad to whole node
    slots, sliced off post-gather).  When a device's span is exactly one
    subtree the local fold IS a single-chip :func:`qgemul` — the blocked
    Pallas tree kernel runs unchanged per chip — and, for power-of-2
    ``tp``, the cross-device levels fold via a ppermute BUTTERFLY
    (log2(tp) exchange+merge rounds) instead of the gather.  Otherwise
    the gathered top fold is replicated over ``tp`` (O(m*n*k/2^s) elementwise
    work).  ``butterfly``: None = auto (butterfly whenever the split
    qualifies), False = always gather, True = require the butterfly
    (raises if the split does not qualify — never a silent downgrade).
    """
    from ..ops import elementwise as ew
    from ..ops.reduce import _moveaxis, qreduce

    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("k_tree shards 2-D GEMMs (use dp for batches)")
    _check_traceable(a[0:1, :], b[:, 0:1], out_fmt, mul_to, add_formats,
                     dict(mul_full_prec=mul_full_prec), "sharded_qgemul_k_tree")
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    s, q, E, n_nodes = _k_tree_split(k, tp)
    mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
    node_fmt = _node_format(mul_fmt, add_formats, s)
    top_layers = _shift_layers(add_formats, s)
    # butterfly top fold: only the clean one-subtree-per-device split has
    # exactly one node per device with tree-aligned XOR pairings
    bf_ok = q == 1 and s >= 1 and tp >= 2 and tp & (tp - 1) == 0 \
        and n_nodes == tp
    if butterfly and not bf_ok:
        raise ValueError(
            "butterfly=True needs a one-subtree-per-device power-of-2 "
            "split (q==1, tp a power of 2, n_nodes==tp); this shape "
            "does not qualify - use butterfly=None (auto) or False")
    use_bf = bf_ok if butterfly is None else bool(butterfly)
    pad = tp * E - k
    a = _pad_k(a, 1, pad)
    b = _pad_k(b, 0, pad)
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    in_a = _in_spec(a, P(None, "tp"))
    in_b = _in_spec(b, P("tp", None))
    lut = epilogue_lut
    res_fmt = lut.out_fmt if lut is not None else out_fmt
    out_s = _out_spec(res_fmt, P(None, None))
    fa, fb = a.fmt, b.fmt
    m = a.shape[0]
    n = b.shape[-1]

    def build():
        from ..ops.gemm import qgemul as _qgemul

        # check_vma off: the top fold runs on an all_gather'ed (hence
        # replicated) node array, which the varying-mesh-axes inference
        # cannot see through
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_a, in_b),
                 out_specs=out_s, check_vma=False)
        def block(ad, bd):
            qa, qb = QTensor(ad, fa), QTensor(bd, fb)
            if s == 0:
                # nodes are the quantized products themselves
                prod = ew.qmul(QTensor(qa.data[:, :, None], fa),
                               QTensor(qb.data[None, :, :], fb),
                               to=mul_to, full_prec=mul_full_prec)
                nodes = QTensor(_moveaxis(prod.data, 1, 0), prod.fmt)
            elif q == 1:
                # the whole device span is ONE complete subtree: the local
                # fold is a single-device qgemul (the tiled tree kernel
                # on the GPU); the cast into node_fmt is the identity (the
                # tree's level-s value already lives in node_fmt)
                one = _qgemul(qa, qb, node_fmt, mul_to=mul_to,
                              add_formats=add_formats,
                              mul_full_prec=mul_full_prec,
                              use_pallas=use_pallas)
                if use_bf:
                    top = _butterfly_fold(one, add_formats, s, tp)
                    res = ew.qcast(top, out_fmt)
                    if lut is not None:
                        res = lut(res)
                    return res.data
                nodes = QTensor(one.data[None, :, :]
                                if not (one.is_pair or one.is_limb)
                                else one.data.reshape(1, m, n), one.fmt)
            else:
                # q complete subtrees: fold all of them at once, layered
                # ([m, q, 2^s, n] products; even pairings only)
                ca = QTensor(qa.data.reshape(m, q, 1 << s)[..., None], fa)
                rb = QTensor(qb.data.reshape(q, 1 << s, n), fb)
                prod = ew.qmul(ca, rb, to=mul_to, full_prec=mul_full_prec)
                sub = qreduce(prod, add_formats, axis=-2)      # [m, q, n]
                nodes = QTensor(_moveaxis(sub.data, 1, 0), sub.fmt)
            gathered = _gather_nodes(nodes)                # [tp*q, m, n]
            real = gathered[0:n_nodes]                     # drop pad nodes
            top = qreduce(real, top_layers, axis=0)        # levels s..
            res = ew.qcast(top, out_fmt)
            if lut is not None:
                res = lut(res)
            return res.data
        return block

    # cache key carries m/n too: the block closure bakes the reshape and
    # node geometry (q, s, n_nodes) derived from them (round-5 review:
    # omitting them returned a stale-shape program for a second call with
    # the same formats but different output dims)
    fn = _cached(("k_tree", fa, fb, out_fmt, mul_to, add_formats,
                  mul_full_prec, lut, mesh, k, m, n, use_pallas, use_bf),
                 build)
    return QTensor(fn(a.data, b.data), res_fmt)


# ---------------------------------------------------------------------------
# Wide K sharding — pair-domain partial dots, carry-correct psum over the mesh
# ---------------------------------------------------------------------------

def _k_wide_plan(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to,
                 add_formats, mul_full_prec, tp: int, plan=None):
    """Proof gate for the wide K strategy (round-3 item 8): the global
    accumulation must be provably lossless with the *user's* formats (so
    any association/distribution order yields identical bits), plus the
    shared pair-domain admission gate
    (:func:`~qublas_tpu.ops.gemm.wide_dot_ok` — the single source this
    strategy and the single-chip fast path both use) and a tp-divisible
    contraction dim.  ``plan`` lets callers pass an already-computed
    ExactPlan.  Returns the ExactPlan or None."""
    from ..ops.gemm import wide_dot_ok

    if a.shape[-1] % tp:
        return None
    if plan is None:
        mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
        plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats,
                          a.shape[-1])
    if plan is None or not wide_dot_ok(a, b, out_fmt, plan):
        return None
    return plan


# the carry-correct column psum sums tp 16-bit columns into int32: it is
# exact only while tp * (2^16 - 1) + carries fit int32, i.e. tp < 2^15.
# Guarded at every wide-strategy entry point (ADVICE r3).
_PSUM_COLS_MAX_TP = 1 << 15


def _check_psum_tp(mesh: Mesh) -> None:
    tp = mesh.shape["tp"]
    if tp >= _PSUM_COLS_MAX_TP:
        raise ValueError(
            f"tp={tp} exceeds the carry-correct column-psum bound "
            f"(summed 16-bit columns must fit int32: tp < 2^15)")


def _psum_pair(ph, pl, scatter: bool):
    """Carry-correct cross-device sum of 64-bit pairs: psum four 16-bit
    limb columns as int32 (each per-device column < 2^16, so the summed
    column fits int32 while tp < 2^15 — ``_check_psum_tp``), then
    carry-propagate locally.  Mod-2^64 addition is exact for the true dot
    because the proof bounds it (and every partial) to the signed 64-bit
    range."""
    u_hi = jax.lax.bitcast_convert_type(ph, jnp.uint32)
    cols = (pl & jnp.uint32(0xFFFF), pl >> 16,
            u_hi & jnp.uint32(0xFFFF), u_hi >> 16)
    if scatter:
        s = [jax.lax.psum_scatter(c.astype(jnp.int32), "tp",
                                  scatter_dimension=1, tiled=True)
             for c in cols]
    else:
        s = [jax.lax.psum(c.astype(jnp.int32), "tp") for c in cols]
    c0 = s[0]
    l0, car = c0 & 0xFFFF, c0 >> 16
    c1 = s[1] + car
    l1, car = c1 & 0xFFFF, c1 >> 16
    c2 = s[2] + car
    l2, car = c2 & 0xFFFF, c2 >> 16
    l3 = (s[3] + car) & 0xFFFF                        # mod 2^64
    lo = l0.astype(jnp.uint32) | (l1.astype(jnp.uint32) << 16)
    hi = jax.lax.bitcast_convert_type(
        l2.astype(jnp.uint32) | (l3.astype(jnp.uint32) << 16), jnp.int32)
    return hi, lo


def sharded_qgemul_k_wide(a: QTensor, b: QTensor, out_fmt: QFormat,
                          mesh: Mesh, mul_to=None, add_formats=(),
                          mul_full_prec=False, reduce_scatter: bool = False,
                          epilogue_lut=None) -> QTensor:
    """K-sharded GEMM for proof-lossless configs whose dot outgrows int32
    but fits the 64-bit pair domain — the wide-format side of the BASELINE
    north star ("weights and GEMM operands tensor-sharded"), which round 2
    could only shard mn.

    Each chip computes its K-slice's partial dot *exactly* in (hi, lo)
    pair arithmetic (segment matmuls when products fit int32 lanes —
    :func:`~qublas_tpu.ops.gemm.pair_dot_2d`), partials combine with a carry-correct
    psum/psum_scatter of 16-bit limb columns over the mesh, and the pair
    requantize epilogue (:func:`~qublas_tpu.ops.wideint.requantize_pair` /
    ``_keep``) runs after the collective.  Bit-exact by the same argument
    as the single-device fast path: the lossless proof makes every
    association and distribution order produce identical bits.

    Requires the proof; raises otherwise (use strategy='mn').
    """
    from ..ops.widths import storage_kind

    _check_psum_tp(mesh)
    tp = mesh.shape["tp"]
    plan = _k_wide_plan(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                        tp)
    if plan is None:
        raise ValueError(
            "wide K-sharding needs 2-D lane/pair operands, tp | K, a "
            "lossless accumulation proof with the dot in the 64-bit "
            "domain, and a lane/pair-domain epilogue; use strategy='mn'")
    kind = storage_kind(out_fmt)
    if epilogue_lut is not None and kind != "lane":
        raise ValueError("epilogue_lut needs a lane-storage output format")
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")
    prod_iv = plan.prod_interval
    prod_frac = plan.prod_frac
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    out_rank = P(None, "tp") if reduce_scatter else P(None, None)
    out_s = _out_spec(out_fmt, out_rank)
    out_dtype = dtype_for(out_fmt)

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(None, "tp"), P("tp", None)),
                 out_specs=out_s)
        def block(ad, bd):
            ph, pl = pair_dot_2d(ad, bd, prod_iv)
            hi, lo = _psum_pair(ph, pl, reduce_scatter)
            if kind == "lane":
                raw = W.requantize_pair((hi, lo), prod_frac, out_fmt) \
                    .astype(out_dtype)
                if epilogue_lut is not None:
                    raw = epilogue_lut(QTensor(raw, out_fmt)).data
                return raw
            h2, l2 = W.requantize_pair_keep((hi, lo), prod_frac, out_fmt)
            return W.PairArray(h2, l2)
        return block

    fn = _cached(("kw", a.fmt, b.fmt, prod_frac, out_fmt,
                  bool(reduce_scatter), epilogue_lut, mesh), build)
    res_fmt = out_fmt if epilogue_lut is None else epilogue_lut.out_fmt
    return QTensor(fn(a.data, b.data), res_fmt)


def _slice_n(y, start, size):
    """Dynamic N-block slice of a ``[k, n]`` operand in any device storage
    form (lane array / PairArray / LimbArray — the limb stack keeps its
    leading K axis)."""
    from ..ops import limbint as L

    if isinstance(y, W.PairArray):
        return W.PairArray(
            jax.lax.dynamic_slice_in_dim(y.hi, start, size, axis=1),
            jax.lax.dynamic_slice_in_dim(y.lo, start, size, axis=1))
    if isinstance(y, L.LimbArray):
        return L.LimbArray(
            jax.lax.dynamic_slice_in_dim(y.limbs, start, size, axis=2))
    return jax.lax.dynamic_slice_in_dim(y, start, size, axis=1)


def sharded_qgemul_k_wide_pipelined(a: QTensor, b: QTensor, out_fmt: QFormat,
                                    mesh: Mesh, mul_to=None, add_formats=(),
                                    mul_full_prec=False,
                                    epilogue_lut=None) -> QTensor:
    """Pair-domain K-sharded GEMM as a decomposed reduce-scatter matmul —
    :func:`sharded_qgemul_k_pipelined`'s latency-hiding ring generalized to
    dots beyond int32 (round 4).

    Each of the ``tp`` steps computes one output N-block's exact (hi, lo)
    partial dot (:func:`~qublas_tpu.ops.gemm.pair_dot_2d`) while the pair
    accumulator ring-rotates via ``ppermute`` — XLA overlaps the async
    permute with the next block's compute.  Ring accumulation uses
    exact mod-2^64 :func:`~qublas_tpu.ops.wideint.pair_add` (no column psum,
    so no tp bound): every intermediate is a subset sum of ≤k products and
    the losslessness proof bounds it to the signed 64-bit domain.

    Output is N-sharded over ``tp`` (reduce-scatter layout).  Same proof
    gate as :func:`sharded_qgemul_k_wide`; raises otherwise (use 'mn').
    """
    from ..ops.widths import storage_kind

    tp = mesh.shape["tp"]
    n = b.shape[-1]
    plan = _k_wide_plan(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                        tp)
    if plan is None or n % tp:
        raise ValueError(
            "pipelined wide K-sharding needs 2-D lane/pair operands, "
            "tp | K and tp | N, a lossless accumulation proof with the dot "
            "in the 64-bit domain, and a lane/pair-domain epilogue; use "
            "strategy='mn'")
    kind = storage_kind(out_fmt)
    if epilogue_lut is not None and kind != "lane":
        raise ValueError("epilogue_lut needs a lane-storage output format")
    bn = n // tp
    prod_iv = plan.prod_interval
    prod_frac = plan.prod_frac
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    out_s = _out_spec(out_fmt, P(None, "tp"))
    out_dtype = dtype_for(out_fmt)
    perm = [(j, (j + 1) % tp) for j in range(tp)]

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(None, "tp"), P("tp", None)),
                 out_specs=out_s)
        def block(ad, bd):
            idx = jax.lax.axis_index("tp")
            m_loc = ad.shape[0]
            acc = (jnp.zeros((m_loc, bn), jnp.int32),
                   jnp.zeros((m_loc, bn), jnp.uint32))
            for i in range(tp):
                blk = (idx + tp - 1 - i) % tp
                yb = _slice_n(bd, blk * bn, bn)
                p = pair_dot_2d(ad, yb, prod_iv)
                acc = (jax.lax.ppermute(acc[0], "tp", perm),
                       jax.lax.ppermute(acc[1], "tp", perm))
                acc = W.pair_add(acc, p)
            if kind == "lane":
                raw = W.requantize_pair(acc, prod_frac, out_fmt) \
                    .astype(out_dtype)
                if epilogue_lut is not None:
                    raw = epilogue_lut(QTensor(raw, out_fmt)).data
                return raw
            h2, l2 = W.requantize_pair_keep(acc, prod_frac, out_fmt)
            return W.PairArray(h2, l2)
        return block

    fn = _cached(("kwp", a.fmt, b.fmt, prod_frac, out_fmt, epilogue_lut,
                  mesh, bn), build)
    res_fmt = out_fmt if epilogue_lut is None else epilogue_lut.out_fmt
    return QTensor(fn(a.data, b.data), res_fmt)


# ---------------------------------------------------------------------------
# Limb K sharding — digit-domain partial dots, carry-correct limb psum
# ---------------------------------------------------------------------------

def _k_limb_plan(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to,
                 add_formats, mul_full_prec, tp: int, plan=None):
    """Proof gate for the limb-domain K strategy (round 4): the global
    accumulation must be provably lossless with the user's formats, plus
    the shared limb-dot admission gate
    (:func:`~qublas_tpu.ops.gemm.limb_dot_plan` — the single source this
    strategy and the single-chip limb fast path both use) and a
    tp-divisible contraction dim.  Returns (plan, working_limbs) or None.

    The working limb count comes from the GLOBAL k, so it covers the
    psummed total and — by subset-sum — every per-chip partial."""
    from ..ops.gemm import limb_dot_plan

    if a.ndim != 2 or b.ndim != 2 or a.is_host or b.is_host:
        return None
    if a.shape[-1] % tp:
        return None
    if plan is None:
        mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
        plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats, a.shape[-1])
    if plan is None:
        return None
    Kw = limb_dot_plan(a.fmt, b.fmt, out_fmt, plan, a.shape[-1],
                       a.shape[-2], b.shape[-1])
    if Kw is None:
        return None
    return plan, Kw


def _psum_limbs(limbs, scatter: bool):
    """Carry-correct cross-device sum of stacked ``(Kw, m, n)`` uint32
    limbs — :func:`_psum_pair` generalized to ``2*Kw`` 16-bit columns
    (VERDICT r3 item 1): split each limb into two 16-bit columns (each
    per-device column < 2^16, so the summed column fits int32 while
    tp < 2^15 — ``_check_psum_tp``), ONE psum / psum_scatter of the stacked
    ``(2*Kw, m, n)`` int32 tensor over the mesh, then a local carry-propagate
    pass.  Mod-2^(32*Kw) addition is exact for the true dot because the
    limb plan bounds it (and every partial) to the working width."""
    Kw = limbs.shape[0]
    cols = jnp.stack([limbs & jnp.uint32(0xFFFF), limbs >> 16], axis=1) \
        .reshape((2 * Kw,) + limbs.shape[1:]).astype(jnp.int32)
    if scatter:
        s = jax.lax.psum_scatter(cols, "tp", scatter_dimension=cols.ndim - 1,
                                 tiled=True)
    else:
        s = jax.lax.psum(cols, "tp")
    halves = []
    car = None
    for d in range(2 * Kw):
        t = s[d] if car is None else s[d] + car
        halves.append(t & 0xFFFF)
        car = t >> 16
    out = [halves[2 * i].astype(jnp.uint32)
           | (halves[2 * i + 1].astype(jnp.uint32) << 16)
           for i in range(Kw)]
    return jnp.stack(out, axis=0)


def sharded_qgemul_k_limb(a: QTensor, b: QTensor, out_fmt: QFormat,
                          mesh: Mesh, mul_to=None, add_formats=(),
                          mul_full_prec=False, reduce_scatter: bool = False,
                          epilogue_lut=None) -> QTensor:
    """K-sharded GEMM for proof-lossless configs whose dot outgrows even the
    64-bit pair domain — wide pair operands (e.g. 40×40-bit GEMMs), stacked
    N-limb operands, limb-storage outputs.  Completes the "tensor-sharded
    operands" north star across the full device width envelope (round 4;
    these configs previously could only shard mn).

    Each chip computes its K-slice's partial dot *exactly* as a
    balanced-digit int8 matmul recombined into stacked uint32 limbs
    (:func:`~qublas_tpu.ops.limbdot.limb_dot_2d`), partials combine with a
    carry-correct psum / psum_scatter of 2·Kw 16-bit limb columns over the mesh,
    and the limb requantize epilogue
    (:func:`~qublas_tpu.ops.limbint.requantize_limb`) runs after the
    collective.  Bit-exact by the losslessness proof: every association and
    distribution order produces identical bits.

    Requires the proof; raises otherwise (use strategy='mn').
    """
    from ..ops import limbint as L
    from ..ops.limbdot import limb_dot_2d
    from ..ops.widths import storage_kind

    _check_psum_tp(mesh)
    tp = mesh.shape["tp"]
    got = _k_limb_plan(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                       tp)
    if got is None:
        raise ValueError(
            "limb K-sharding needs 2-D device operands, tp | K, a lossless "
            "accumulation proof, and a dot/epilogue inside the limb "
            "working envelope; use strategy='mn'")
    plan, Kw = got
    kind = storage_kind(out_fmt)
    if epilogue_lut is not None and kind != "lane":
        raise ValueError("epilogue_lut needs a lane-storage output format")
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")
    iva, ivb = fmt_interval(a.fmt), fmt_interval(b.fmt)
    prod_frac = plan.prod_frac
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    in_a = _in_spec(a, P(None, "tp"))
    in_b = _in_spec(b, P("tp", None))
    out_rank = P(None, "tp") if reduce_scatter else P(None, None)
    out_s = _out_spec(out_fmt, out_rank)
    out_dtype = dtype_for(out_fmt)
    fa, fb = a.fmt, b.fmt

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_a, in_b),
                 out_specs=out_s)
        def block(ad, bd):
            # shard_map hands PairArray/LimbArray pytrees back whole, and
            # limb_dot_2d accepts all three storage forms directly
            acc = limb_dot_2d(ad, bd, iva, ivb, Kw)
            tot = _psum_limbs(acc, reduce_scatter)
            raw = L.requantize_limb(tot, prod_frac, out_fmt)
            if kind == "lane":
                raw = raw.astype(out_dtype)
                if epilogue_lut is not None:
                    raw = epilogue_lut(QTensor(raw, out_fmt)).data
                return raw
            if kind == "pair":
                return W.PairArray(raw[0], raw[1])
            return L.LimbArray(raw)
        return block

    fn = _cached(("kl", fa, fb, prod_frac, out_fmt, Kw,
                  bool(reduce_scatter), epilogue_lut, mesh), build)
    res_fmt = out_fmt if epilogue_lut is None else epilogue_lut.out_fmt
    return QTensor(fn(a.data, b.data), res_fmt)


def sharded_qgemul_k_limb_pipelined(a: QTensor, b: QTensor, out_fmt: QFormat,
                                    mesh: Mesh, mul_to=None, add_formats=(),
                                    mul_full_prec=False,
                                    epilogue_lut=None) -> QTensor:
    """Limb-domain K-sharded GEMM as a decomposed reduce-scatter matmul —
    the latency-hiding ``ppermute`` ring for proof-lossless dots beyond the
    64-bit pair domain (round 4; completes the pipelined family across the
    full device width envelope).

    Each of the ``tp`` steps computes one output N-block's exact stacked
    ``(Kw, m, bn)`` limb partial dot
    (:func:`~qublas_tpu.ops.limbdot.limb_dot_2d`) while the limb accumulator
    ring-rotates via ``ppermute``.  Ring accumulation uses exact
    mod-2^(32·Kw) :func:`~qublas_tpu.ops.limbint.ladd` (no column psum, so
    no tp bound): every intermediate is a subset sum of ≤k products and the
    global-k limb plan bounds it to the working width.

    Output is N-sharded over ``tp``.  Same proof gate as
    :func:`sharded_qgemul_k_limb`; raises otherwise (use 'mn').
    """
    from ..ops import limbint as L
    from ..ops.limbdot import limb_dot_2d
    from ..ops.widths import storage_kind

    tp = mesh.shape["tp"]
    n = b.shape[-1]
    got = _k_limb_plan(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                       tp)
    if got is None or n % tp:
        raise ValueError(
            "pipelined limb K-sharding needs 2-D device operands, tp | K "
            "and tp | N, a lossless accumulation proof, and a dot/epilogue "
            "inside the limb working envelope; use strategy='mn'")
    plan, Kw = got
    kind = storage_kind(out_fmt)
    if epilogue_lut is not None and kind != "lane":
        raise ValueError("epilogue_lut needs a lane-storage output format")
    bn = n // tp
    iva, ivb = fmt_interval(a.fmt), fmt_interval(b.fmt)
    prod_frac = plan.prod_frac
    a = _device_put(a, mesh, P(None, "tp"))
    b = _device_put(b, mesh, P("tp", None))
    in_a = _in_spec(a, P(None, "tp"))
    in_b = _in_spec(b, P("tp", None))
    out_s = _out_spec(out_fmt, P(None, "tp"))
    out_dtype = dtype_for(out_fmt)
    fa, fb = a.fmt, b.fmt
    perm = [(j, (j + 1) % tp) for j in range(tp)]

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_a, in_b),
                 out_specs=out_s)
        def block(ad, bd):
            idx = jax.lax.axis_index("tp")
            m_loc = ad.shape[0]
            acc = jnp.zeros((Kw, m_loc, bn), jnp.uint32)
            for i in range(tp):
                blk = (idx + tp - 1 - i) % tp
                yb = _slice_n(bd, blk * bn, bn)
                p = limb_dot_2d(ad, yb, iva, ivb, Kw)
                acc = L.ladd(jax.lax.ppermute(acc, "tp", perm), p)
            raw = L.requantize_limb(acc, prod_frac, out_fmt)
            if kind == "lane":
                raw = raw.astype(out_dtype)
                if epilogue_lut is not None:
                    raw = epilogue_lut(QTensor(raw, out_fmt)).data
                return raw
            if kind == "pair":
                return W.PairArray(raw[0], raw[1])
            return L.LimbArray(raw)
        return block

    fn = _cached(("klp", fa, fb, prod_frac, out_fmt, Kw, epilogue_lut,
                  mesh, bn), build)
    res_fmt = out_fmt if epilogue_lut is None else epilogue_lut.out_fmt
    return QTensor(fn(a.data, b.data), res_fmt)


# ---------------------------------------------------------------------------
# DP batch sharding — multi-host batched GEMM streaming
# ---------------------------------------------------------------------------

def sharded_qgemul_dp(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                      mul_to=None, add_formats=(), **kw) -> QTensor:
    """Shard the leading batch dim over the whole mesh (dp×tp): each chip
    runs independent GEMMs on its batch slice — the cross-host streaming pattern
    (BASELINE north star: "batched quantized GEMM streams continuously
    across hosts")."""
    if a.ndim < 3:
        raise ValueError("dp strategy needs a batched LHS [batch, m, k]")
    pa = a[(0,) * (a.ndim - 2)][0:1, :]
    pb = (b[(0,) * (b.ndim - 2)] if b.ndim > 2 else b)[:, 0:1]
    _check_traceable(pa, pb, out_fmt, mul_to, add_formats, kw,
                     "sharded_qgemul_dp")
    axes = ("dp", "tp")
    spec_a = P(axes, *([None] * (a.ndim - 1)))
    spec_b = P(axes, *([None] * (b.ndim - 1))) if b.ndim == a.ndim else \
        P(*([None] * b.ndim))
    a = _device_put(a, mesh, spec_a)
    b = _device_put(b, mesh, spec_b)
    in_a, in_b = _in_spec(a, spec_a), _in_spec(b, spec_b)
    lut = kw.get("epilogue_lut")
    res_fmt = lut.out_fmt if lut is not None else out_fmt
    out_s = _out_spec(res_fmt, spec_a)
    fa, fb = a.fmt, b.fmt

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_a, in_b),
                 out_specs=out_s)
        def block(ad, bd):
            return qgemul(QTensor(ad, fa), QTensor(bd, fb), out_fmt,
                          mul_to=mul_to, add_formats=add_formats, **kw).data
        return block

    fn = _cached(("dp", fa, fb, out_fmt, mul_to, add_formats, _freeze(kw),
                  mesh, in_a, in_b, out_s), build)
    return QTensor(fn(a.data, b.data), res_fmt)


# ---------------------------------------------------------------------------
# Complex GEMM sharding (TF/Basic per-product algorithms)
# ---------------------------------------------------------------------------

def _stack_qt(ts):
    """Stack same-format QTensors along a new leading axis (any storage)."""
    from ..ops import limbint as L

    t0 = ts[0]
    if t0.is_pair:
        data = W.PairArray(jnp.stack([t.data.hi for t in ts]),
                           jnp.stack([t.data.lo for t in ts]))
    elif t0.is_limb:
        data = L.LimbArray(jnp.stack([t.data.limbs for t in ts], axis=1))
    elif t0.is_host:
        data = np.stack([t.data for t in ts])
    else:
        data = jnp.stack([t.data for t in ts])
    return QTensor(data, t0.fmt)


def _stack_complex(cs):
    from ..complex import QComplexTensor

    return QComplexTensor(_stack_qt([c.real for c in cs]),
                          _stack_qt([c.imag for c in cs]))


def sharded_cgemul(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                   add_formats=(), strategy: str = "auto", **mul_tags):
    """Sharded complex C = A @ B (see :func:`qublas_tpu.ops.cgemm.cgemul`).

    ``"mn"`` (always bit-exact, any config) shards M over dp and N over tp;
    ``"k"`` shards the contraction dim and psums the 3 (TF) / 4 (basic)
    integer dots over the mesh — valid only under the complex fast path's
    lossless proof.  ``"auto"`` probes the proof and picks.
    """
    from ..ops.cgemm import _fast_cgemul, _part_formats, _split_layers

    if strategy == "auto" and a.real.ndim > 2:
        n_dev = mesh.shape["dp"] * mesh.shape["tp"]
        if a.real.shape[0] % n_dev == 0:
            strategy = "dp"
        else:
            # valid-but-unaligned batch (ADVICE r4): auto must not raise —
            # run each batch element through the 2D auto path and stack
            from ..complex import QComplexTensor

            outs = [sharded_cgemul(
                        QComplexTensor(a.real[(i,)], a.imag[(i,)]),
                        QComplexTensor(b.real[(i,)], b.imag[(i,)])
                        if b.real.ndim == a.real.ndim else b,
                        out_fmt, mesh, algo=algo, add_formats=add_formats,
                        strategy="auto", **mul_tags)
                    for i in range(a.real.shape[0])]
            return _stack_complex(outs)
    if strategy == "auto":
        # memoize the fast-path-proof verdict: it is static per config,
        # and the eager 1-row x 1-col probe costs a device dispatch
        key = _freeze(("cauto", a.real.fmt, a.imag.fmt, b.real.fmt,
                       b.imag.fmt, out_fmt, algo, add_formats, mul_tags,
                       a.shape[-1], a.shape[0], b.shape[-1]))
        ok = _probe_cache_get(key)
        if ok is None:
            orf, oif = _part_formats(out_fmt)
            r_layers, i_layers = _split_layers(add_formats)
            probe = _fast_cgemul(_crow(a, 0), _ccol(b, 0), orf, oif, algo,
                                 r_layers, i_layers, mul_tags,
                                 k_total=a.shape[-1],
                                 cap_mn=(a.shape[0], b.shape[-1]))
            ok = probe is not None
            _probe_cache_put(key, ok)
        if ok and a.shape[-1] % mesh.shape["tp"] == 0:
            strategy = "k"
        else:
            # order-sensitive complex config: same policy as the real
            # GEMM's auto (round 5) — mn moves zero collective bytes, so
            # k_tree takes over only when mn cannot shard the output or
            # the shape is k-dominated, with a deep enough split
            strategy = "mn"
            m_, n_, k_ = a.shape[0], b.shape[-1], a.shape[-1]
            mn_ok = m_ % mesh.shape["dp"] == 0 \
                and n_ % mesh.shape["tp"] == 0
            s, _q, _E, _nn = _k_tree_split(k_, mesh.shape["tp"])
            if s >= 3 and (not mn_ok or k_ >= 8 * max(m_, n_)):
                try:
                    _cgemul_probe(a, b, out_fmt, algo, add_formats,
                                  mul_tags, "sharded_cgemul auto k_tree")
                    strategy = "k_tree"
                except ValueError:
                    pass
    if strategy == "k":
        return sharded_cgemul_k(a, b, out_fmt, mesh, algo=algo,
                                add_formats=add_formats, **mul_tags)
    if strategy == "k_tree":
        return sharded_cgemul_k_tree(a, b, out_fmt, mesh, algo=algo,
                                     add_formats=add_formats, **mul_tags)
    if strategy == "mn":
        return sharded_cgemul_mn(a, b, out_fmt, mesh, algo=algo,
                                 add_formats=add_formats, **mul_tags)
    if strategy == "dp":
        return sharded_cgemul_dp(a, b, out_fmt, mesh, algo=algo,
                                 add_formats=add_formats, **mul_tags)
    raise ValueError(f"unknown strategy {strategy!r}")


def sharded_cgemul_k_tree(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                          add_formats=(), butterfly: Optional[bool] = None,
                          **mul_tags):
    """K-shard an ORDER-SENSITIVE complex GEMM — the complex analogue of
    :func:`sharded_qgemul_k_tree` (round 5), bit-exact for every config
    with no losslessness gate.

    Per part the accumulation is the same vector-path tree, so the same
    subtree-aligned split applies: each device computes its K-slice's
    complex products (Basic/TF per-step quantization) and folds complete
    ``2^s``-element subtrees per part with the global per-part layer
    formats; the per-part node values all_gather; the top layers fold
    with shifted TypeAt formats; each part then takes its converting
    assignment into ``out_fmt``.  One-subtree-per-device power-of-2
    splits instead run the LOCAL fold as a single-chip :func:`cgemul`
    (full fast dispatch, incl. the distributed int8 TF lowering when the
    local slice proves lossless) and fold the cross-device levels with
    the ppermute butterfly per part.  ``butterfly``: None = auto, False
    = gather, True = require the butterfly (raises when the split does
    not qualify).
    """
    from ..complex import QComplexTensor, cmul, cmul_tf
    from ..ops import elementwise as ew
    from ..ops.cgemm import _split_layers, cgemul
    from ..ops.reduce import _moveaxis, qreduce

    if a.real.ndim != 2 or b.real.ndim != 2:
        raise ValueError("k_tree shards 2-D complex GEMMs (dp for batches)")
    orf, oif = _cgemul_probe(a, b, out_fmt, algo, add_formats, mul_tags,
                             "sharded_cgemul_k_tree")
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    s, q, E, n_nodes = _k_tree_split(k, tp)
    r_layers, i_layers = _split_layers(add_formats)
    r_layers, i_layers = tuple(r_layers), tuple(i_layers)
    top_r = _shift_layers(r_layers, s)
    top_i = _shift_layers(i_layers, s)
    # per-part product formats (static, tag quirks included) -> level-s
    # node formats for the q==1 local-cgemul reuse
    from .. import hostops as _ho

    _mulh = _ho.complex_mul_tf if algo == "tf" else _ho.complex_mul_basic
    (_z1, pr_fmt), (_z2, pi_fmt) = _mulh(
        ((0, a.real.fmt), (0, a.imag.fmt)),
        ((0, b.real.fmt), (0, b.imag.fmt)), **mul_tags)
    node_r = _node_format(pr_fmt, r_layers, s)
    node_i = _node_format(pi_fmt, i_layers, s)
    bf_ok = q == 1 and s >= 1 and tp >= 2 and tp & (tp - 1) == 0 \
        and n_nodes == tp
    if butterfly and not bf_ok:
        raise ValueError(
            "butterfly=True needs a one-subtree-per-device power-of-2 "
            "split (q==1, tp a power of 2, n_nodes==tp); this shape "
            "does not qualify - use butterfly=None (auto) or False")
    use_bf = bf_ok if butterfly is None else bool(butterfly)
    pad = tp * E - k
    ar = _device_put(_pad_k(a.real, 1, pad), mesh, P(None, "tp"))
    ai = _device_put(_pad_k(a.imag, 1, pad), mesh, P(None, "tp"))
    br = _device_put(_pad_k(b.real, 0, pad), mesh, P("tp", None))
    bi = _device_put(_pad_k(b.imag, 0, pad), mesh, P("tp", None))
    in_specs = (_in_spec(ar, P(None, "tp")), _in_spec(ai, P(None, "tp")),
                _in_spec(br, P("tp", None)), _in_spec(bi, P("tp", None)))
    out_specs = (_out_spec(orf, P(None, None)),
                 _out_spec(oif, P(None, None)))
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    m = a.real.shape[0]
    n = b.real.shape[-1]
    mulfn = cmul_tf if algo == "tf" else cmul

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
                 out_specs=out_specs, check_vma=False)
        def block(ard, aid, brd, bid):
            if q == 1 and s >= 1:
                # the device span is one complete subtree per part: reuse
                # the single-chip complex GEMM (fast dispatch) into the
                # level-s node formats — identity final casts
                loc = cgemul(
                    QComplexTensor(QTensor(ard, far), QTensor(aid, fai)),
                    QComplexTensor(QTensor(brd, fbr), QTensor(bid, fbi)),
                    (node_r, node_i), algo=algo, add_formats=add_formats,
                    **mul_tags)

                def fold_one(t, layers, top, of):
                    if use_bf:
                        topv = _butterfly_fold(t, layers, s, tp)
                    else:
                        nodes = QTensor(
                            t.data[None, :, :]
                            if not (t.is_pair or t.is_limb)
                            else t.data.reshape(1, m, n), t.fmt)
                        real_nodes = _gather_nodes(nodes)[0:n_nodes]
                        topv = qreduce(real_nodes, top, axis=0)
                    return ew.qcast(topv, of or topv.fmt).data

                return (fold_one(loc.real, r_layers, top_r, orf),
                        fold_one(loc.imag, i_layers, top_i, oif))
            pa = QComplexTensor(QTensor(ard[:, :, None], far),
                                QTensor(aid[:, :, None], fai))
            pb = QComplexTensor(QTensor(brd[None, :, :], fbr),
                                QTensor(bid[None, :, :], fbi))
            prod = mulfn(pa, pb, **mul_tags)         # [m, E, n] per part

            def fold(t, layers, top, of):
                if s == 0:
                    nodes = QTensor(_moveaxis(t.data, 1, 0), t.fmt)
                else:
                    r = QTensor(t.data.reshape(m, q, 1 << s, n), t.fmt)
                    sub = qreduce(r, layers, axis=-2)     # [m, q, n]
                    nodes = QTensor(_moveaxis(sub.data, 1, 0), sub.fmt)
                real_nodes = _gather_nodes(nodes)[0:n_nodes]
                topv = qreduce(real_nodes, top, axis=0)
                return ew.qcast(topv, of or topv.fmt).data

            return (fold(prod.real, r_layers, top_r, orf),
                    fold(prod.imag, i_layers, top_i, oif))
        return block

    fn = _cached(("ck_tree", far, fai, fbr, fbi, out_fmt, algo,
                  add_formats, _freeze(mul_tags), mesh, k, m, n, use_bf),
                 build)
    rr, ri = fn(ar.data, ai.data, br.data, bi.data)
    return QComplexTensor(QTensor(rr, orf), QTensor(ri, oif))


def sharded_cgemul_dp(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                      add_formats=(), **mul_tags):
    """Shard the leading batch dim of a batched complex GEMM over the whole
    mesh (dp×tp): each chip runs independent complex GEMMs on its batch
    slice — the complex side of the cross-host streaming pattern
    (:func:`sharded_qgemul_dp`).  Bit-exact for every config: each batch
    element's full GEMM stays on one chip."""
    from ..complex import QComplexTensor

    if a.real.ndim < 3:
        raise ValueError("dp strategy needs a batched LHS [batch, m, k]")
    from ..ops.cgemm import cgemul

    orf, oif = _cgemul_probe(a, b, out_fmt, algo, add_formats, mul_tags,
                             "sharded_cgemul_dp")
    n_dev = mesh.shape["dp"] * mesh.shape["tp"]
    if a.real.shape[0] % n_dev:
        raise ValueError(
            f"batch dim {a.real.shape[0]} not divisible by {n_dev} devices")
    axes = ("dp", "tp")
    spec_a = P(axes, *([None] * (a.real.ndim - 1)))
    spec_b = P(axes, *([None] * (b.real.ndim - 1))) \
        if b.real.ndim == a.real.ndim else P(*([None] * b.real.ndim))
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    in_ar = _in_spec(a.real, spec_a)
    in_ai = _in_spec(a.imag, spec_a)
    in_br = _in_spec(b.real, spec_b)
    in_bi = _in_spec(b.imag, spec_b)
    ar = jax.device_put(a.real.data, NamedSharding(mesh, in_ar))
    ai = jax.device_put(a.imag.data, NamedSharding(mesh, in_ai))
    br = jax.device_put(b.real.data, NamedSharding(mesh, in_br))
    bi = jax.device_put(b.imag.data, NamedSharding(mesh, in_bi))
    out_r = _out_spec(orf, spec_a)
    out_i = _out_spec(oif, spec_a)

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(in_ar, in_ai, in_br, in_bi),
                 out_specs=(out_r, out_i))
        def block(ard, aid, brd, bid):
            c = cgemul(QComplexTensor(QTensor(ard, far), QTensor(aid, fai)),
                       QComplexTensor(QTensor(brd, fbr), QTensor(bid, fbi)),
                       out_fmt, algo=algo, add_formats=add_formats,
                       **mul_tags)
            return c.real.data, c.imag.data
        return block

    fn = _cached(("cdp", far, fai, fbr, fbi, _freeze(out_fmt), algo,
                  _freeze(add_formats), _freeze(mul_tags), mesh,
                  in_ar, in_br), build)
    rr, ri = fn(ar, ai, br, bi)
    return QComplexTensor(QTensor(rr, orf), QTensor(ri, oif))


def _cgemul_probe(a, b, out_fmt, algo, add_formats, mul_tags,
                  who: str):
    """Trace-time (eval_shape) probe of a 1-row x 1-col complex GEMM with
    the global K: validates the config never routes to host (clean error
    instead of a tracer crash inside shard_map) and recovers the output
    part formats (static trace metadata) when ``out_fmt`` leaves them to
    inference.  Memoized — formats and verdicts are static per config."""
    from ..complex import QComplexTensor
    from ..ops.cgemm import cgemul

    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    if a.real.is_host or a.imag.is_host or b.real.is_host or b.imag.is_host:
        raise ValueError(
            f"this complex GEMM config outgrows device lanes (host "
            f"route); {who} cannot run it inside shard_map")
    key = _freeze(("cprobe", far, fai, fbr, fbi, out_fmt, algo,
                   add_formats, mul_tags, a.shape[-1]))
    hit = _probe_cache_get(key)
    if hit is False:
        raise ValueError(
            f"this complex GEMM config outgrows device lanes (host "
            f"route); {who} cannot run it inside shard_map")
    if hit is not None:
        return hit
    box = {}

    def probe(ard, aid, brd, bid):
        c = cgemul(QComplexTensor(QTensor(ard, far), QTensor(aid, fai)),
                   QComplexTensor(QTensor(brd, fbr), QTensor(bid, fbi)),
                   out_fmt, algo=algo, add_formats=add_formats, **mul_tags)
        box["fmts"] = (c.real.fmt, c.imag.fmt)
        return c.real.data, c.imag.data

    try:
        jax.eval_shape(probe,
                       a.real.data[..., :1, :], a.imag.data[..., :1, :],
                       b.real.data[..., :, :1], b.imag.data[..., :, :1])
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError) as e:
        _probe_cache_put(key, False)
        raise ValueError(
            f"this complex GEMM config outgrows device lanes (host "
            f"route); {who} cannot run it inside shard_map") from e
    _probe_cache_put(key, box["fmts"])
    return box["fmts"]


def _crow(c, i):
    """1-row complex slice (cheap proof/format probe operand)."""
    from ..complex import QComplexTensor

    return QComplexTensor(QTensor(c.real.data[i:i + 1, :], c.real.fmt),
                          QTensor(c.imag.data[i:i + 1, :], c.imag.fmt))


def _ccol(c, j):
    """1-column complex slice."""
    from ..complex import QComplexTensor

    return QComplexTensor(QTensor(c.real.data[:, j:j + 1], c.real.fmt),
                          QTensor(c.imag.data[:, j:j + 1], c.imag.fmt))


def sharded_cgemul_mn(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                      add_formats=(), **mul_tags):
    """Shard M over dp, N over tp; each chip computes full complex dots for
    its tile — bit-exact for every config (incl. order-sensitive trees and
    all tag-default quirks)."""
    from ..complex import QComplexTensor
    from ..ops.cgemm import cgemul

    orf, oif = _cgemul_probe(a, b, out_fmt, algo, add_formats, mul_tags,
                             "sharded_cgemul_mn")
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    ar = jax.device_put(a.real.data, NamedSharding(mesh, P("dp", None)))
    ai = jax.device_put(a.imag.data, NamedSharding(mesh, P("dp", None)))
    br = jax.device_put(b.real.data, NamedSharding(mesh, P(None, "tp")))
    bi = jax.device_put(b.imag.data, NamedSharding(mesh, P(None, "tp")))

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P("dp", None), P("dp", None),
                           P(None, "tp"), P(None, "tp")),
                 out_specs=(P("dp", "tp"), P("dp", "tp")))
        def block(ard, aid, brd, bid):
            c = cgemul(QComplexTensor(QTensor(ard, far), QTensor(aid, fai)),
                       QComplexTensor(QTensor(brd, fbr), QTensor(bid, fbi)),
                       out_fmt, algo=algo, add_formats=add_formats,
                       **mul_tags)
            return c.real.data, c.imag.data
        return block

    fn = _cached(("cmn", far, fai, fbr, fbi, _freeze(out_fmt), algo,
                  _freeze(add_formats), _freeze(mul_tags), mesh), build)
    rr, ri = fn(ar, ai, br, bi)
    return QComplexTensor(QTensor(rr, orf), QTensor(ri, oif))


def sharded_cgemul_k(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                     add_formats=(), reduce_scatter: bool = False,
                     **mul_tags):
    """Shard the contraction dim over ``tp``: each chip computes the complex
    fast path's partial integer dots (3 matmuls for TF, 4 for basic) on
    its K-slice; partials psum over the mesh — or ``psum_scatter``
    (``reduce_scatter=True``, output N-sharded over tp) — before the exact
    shift/combine epilogue.  Since late round 4 the wide regime rides the
    same hook: complex dots beyond int32 compute as per-chip limb dots and
    combine with the carry-correct limb psum.  Requires the lossless proof
    — bit-exact because integer addition order cannot matter when no step
    rounds or saturates."""
    from ..complex import QComplexTensor
    from ..ops.cgemm import _fast_cgemul, _part_formats, _split_layers

    k = a.shape[-1]
    tp = mesh.shape["tp"]
    if k % tp:
        raise ValueError(f"K={k} not divisible by tp={tp}")
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")
    orf, oif = _part_formats(out_fmt)
    r_layers, i_layers = _split_layers(add_formats)
    # 1-row x 1-col probe with the GLOBAL k: validates the proof and
    # recovers output formats without computing the full product.  cap_mn
    # pins the limb-envelope caps to the FULL output dims so the probe's
    # domain decision matches the full-shape trace inside shard_map
    cap = (a.shape[0], b.shape[-1])
    pinfo = {}
    probe = _fast_cgemul(_crow(a, 0), _ccol(b, 0), orf, oif, algo,
                         r_layers, i_layers, mul_tags, k_total=k,
                         cap_mn=cap, info=pinfo)
    if probe is None:
        raise ValueError(
            "K-sharded cgemul needs the lossless fast-path proof; this "
            "config is order-sensitive - use strategy='mn'")
    if pinfo.get("domain") == "limb":
        # the limb-domain hook psums 16-bit columns (same soundness bound
        # as the wide/limb GEMM strategies)
        _check_psum_tp(mesh)
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    in_ar = _in_spec(a.real, P(None, "tp"))
    in_ai = _in_spec(a.imag, P(None, "tp"))
    in_br = _in_spec(b.real, P("tp", None))
    in_bi = _in_spec(b.imag, P("tp", None))
    ar = jax.device_put(a.real.data, NamedSharding(mesh, in_ar))
    ai = jax.device_put(a.imag.data, NamedSharding(mesh, in_ai))
    br = jax.device_put(b.real.data, NamedSharding(mesh, in_br))
    bi = jax.device_put(b.imag.data, NamedSharding(mesh, in_bi))
    out_rank = P(None, "tp") if reduce_scatter else P(None, None)
    out_r = _out_spec(probe.real.fmt, out_rank)
    out_i = _out_spec(probe.imag.fmt, out_rank)

    if reduce_scatter:
        def _red(d):
            return jax.lax.psum_scatter(d, "tp", scatter_dimension=1,
                                        tiled=True)

        def _lred(d):
            return _psum_limbs(d, True)
    else:
        def _red(d):
            return jax.lax.psum(d, "tp")

        def _lred(d):
            return _psum_limbs(d, False)

    def build():
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(in_ar, in_ai, in_br, in_bi),
                 out_specs=(out_r, out_i))
        def block(ard, aid, brd, bid):
            la = QComplexTensor(QTensor(ard, far), QTensor(aid, fai))
            lb = QComplexTensor(QTensor(brd, fbr), QTensor(bid, fbi))
            c = _fast_cgemul(la, lb, orf, oif, algo, r_layers, i_layers,
                             mul_tags,
                             dot_reduce=_red, limb_dot_reduce=_lred,
                             k_total=k, cap_mn=cap)
            # probe above proved the plan; local slices share the formats
            return c.real.data, c.imag.data
        return block

    fn = _cached(("ck", far, fai, fbr, fbi, orf, oif, algo,
                  _freeze(r_layers), _freeze(i_layers), _freeze(mul_tags),
                  mesh, k, cap, bool(reduce_scatter)), build)
    rr, ri = fn(ar, ai, br, bi)
    return QComplexTensor(QTensor(rr, probe.real.fmt),
                          QTensor(ri, probe.imag.fmt))


# ---------------------------------------------------------------------------
# Sharded Qreduce
# ---------------------------------------------------------------------------

def sharded_qreduce(x: QTensor, layer_formats=(), axis: int = -1,
                    mesh: Mesh = None, batch_axis: int = 0) -> QTensor:
    """Batch-sharded tree reduction: shard ``batch_axis`` over the whole
    mesh (dp x tp) and run the exact per-lane tree locally — bit-exact for
    every config because each lane's full tree stays on one chip."""
    from ..ops.reduce import qreduce

    if x.ndim < 2:
        raise ValueError("sharded_qreduce needs a batch axis; "
                         "use sharded_qreduce_k for 1-D inputs")
    if batch_axis % x.ndim == axis % x.ndim:
        raise ValueError("batch_axis must differ from the reduction axis")
    n_dev = mesh.shape["dp"] * mesh.shape["tp"]
    if x.shape[batch_axis] % n_dev:
        raise ValueError(
            f"batch dim {x.shape[batch_axis]} not divisible by {n_dev}")
    axes = ("dp", "tp")
    spec = [None] * x.ndim
    spec[batch_axis] = axes
    # limb-stored tensors stack K uint32 limbs on a LEADING axis
    # (ops/limbint.py) — the sharding spec needs a leading None so the
    # batch axis, not the limb axis, is what shards
    in_spec = P(None, *spec) if x.is_limb else P(*spec)
    xd = jax.device_put(x.data, NamedSharding(mesh, in_spec))
    red_axis = axis % x.ndim
    out_rank_spec = [s for i, s in enumerate(spec) if i != red_axis]

    # probe the output format/storage on a single lane via eval_shape
    # (trace-time only, memoized — no device dispatch per call)
    key = _freeze(("qrprobe", x.fmt, layer_formats, x.shape[red_axis],
                   x.is_limb, x.is_pair))
    hit = _probe_cache_get(key)
    if hit is False:
        raise ValueError(
            "this reduction outgrows device lanes (host route); "
            "sharded_qreduce cannot run it inside shard_map")
    if hit is None:
        slc = x[tuple(slice(0, 1) if i != red_axis else slice(None)
                      for i in range(x.ndim))]
        box = {}

        def probe_fn(data):
            r = qreduce(QTensor(data, x.fmt), layer_formats, axis=red_axis)
            box["res"] = (r.fmt, r.is_limb)
            return r.data

        try:
            jax.eval_shape(probe_fn, slc.data)
        except (jax.errors.TracerArrayConversionError,
                jax.errors.ConcretizationTypeError) as e:
            _probe_cache_put(key, False)
            raise ValueError(
                "this reduction outgrows device lanes (host route); "
                "sharded_qreduce cannot run it inside shard_map") from e
        hit = box["res"]
        _probe_cache_put(key, hit)
    out_fmt, out_is_limb = hit
    out_spec = P(None, *out_rank_spec) if out_is_limb \
        else P(*out_rank_spec)

    fmt = x.fmt

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_spec,),
                 out_specs=out_spec)
        def block(data):
            return qreduce(QTensor(data, fmt), layer_formats,
                           axis=red_axis).data
        return block

    fn = _cached(("qr", fmt, _freeze(layer_formats), red_axis, in_spec,
                  out_spec, mesh), build)
    return QTensor(fn(xd), out_fmt)


def sharded_qreduce_k(x: QTensor, layer_formats=(), mesh: Mesh = None) -> QTensor:
    """Reduction-axis-sharded tree reduction of a vector: each chip sums its
    slice with plain int32 adds, partials psum over the mesh, then one final
    requantize.  Valid only when the per-layer tree is provably lossless
    (``tree_exact``) so integer-addition order cannot change bits."""
    from ..ops.gemm import tree_exact
    from ..ops.reduce import _normalize
    from ..ops.widths import fmt_interval

    layer_formats = _normalize(layer_formats)
    if x.ndim != 1:
        raise ValueError("sharded_qreduce_k reduces a 1-D vector")
    n = x.shape[0]
    tp = mesh.shape["tp"]
    if n % tp:
        raise ValueError(f"n={n} not divisible by tp={tp}")
    final_fmt = tree_exact(fmt_interval(x.fmt), x.fmt, layer_formats, n)
    if final_fmt is None:
        raise ValueError(
            "sharded_qreduce_k needs a lossless tree proof; this config is "
            "order-sensitive - use the batch-sharded form or a single chip")
    total_iv = fmt_interval(x.fmt)
    total_iv = Interval(min(total_iv.lo * n, total_iv.lo),
                        max(total_iv.hi * n, total_iv.hi))
    from ..ops.widths import route_requant, storage_kind

    # wide regime (round 3, mirrors the GEMM k_wide strategy): the lossless
    # sum outgrows int32 but fits the 64-bit pair domain — per-chip exact
    # pair sums, carry-correct 16-bit-column psum, pair epilogue.
    # Beyond the pair domain (limb values, >64-bit sums, limb-storage
    # final formats): exact stacked-limb sums per chip, carry-correct
    # 2*Kw-column limb psum, limb epilogue (round 4 — mirrors the GEMM
    # k_limb strategy; these configs previously had no K strategy)
    frac = x.fmt.frac_bits
    regime = "i32" if total_iv.fits32 else "pair"
    limb_k = None
    if regime == "pair" and not (
            total_iv.fits64 and not x.is_limb and not x.is_host
            and storage_kind(final_fmt) in ("lane", "pair")
            and route_requant(total_iv, frac, final_fmt)
            in ("i32", "pair")):
        regime = "limb"
    if regime != "i32":
        _check_psum_tp(mesh)
    if regime == "limb":
        from ..ops.limbint import bits_to_limbs
        from ..ops.widths import LIMB_INTER_MAX_BITS, requant_work_bits

        need = max(total_iv.bits,
                   requant_work_bits(total_iv, frac, final_fmt))
        if x.is_host or storage_kind(final_fmt) is None \
                or need > LIMB_INTER_MAX_BITS:
            raise ValueError(
                "sum outgrows the device limb working envelope - use the "
                "batch-sharded form")
        limb_k = bits_to_limbs(need)
    out_dtype = dtype_for(final_fmt)
    if regime == "i32":
        if out_dtype is None:
            raise ValueError(
                "sharded_qreduce_k writes int32 lanes; this reduction's "
                "final format needs wider storage - use the batch-sharded "
                "form")
        if route_requant(total_iv, frac, final_fmt) != "i32":
            raise ValueError(
                "the requantize epilogue outgrows int32 lanes for this "
                "config - use the batch-sharded form")

    xd = jax.device_put(x.data, NamedSharding(mesh, _in_spec(x, P("tp"))))
    in_s = _in_spec(x, P("tp"))
    val_iv = fmt_interval(x.fmt)

    def build():
        from ..ops import limbint as L
        from ..ops.gemm import pair_sum_1d
        from ..ops.limbdot import limb_axis_sum, to_limbs_any

        out_kind = storage_kind(final_fmt)
        out_s = _out_spec(final_fmt, P(None)) \
            if out_kind in ("pair", "limb") and regime != "i32" else P(None)

        @partial(jax.shard_map, mesh=mesh, in_specs=(in_s,),
                 out_specs=out_s)
        def block(data):
            if regime == "i32":
                s = jnp.sum(data.astype(jnp.int32), keepdims=True)
                tot = jax.lax.psum(s, "tp")
                raw = W.requantize_i32(tot, frac, final_fmt)
                return raw.astype(out_dtype)
            if regime == "limb":
                limbs = to_limbs_any(data, limb_k)        # (Kw, n_loc)
                part = limb_axis_sum(limbs, 0)            # (Kw,)
                tot = _psum_limbs(part.reshape(limb_k, 1, 1), False)
                raw = L.requantize_limb(tot.reshape(limb_k, 1), frac,
                                        final_fmt)
                if out_kind == "lane":
                    return raw.astype(out_dtype)
                if out_kind == "pair":
                    return W.PairArray(raw[0], raw[1])
                return L.LimbArray(raw)
            ph, pl = pair_sum_1d(data, val_iv)
            ph, pl = ph.reshape(1, 1), pl.reshape(1, 1)
            hi, lo = _psum_pair(ph, pl, False)
            if out_kind == "lane":
                raw = W.requantize_pair((hi, lo), frac, final_fmt)
                return raw.reshape(1).astype(out_dtype)
            h2, l2 = W.requantize_pair_keep((hi, lo), frac, final_fmt)
            return W.PairArray(h2.reshape(1), l2.reshape(1))
        return block

    fn = _cached(("qrk", x.fmt, frac, final_fmt, regime, limb_k, mesh),
                 build)
    return QTensor(fn(xd)[0], final_fmt)


def sharded_qreduce_k_tree(x: QTensor, layer_formats=(),
                           mesh: Mesh = None,
                           butterfly: Optional[bool] = None) -> QTensor:
    """Reduction-axis sharding of an ORDER-SENSITIVE tree reduction
    (round 5 — the Qreduce analogue of :func:`sharded_qgemul_k_tree`).

    :func:`sharded_qreduce_k` is gated on a losslessness proof; this form
    shards ANY config bit-exactly by construction: split the vector on
    level-``s`` subtree boundaries (``2^s | n``), fold complete subtrees
    per device with the global layer formats (no pass-throughs exist
    below level ``s``), all_gather the ``n/2^s`` node values, and fold
    the top layers with the shifted TypeAt formats — :func:`qreduce`'s
    odd-tail converting assignments reproduce the global tree, including
    ragged/odd ``n`` (zero-pad to whole node slots, sliced post-gather).
    One-node-per-device power-of-2 splits fold via the ppermute
    butterfly; ``butterfly``: None = auto, False = gather, True =
    require it (raises when the split does not qualify).
    """
    from ..qformat import add_merge
    from ..ops.reduce import _normalize, layer_format, qreduce

    layer_formats = _normalize(layer_formats)
    if x.ndim != 1:
        raise ValueError("sharded_qreduce_k_tree reduces a 1-D vector")
    if x.is_host:
        raise ValueError("host-storage values cannot run inside shard_map")
    n = x.shape[0]
    tp = mesh.shape["tp"]
    s, q, E, n_nodes = _k_tree_split(n, tp)
    # trace-time probe: wide configs whose tree falls to the host route
    # cannot run inside shard_map — fail cleanly
    try:
        jax.eval_shape(
            lambda d: qreduce(QTensor(d, x.fmt), layer_formats).data,
            x.data)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError) as e:
        raise ValueError(
            "this reduction outgrows device lanes (host route); "
            "sharded_qreduce_k_tree cannot run it inside shard_map") from e
    top_layers = _shift_layers(layer_formats, s)
    # final format: walk the full tree's layer chain (static)
    cur, m, layer = x.fmt, n, 0
    while m > 1:
        lf = layer_format(layer_formats, layer)
        cur = lf if lf is not None else add_merge(cur, cur)
        m = (m + 1) // 2
        layer += 1
    final_fmt = cur
    xp = _pad_k(x, 0, tp * E - n)
    xp = _device_put(xp, mesh, P("tp"))
    in_s = _in_spec(xp, P("tp"))
    out_s = _out_spec(final_fmt, P())
    fmtx = x.fmt
    bf_ok = q == 1 and s >= 1 and tp >= 2 and tp & (tp - 1) == 0 \
        and n_nodes == tp
    if butterfly and not bf_ok:
        raise ValueError(
            "butterfly=True needs a one-subtree-per-device power-of-2 "
            "split (q==1, tp a power of 2, n_nodes==tp); this shape "
            "does not qualify - use butterfly=None (auto) or False")
    use_bf = bf_ok if butterfly is None else bool(butterfly)

    def build():
        @partial(jax.shard_map, mesh=mesh, in_specs=(in_s,),
                 out_specs=out_s, check_vma=False)
        def block(data):
            t = QTensor(data, fmtx)
            if s == 0:
                nodes = t                              # [E] raw elements
            else:
                nodes = qreduce(QTensor(t.data.reshape(q, 1 << s), fmtx),
                                layer_formats, axis=1)  # [q]
            if use_bf:
                # one node per device: ppermute-butterfly merge rounds
                v = _butterfly_fold(nodes, layer_formats, s, tp)
                return v[0].data
            gathered = _gather_nodes(nodes)            # [tp*q]
            real = gathered[0:n_nodes]
            top = qreduce(real, top_layers, axis=0)
            return top.data
        return block

    fn = _cached(("qrk_tree", fmtx, layer_formats, mesh, n, use_bf), build)
    return QTensor(fn(xp.data), final_fmt)
