"""Device tree reduction with per-layer requantization (Qreduce).

Device re-design of the reference's ``Reducer`` (reference
``include/QuBLAS.h:4899-5018``): "tree-based reduction is a common operation
in asic design" (:4901).  The reference's recursion over static vector types
becomes a trace-time Python loop over jnp slices — depth ⌈log₂ n⌉, each layer
one fused elementwise add + requantize over the whole remaining vector, so
XLA sees a static log-depth DAG it can fuse.

Semantics replicated exactly:

* Per layer, elements (2i, 2i+1) combine via ``Qadd`` quantized to the
  layer's format — ``TypeAt<min(layer, len(formats)-1)>`` (:4906-4921); with
  no formats the layer vector keeps the input element type (:4963-4966) and
  the add uses default AddMerger inference (identity for equal formats).
* An odd tail element is *copied* into the next layer — a converting
  assignment (= requantize) into the layer vector's element type
  (:4977-4980).
* N-D tensors reduce over their row-major flattening (:4992-5001).
* The reference's variadic entry point deviates for odd counts (tail added
  to the *final* result, :4943-4949); that form is host-only —
  :func:`qublas_tpu.hostops.qreduce_args`.  This module implements the
  vector path, which is also what Qgemul's dot products use.
"""

from __future__ import annotations

import numpy as np

from .. import hostops
from ..qformat import QFormat
from ..qtensor import QTensor, from_raw
from . import elementwise as ew

__all__ = ["qreduce", "qreduce_args", "layer_format"]

def qreduce_args(values, layer_formats=()):
    """Variadic-entry tree reduction over scalar QTensors (reference
    ``Qreduce(q1, q2, ...)``, QuBLAS.h:4924-4957).

    Deviates from the vector path for odd counts: the leftover element is
    added to the *final* result with the current layer's format
    (QuBLAS.h:4943-4949).  The reference restricts this form to scalars;
    evaluation is host-side via the golden model (it is an init-time
    convenience, not a hot path).
    """
    from ..qtensor import from_raw

    pairs = []
    for v in values:
        if v.size != 1:
            raise ValueError("qreduce_args takes scalar QTensors")
        pairs.append((int(np.asarray(v.raw(), dtype=object).reshape(())),
                      v.fmt))
    raw, fmt = hostops.qreduce_args(pairs, layer_formats)
    return from_raw(np.array(raw, dtype=object), fmt)


def layer_format(layer_formats, layer: int):
    """Per-layer output format: ``TypeAt<min(layer, len-1)>``
    (QuBLAS.h:4913)."""
    if not layer_formats:
        return None
    return layer_formats[min(layer, len(layer_formats) - 1)]


def _normalize(layer_formats):
    if layer_formats is None:
        return ()
    if isinstance(layer_formats, QFormat):
        return (layer_formats,)
    return tuple(layer_formats)


def qreduce(x: QTensor, layer_formats=(), axis=None) -> QTensor:
    """Tree-reduce a QTensor with per-layer requantization.

    ``axis=None`` reduces the row-major flattening to a scalar (the reference
    entry point, QuBLAS.h:4992-5001).  An integer ``axis`` reduces along that
    axis only — a batched extension the reference cannot express (its tensors
    reduce whole); this is what the GEMM path uses for dot products.

    The per-layer slice/add program is the path on every backend; XLA
    fuses the log-depth layer chain.
    """
    layer_formats = _normalize(layer_formats)
    if axis is None:
        x = QTensor(x.data.reshape(-1), x.fmt)
        axis = 0
    axis = axis % max(x.ndim, 1)
    n = x.shape[axis]
    if n == 0:
        raise ValueError("qreduce of empty axis")

    if x.is_host:
        return _qreduce_host(x, layer_formats, axis)

    # move the reduction axis to the front; everything after is batch
    cur = QTensor(_moveaxis(x.data, axis, 0), x.fmt)

    layer = 0
    while cur.shape[0] > 1:
        m = cur.shape[0]
        fmt = layer_format(layer_formats, layer)
        a = cur[0 : (m // 2) * 2 : 2]
        b = cur[1 : (m // 2) * 2 : 2]
        s = ew.qadd(a, b, to=fmt)
        if s.is_host:
            # a layer outgrew the device lanes: finish exactly on the host,
            # continuing from the current layer (formats already consumed
            # stay consumed — TypeAt indexes the original layer number)
            return _qreduce_host(cur, layer_formats, 0, first_layer=layer)
        if m % 2:
            tail = cur[m - 1 : m]
            # converting assignment into the layer vector's element type
            tail = ew.qcast(tail, s.fmt)
            s = QTensor(_concat([s.data, tail.data]), s.fmt)
        cur = s
        layer += 1
    out = QTensor(cur.data[0], cur.fmt)
    return out


def _moveaxis(arr, src, dst):
    import jax.numpy as jnp

    from .limbint import LimbArray
    from .wideint import PairArray

    if isinstance(arr, PairArray):
        return PairArray(jnp.moveaxis(arr.hi, src, dst),
                         jnp.moveaxis(arr.lo, src, dst))
    if isinstance(arr, LimbArray):
        nd = arr.ndim
        return LimbArray(jnp.moveaxis(arr.limbs, src % nd + 1, dst % nd + 1))
    return jnp.moveaxis(arr, src, dst)


def _concat(parts):
    import jax.numpy as jnp

    from .limbint import LimbArray
    from .wideint import PairArray

    if isinstance(parts[0], PairArray):
        return PairArray(jnp.concatenate([p.hi for p in parts], axis=0),
                         jnp.concatenate([p.lo for p in parts], axis=0))
    if isinstance(parts[0], LimbArray):
        k = max(p.nlimbs for p in parts)
        from .limbint import lext

        return LimbArray(jnp.concatenate([lext(p.limbs, k) for p in parts],
                                         axis=1))
    return jnp.concatenate(parts, axis=0)


def _qreduce_host(x: QTensor, layer_formats, axis: int,
                  first_layer: int = 0) -> QTensor:
    """Exact host path for wide formats: per-lane golden-model reduction.
    ``first_layer`` offsets the layer index for TypeAt when resuming a
    reduction the device path started."""
    if first_layer:
        layer_formats = tuple(
            layer_format(layer_formats, first_layer + i)
            for i in range(max(len(layer_formats) - first_layer, 1))
        ) if layer_formats else ()
    arr = np.asarray(x.raw(), dtype=object)
    arr = np.moveaxis(arr, axis, -1)
    batch_shape = arr.shape[:-1]
    flat = arr.reshape(-1, arr.shape[-1])
    out_raws, out_fmt = [], None
    for lane in flat:
        r, out_fmt = hostops.qreduce_list(
            [(int(v), x.fmt) for v in lane], layer_formats)
        out_raws.append(r)
    return from_raw(np.array(out_raws, dtype=object).reshape(batch_shape),
                    out_fmt)
