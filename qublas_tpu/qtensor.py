"""QTensor: a fixed-point tensor = raw-integer array + QFormat.

Device replacement for the reference's ``Qu_s<dim<...>, elem>`` container
(QuBLAS.h:2675-3037).  The reference's static shape algebra, expression
templates and materialization loops all collapse into JAX: shapes are array
shapes, laziness is XLA fusion, slicing is jnp indexing.

Raw values are stored in the smallest integer lane dtype that holds the
format's physical storage (int8/int16/int32).  Formats wider than 32 bits
(the reference supports arbitrary widths; its tests go to 200 bits) are held
host-side as object arrays of Python ints and computed with the exact golden
model — capability-complete, but not the hot path.

``QTensor`` is a registered pytree (data = leaf, format = static aux data),
so it flows through ``jit``/``shard_map``/``scan`` like any array.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import hostint
from .ops.widths import dtype_for, storage_kind
from .qformat import QFormat

__all__ = ["QTensor", "from_float", "from_raw", "zeros", "random_fill",
           "from_double", "scalar"]


def _min_dtype_for_values(vmin: int, vmax: int, floor_dtype):
    order = [np.int8, np.int16, np.int32]
    info = {np.int8: 8, np.int16: 16, np.int32: 32}
    floor_bits = {None: 64, jnp.int8: 8, jnp.int16: 16, jnp.int32: 32}[floor_dtype]
    for dt in order:
        bits = info[dt]
        if bits < floor_bits:
            continue
        if vmin >= -(1 << (bits - 1)) and vmax <= (1 << (bits - 1)) - 1:
            return dt
    return None


@jax.tree_util.register_pytree_node_class
class QTensor:
    """Raw integer data + fixed-point format."""

    __slots__ = ("data", "fmt")

    def __init__(self, data, fmt: QFormat):
        self.data = data
        self.fmt = fmt

    # --- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data,), self.fmt

    @classmethod
    def tree_unflatten(cls, fmt, children):
        return cls(children[0], fmt)

    # --- basic introspection -------------------------------------------------
    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return self.data.size

    @property
    def is_host(self) -> bool:
        """True when the raw data lives host-side as Python ints (formats
        wider than 64-bit storage, or lane formats holding out-of-word raw
        values via the ``fill(int)`` wart)."""
        return isinstance(self.data, np.ndarray) and self.data.dtype == object

    @property
    def is_pair(self) -> bool:
        """True when storage is the device (hi, lo) 32-bit limb pair
        (formats with 33..64-bit physical storage)."""
        from .ops.wideint import PairArray

        return isinstance(self.data, PairArray)

    @property
    def is_limb(self) -> bool:
        """True when storage is the device stacked (K, ...) uint32 limb
        array (formats with 65..384-bit physical storage)."""
        from .ops.limbint import LimbArray

        return isinstance(self.data, LimbArray)

    # --- conversions ---------------------------------------------------------
    def raw(self) -> np.ndarray:
        """Raw storage integers as a NumPy array (host transfer if needed);
        object dtype of Python ints for limb-stored wide formats."""
        if self.is_pair:
            return self.data.to_numpy_int64()
        if self.is_limb:
            return self.data.to_numpy_ints()
        return np.asarray(self.data)

    def raw_list(self):
        return [int(v) for v in self.raw().reshape(-1)]

    def to_double(self) -> np.ndarray:
        """Per-element double value = raw / 2^frac_bits (QuBLAS.h:2413-2416)."""
        if self.is_host:
            flat = [hostint.raw_to_double(int(v), self.fmt)
                    for v in self.data.reshape(-1)]
            return np.array(flat, dtype=np.float64).reshape(self.shape)
        return self.raw().astype(np.float64) * (2.0 ** -self.fmt.frac_bits)

    def astype(self, fmt: QFormat) -> "QTensor":
        """Cross-format conversion = requantize with the destination's modes
        (reference converting copy, QuBLAS.h:2758-2830)."""
        from .ops import elementwise

        return elementwise.qcast(self, fmt)

    def to_bits(self, tensor_order=None, elem_order=None) -> str:
        from . import bitstream

        return bitstream.to_bits(self, tensor_order, elem_order)

    # --- reference-parity utilities -----------------------------------------
    def display(self, name: str = "") -> str:
        """Pretty printer mirroring the reference display() info content
        (QuBLAS.h:2418-2431, 2898-2909)."""
        lines = []
        if name:
            lines.append(f"{name} :")
        f = self.fmt
        lines.append(f"intBits: {f.int_bits} fracBits: {f.frac_bits} "
                     f"isSigned: {int(f.signed)}")
        lines.append(str(self.to_double()))
        out = "\n".join(lines)
        print(out)
        return out

    def to_matlab(self, filename: str):
        """Text export parity with Qu_s::toMatlab (QuBLAS.h:2980-3036):
        whitespace-separated doubles, one matrix row per line."""
        vals = self.to_double()
        arr2d = vals.reshape(-1, vals.shape[-1]) if vals.ndim > 1 else vals.reshape(1, -1)
        with open(filename, "w") as fh:
            for row in arr2d:
                fh.write(" ".join(repr(float(v)) for v in row) + "\n")

    def __repr__(self):
        return f"QTensor(shape={tuple(self.shape)}, fmt={self.fmt})"

    # --- indexing / slicing ---------------------------------------------------
    def __getitem__(self, idx) -> "QTensor":
        """Slicing/views (replaces reference sr<>/SliceExpression, L7)."""
        return QTensor(self.data[idx], self.fmt)

    def shuffle(self, seed: int = 1) -> "QTensor":
        """Random permutation of the flattened elements (capability parity
        with the reference tensor's ``shuffle()``, QuBLAS.h:2843-2850),
        using NumPy's permutation stream.  For the reference's *exact*
        ``std::shuffle(gen)`` permutation use
        :func:`qublas_tpu.refrand.reference_shuffle`."""
        perm = np.random.RandomState(seed).permutation(int(self.size))
        if self.is_host:
            flat = self.data.reshape(-1)[perm]
            return QTensor(flat.reshape(self.data.shape), self.fmt)
        return QTensor(self.data.reshape(-1)[perm].reshape(self.shape),
                       self.fmt)

    # --- operators (XLA-fused elementwise; replaces reference expression
    #     templates, L6 — laziness is the compiler's job) ---------------------
    def _ew(self, name, other):
        from .complex import QComplexTensor

        if isinstance(other, QComplexTensor):
            # real op complex: defer to QComplexTensor's reflected
            # operators (rc_mul/rc_add/rc_sub, QuBLAS.h:3600-3663)
            return NotImplemented
        from .ops import elementwise

        return getattr(elementwise, name)(self, other)

    def __mul__(self, other):
        return self._ew("qmul", other)

    def __add__(self, other):
        return self._ew("qadd", other)

    def __sub__(self, other):
        return self._ew("qsub", other)

    def __truediv__(self, other):
        return self._ew("qdiv", other)

    def __neg__(self):
        from .ops import elementwise

        return elementwise.qneg(self)

    def __abs__(self):
        from .ops import elementwise

        return elementwise.qabs(self)


# ------------------------------------------------------------------------
# Constructors
# ------------------------------------------------------------------------

def from_raw(values: Any, fmt: QFormat, validate: bool = False) -> QTensor:
    """Build a QTensor from raw storage integers.

    Parity note: like the reference's ``fill(int)`` (QuBLAS.h:2447-2452) this
    does *not* mask or sign-extend — out-of-range raw values are stored as
    given (the reference holds even 8-bit formats in int32 words).  Pass
    ``validate=True`` to assert values are within the format's storage range.
    """
    if isinstance(values, np.ndarray) and values.dtype != object \
            and np.issubdtype(values.dtype, np.integer):
        # numeric fast path (e.g. the native engine's int64 output, bench
        # tensors): min/max at C speed, no per-element Python boxing
        arr = values
        empty = arr.size == 0
        vmin = 0 if empty else int(arr.min())
        vmax = 0 if empty else int(arr.max())

        def as_object():
            return arr.astype(object)

        def as_lanes(dt):
            return np.ascontiguousarray(arr, dtype=dt)
    else:
        arr = np.asarray(values, dtype=object)
        if storage_kind(fmt) is None and not validate:
            # host storage and no range check requested: the O(n)
            # min/max pass below would be pure overhead (it only picks
            # device storage) — round-3 profiling of the >256-bit public
            # elementwise path
            return QTensor(arr, fmt)
        flat = [int(v) for v in arr.reshape(-1)]
        empty = not flat
        vmin = min(flat) if flat else 0
        vmax = max(flat) if flat else 0

        def as_object():
            return arr

        def as_lanes(dt):
            return np.array(flat, dtype=dt).reshape(arr.shape)
    if validate:
        if not empty and (vmin < fmt.raw_min or vmax > fmt.raw_max):
            raise ValueError(
                f"raw values [{vmin},{vmax}] exceed storage of {fmt}")
    kind = storage_kind(fmt)
    if kind is None:
        return QTensor(as_object(), fmt)
    if kind == "pair":
        if not empty and (vmin < -(1 << 63) or vmax >= (1 << 63)):
            # beyond the 64-bit machine word: keep exact host ints (the
            # fill(int) wart stores raw values as given)
            return QTensor(as_object(), fmt)
        from .ops.wideint import pair_from_int64_np

        return QTensor(pair_from_int64_np(arr), fmt)
    if kind == "limb":
        from .ops.limbint import LimbArray, limbs_from_ints
        from .ops.widths import limb_count

        K = limb_count(fmt)
        word = 1 << (32 * K - 1)
        if not empty and (vmin < -word or vmax >= word):
            # fill(int) wart beyond the storage word: keep exact host ints
            return QTensor(as_object(), fmt)
        return QTensor(LimbArray(limbs_from_ints(arr, K)), fmt)
    floor_dt = dtype_for(fmt)
    dt = _min_dtype_for_values(vmin, vmax, floor_dt)
    if dt is None:
        # values exceed int32 lanes: keep host-side
        return QTensor(as_object(), fmt)
    return QTensor(jnp.asarray(as_lanes(dt)), fmt)


def from_float(values: Any, fmt: QFormat) -> QTensor:
    """Exact double → fixed conversion, element-wise on the host.

    Matches the reference's 2400-bit-exact constructor path
    (QuBLAS.h:2387-2393) for every element.  Uses the native C++ host engine
    when the format fits its 64-bit storage envelope (differentially tested
    against the Python model); falls back to exact Python ints otherwise.
    """
    arr = np.asarray(values, dtype=np.float64)
    if fmt.storage_bits <= 64:
        from . import native

        raws = native.double_to_raw(arr, fmt)
        if raws is not None:
            return from_raw(raws, fmt)
    flat = [hostint.double_to_raw(float(v), fmt) for v in arr.reshape(-1)]
    return from_raw(np.array(flat, dtype=object).reshape(arr.shape), fmt)


from_double = from_float


def scalar(value: float, fmt: QFormat) -> QTensor:
    return from_float(np.float64(value), fmt)


def zeros(shape, fmt: QFormat) -> QTensor:
    kind = storage_kind(fmt)
    if kind is None:
        return QTensor(np.zeros(shape, dtype=object), fmt)
    if kind == "pair":
        from .ops.wideint import PairArray

        return QTensor(PairArray(jnp.zeros(shape, dtype=jnp.int32),
                                 jnp.zeros(shape, dtype=jnp.uint32)), fmt)
    if kind == "limb":
        from .ops.limbint import LimbArray
        from .ops.widths import limb_count

        K = limb_count(fmt)
        return QTensor(
            LimbArray(jnp.zeros((K,) + tuple(shape), dtype=jnp.uint32)), fmt)
    return QTensor(jnp.zeros(shape, dtype=dtype_for(fmt)), fmt)


def random_fill(shape, fmt: QFormat, seed: int = 1) -> QTensor:
    """Deterministic uniform raw fill over the storage range.

    Capability parity with the reference's ``fill()`` (QuBLAS.h:526-536:
    mt19937 seeded 1, uniform over [minimum, maximum]); the stream itself is
    NumPy's (fast, vectorized).  For the reference's *bit-identical* stream
    use :func:`qublas_tpu.refrand.reference_fill`.
    """
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape)) if shape else 1
    if fmt.storage_bits <= 63:
        vals = rng.randint(fmt.raw_min, fmt.raw_max + 1, size=n, dtype=np.int64)
        return from_raw(vals.reshape(shape), fmt)
    # wide formats: compose from 32-bit draws (from_raw picks the storage —
    # device limbs up to 256-bit formats, host ints beyond)
    words = math.ceil(fmt.storage_bits / 32)
    flat = []
    span = fmt.raw_max - fmt.raw_min + 1
    for _ in range(n):
        v = 0
        for _w in range(words + 1):
            v = (v << 32) | int(rng.randint(0, 1 << 32, dtype=np.int64))
        flat.append(fmt.raw_min + (v % span))
    return from_raw(np.array(flat, dtype=object).reshape(shape), fmt)
