"""qublas_tpu — a fixed-point quantized linear-algebra engine on JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference QuBLAS C++ simulator (bit-exact fixed-point arithmetic for
ASIC/FPGA behavioral modeling), extended with what the reference lacks:
batched tensor ops, integer-matmul GEMM paths, LUT kernels, and multi-device /
multi-host sharding over a `jax.sharding.Mesh`.
"""

from .qformat import (
    FULL_PREC,
    FullPrec,
    OverflowMode,
    QFormat,
    RoundMode,
    add_merge,
    mul_merge,
    qformat,
)

__version__ = "0.1.0"

__all__ = [
    "FULL_PREC",
    "FullPrec",
    "OverflowMode",
    "QFormat",
    "RoundMode",
    "add_merge",
    "mul_merge",
    "qformat",
]


_LAZY = {
    # tensors
    "QTensor": "qtensor", "from_float": "qtensor", "from_raw": "qtensor",
    "zeros": "qtensor", "random_fill": "qtensor", "scalar": "qtensor",
    "from_double": "qtensor",
    # reference-identical fill()/shuffle() streams (mt19937 seed 1)
    "reference_fill": "refrand", "reference_shuffle": "refrand",
    # elementwise ops
    "qmul": "ops.elementwise", "qadd": "ops.elementwise",
    "qsub": "ops.elementwise", "qdiv": "ops.elementwise",
    "qabs": "ops.elementwise", "qneg": "ops.elementwise",
    "qcmp": "ops.elementwise", "qeq": "ops.elementwise",
    "qcast": "ops.elementwise",
    # reductions / GEMM
    "qreduce": "ops.reduce", "qgemul": "ops.gemm", "qgemv": "ops.gemm",
    "cgemul": "ops.cgemm", "cgemv": "ops.cgemm",
    # complex
    "QComplexTensor": "complex", "complex_from_parts": "complex",
    "complex_from_float": "complex", "complex_from_raw": "complex",
    "complex_zeros": "complex", "cmul": "complex", "cmul_tf": "complex",
    "cadd": "complex", "csub": "complex", "cneg": "complex", "ceq": "complex",
    # serialization
    "to_bits": "bitstream", "from_bits": "bitstream", "l2r": "bitstream",
    "r2l": "bitstream",
    # nonlinear
    "qpoly": "anus", "qapprox": "anus", "Segment": "anus",
    "qtable": "anus", "QTable": "anus", "build_table": "anus",
    "rsqrt_func": "anus", "reciprocal_func": "anus", "sqrt_func": "anus",
    # diagnostics / persistence
    "requant_stats": "diagnostics", "format_range_report": "diagnostics",
    "save": "checkpoint", "load": "checkpoint",
    "dumps_bits": "checkpoint", "loads_bits": "checkpoint",
    # parallelism
    "make_mesh": "parallel", "shard_qgemul": "parallel",
    "init_distributed": "parallel",
}


def __getattr__(name):
    # Lazy imports keep `import qublas_tpu` light (no jax import cost for
    # host-only users such as the golden-model oracle tooling).
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib

        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
