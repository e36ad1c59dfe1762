"""Device op implementations.

Import from the package root (``qublas_tpu.qmul`` etc.) or from the
submodules directly: :mod:`.elementwise`, :mod:`.reduce`, :mod:`.gemm`,
:mod:`.cgemm`, :mod:`.tree_gemm`, with the width-proof
machinery in :mod:`.widths` and the 64-bit lane emulation in
:mod:`.wideint`.
"""
