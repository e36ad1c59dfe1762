# Developer entry points (parity with the reference's CMake harness,
# SURVEY.md §2.18: build + auto-discovered tests + sanitized builds).

PY ?= python

.PHONY: test test-full golden golden-asan native bench clean \
        device-differential smoke fuzz-smoke fuzz-full

# Default (shallow fuzz depth, 4 workers): ~4-5 min on a 4-CPU box.
test:
	$(PY) -m pytest tests/ -q -n 4

# Full randomized sweeps (pre-commit / CI depth; shallow is a seed-prefix
# of full, so repros only need the env var).
test-full:
	QUBLAS_TEST_DEPTH=full $(PY) -m pytest tests/ -q -n 4

# Regenerate golden vectors from the compiled C++ reference (needs g++ and
# /root/reference; override with QUBLAS_REF=<path>).
golden:
	$(PY) tools/gen_golden.py

# Same, with the oracle compiled under ASan+UBSan (the reference's own
# builds always carry sanitizers, CMakeLists.txt:17,26).  Slow.
golden-asan:
	QUBLAS_GOLDEN_SAN=1 $(PY) tools/gen_golden.py

# Native host engine (also built automatically on first import).
native:
	g++ -O2 -shared -fPIC -o native/libqublas_host.so native/qublas_host.cpp

bench:
	$(PY) bench.py

# --- device checks -------------------------------------------------------
# Both need an NVIDIA GPU (no JAX_PLATFORMS override): the CPU suite cannot
# see a backend miscompile.

# Differential sweep on the device (eager+jit vs oracle, every dispatch
# route; ~40 compiles).  Exit 1 on any mismatch.
device-differential:
	$(PY) tools/device_differential.py

# One-card smoke of the main path at full size (includes the differential).
smoke:
	$(PY) chip_smoke.py

# Quick randomized differential sweep (~200 trials/family, minutes) on the
# virtual 8-device mesh — the smoke gate after touching widths proofs,
# requantize code, or GEMM dispatch.
fuzz-smoke:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	  $(PY) tools/deep_fuzz.py 200

# The heavy sweep (N=4000, ~15 min).
fuzz-full:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	  $(PY) tools/deep_fuzz.py 4000

clean:
	rm -f native/libqublas_host.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
