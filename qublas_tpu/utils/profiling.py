"""Tracing / profiling helpers (SURVEY.md §5: the reference has none; the
device build gets jax.profiler traces and a roofline checker).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

__all__ = ["trace", "roofline_report", "timeit_chained", "device_busy",
           "parse_trace_events"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard/Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit_chained(fn: Callable, a, b, iters: int = 64) -> float:
    """Wall time per call with a data dependency chaining iterations (the
    output feeds the next call's LHS) and ``block_until_ready`` on the
    last output."""
    import jax

    jax.block_until_ready(fn(a, b))
    t0 = time.perf_counter()
    x = a
    for _ in range(iters):
        x = fn(x, b)
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / iters


def device_busy(run: Callable[[], None], logdir: Optional[str] = None):
    """Device-side timing of ``run()`` (which must block on its result)
    from a jax.profiler trace: the GPU's own kernel rows, free of host
    dispatch and Python overhead.  Returns :func:`parse_trace_events`'s
    dict.  Raises ``RuntimeError`` when the trace holds no GPU kernel rows
    (no GPU, or the profiler recorded nothing).  The newest session under
    ``logdir`` is read; a temporary directory is used and removed when
    ``logdir`` is None.
    """
    import glob
    import gzip
    import json
    import os
    import shutil
    import tempfile

    owned = logdir is None
    if owned:
        logdir = tempfile.mkdtemp(prefix="qublas_prof_")
    try:
        with trace(logdir):
            run()
        sessions = sorted(glob.glob(os.path.join(
            logdir, "plugins", "profile", "*")))
        files = glob.glob(os.path.join(sessions[-1], "*.trace.json.gz")) \
            if sessions else []
        if not files:
            raise RuntimeError(f"jax.profiler wrote no trace under {logdir}")
        with gzip.open(files[0]) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        if owned:
            shutil.rmtree(logdir, ignore_errors=True)
    parsed = parse_trace_events(events)
    if parsed is None:
        raise RuntimeError("the trace holds no GPU kernel rows")
    return parsed


def parse_trace_events(ev):
    """Pure parser behind :func:`device_busy`: trace-viewer events -> the
    GPU's kernel rows, or None when the trace has none (e.g. a CPU run).

    A GPU trace has one process per device (``/device:GPU:<n>``) whose
    threads are CUDA streams (``Stream #13(Compute)``, memcpy streams); each
    complete event on them is one kernel or copy, carrying its HLO module
    and op in ``args``.  Returns a dict:

    * ``busy_s``   — sum of all device row durations
    * ``span_s``   — first row start to last row end (includes gaps)
    * ``module_s`` — device-busy seconds of the busiest HLO module (a trace
      of one program execution gives that execution's device time)
    * ``ops``      — {row name: total seconds} (Pallas kernels appear under
      their kernel name, XLA fusions under the fusion's name)
    * ``modules``  — {hlo_module: total seconds}
    """
    dev_pids = {e["pid"] for e in ev
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and e.get("args", {}).get("name", "")
                .startswith("/device:GPU:")}
    rows = [e for e in ev if e.get("ph") == "X" and e.get("pid") in dev_pids]
    if not rows:
        return None
    ops: dict = {}
    modules: dict = {}
    for e in rows:
        dur = e.get("dur", 0.0) / 1e6
        ops[e["name"]] = ops.get(e["name"], 0.0) + dur
        mod = e.get("args", {}).get("hlo_module", "")
        modules[mod] = modules.get(mod, 0.0) + dur
    ts0 = min(e["ts"] for e in rows)
    ts1 = max(e["ts"] + e.get("dur", 0.0) for e in rows)
    return {
        "busy_s": sum(e.get("dur", 0.0) for e in rows) / 1e6,
        "span_s": (ts1 - ts0) / 1e6,
        "module_s": max(modules.values()),
        "ops": ops,
        "modules": modules,
    }


def roofline_report(fn: Callable, a, b, flops: float,
                    baseline_fn: Optional[Callable] = None,
                    iters: int = 64, ab_rounds: int = 2) -> dict:
    """Measured throughput of ``fn`` and fraction of a measured baseline
    ceiling (e.g. the raw integer matmul for a quantized GEMM).

    The two sides are measured in interleaved A/B rounds with best-of per
    side, so drift in the device's clock or power state lands on both
    sides rather than in ``fraction_of_roofline``."""
    t = timeit_chained(fn, a, b, iters)
    tb = None
    if baseline_fn is not None:
        tb = timeit_chained(baseline_fn, a, b, iters)
        for _ in range(max(ab_rounds - 1, 0)):
            t = min(t, timeit_chained(fn, a, b, iters))
            tb = min(tb, timeit_chained(baseline_fn, a, b, iters))
    rep = {"seconds_per_call": t, "gops": flops / t / 1e9}
    if tb is not None:
        rep["baseline_gops"] = flops / tb / 1e9
        rep["fraction_of_roofline"] = tb / t
    return rep
