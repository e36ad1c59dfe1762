"""Device-trace timing: the trace-viewer parser behind
``utils.profiling.device_busy``, pinned against a small trace recorded on an
NVIDIA H100 (``tests/data/gpu_trace.json.gz``: two runs each of an int8
``qgemul`` at 512² and the canonical tree GEMM at 64³, the latter on the
``tree_gemm_tiled`` Pallas kernel).  On the GPU the device rows are CUDA
kernels on the ``/device:GPU:<n>`` process's stream threads.
"""

import gzip
import json
import os

import pytest

from qublas_tpu.utils.profiling import device_busy, parse_trace_events

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "gpu_trace.json.gz")


def _fixture():
    with gzip.open(FIXTURE) as fh:
        return json.load(fh)["traceEvents"]


def _device_rows(ev):
    pids = {e["pid"] for e in ev if e.get("name") == "process_name"
            and e["args"]["name"].startswith("/device:GPU:")}
    return [e for e in ev if e.get("ph") == "X" and e["pid"] in pids]


def _meta(pid, name, tid=None, kind="process_name"):
    e = {"ph": "M", "pid": pid, "name": kind, "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _ev(pid, tid, name, ts, dur, module="jit_f"):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "dur": dur, "args": {"hlo_module": module}}


def test_parse_device_rows():
    ev = _fixture()
    rows = _device_rows(ev)
    assert len(rows) == 8
    p = parse_trace_events(ev)
    assert p is not None
    assert abs(p["busy_s"] - sum(e["dur"] for e in rows) / 1e6) < 1e-12
    t0 = min(e["ts"] for e in rows)
    t1 = max(e["ts"] + e["dur"] for e in rows)
    assert abs(p["span_s"] - (t1 - t0) / 1e6) < 1e-12
    # the Pallas kernel appears under its kernel name, twice
    assert abs(p["ops"]["tree_gemm_tiled"] - (18.176 + 18.144) / 1e6) < 1e-12
    assert "gemm_fusion_dot_general_1" in p["ops"]
    # host rows (python, PJRT) are excluded entirely
    assert not any(k.startswith(("PjitFunction", "$", "PJRT"))
                   for k in p["ops"])


def test_parse_no_device_rows_returns_none():
    # CPU-only trace: no GPU process -> None
    ev = [
        _meta(701, "/host:CPU"),
        _meta(701, "python", tid=9, kind="thread_name"),
        _ev(701, 9, "PjitFunction(f)", 0.0, 100.0),
    ]
    assert parse_trace_events(ev) is None
    assert parse_trace_events([]) is None
    # the fixture's host rows alone are not device rows
    host_only = [e for e in _fixture() if e.get("pid") != 1]
    assert parse_trace_events(host_only) is None


def test_parse_module_is_busiest_hlo_module():
    """Two streams, two modules: module_s is the busiest module's kernel
    time, summed across streams; memcpy rows count as device rows."""
    ev = [
        _meta(1, "/device:GPU:0"),
        _meta(1, "Stream #13(Compute)", tid=13, kind="thread_name"),
        _meta(1, "Stream #14(MemcpyD2H)", tid=14, kind="thread_name"),
        _ev(1, 13, "fusion.1", 10.0, 50.0, "jit_big"),
        _ev(1, 13, "fusion.2", 70.0, 30.0, "jit_big"),
        _ev(1, 14, "MemcpyD2H", 100.0, 5.0, "jit_big"),
        _ev(1, 13, "fusion.9", 200.0, 60.0, "jit_small"),
    ]
    p = parse_trace_events(ev)
    assert abs(p["module_s"] - 85.0 / 1e6) < 1e-12
    assert abs(p["modules"]["jit_small"] - 60.0 / 1e6) < 1e-12
    assert abs(p["busy_s"] - 145.0 / 1e6) < 1e-12
    assert abs(p["span_s"] - 250.0 / 1e6) < 1e-12


def test_parse_all_gpus():
    ev = [_meta(1, "/device:GPU:0"), _meta(2, "/device:GPU:1"),
          _ev(1, 13, "k", 0.0, 10.0), _ev(2, 13, "k", 0.0, 20.0)]
    p = parse_trace_events(ev)
    assert abs(p["ops"]["k"] - 30.0 / 1e6) < 1e-12


def test_device_busy_raises_without_gpu_rows(tmp_path):
    """No GPU kernel rows is an error, not a silent fallback."""
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform == "gpu":
        pytest.skip("the backend has a GPU")
    x = jnp.ones((8, 8))
    with pytest.raises(RuntimeError, match="no GPU kernel rows"):
        device_busy(lambda: jax.block_until_ready(x @ x),
                    logdir=str(tmp_path))


def test_bench_device_op_time_prefers_module(monkeypatch):
    """bench._device_op_time returns the busiest module's device time."""
    import importlib.util
    import sys

    if "bench" in sys.modules:
        bench = sys.modules["bench"]
    else:
        spec = importlib.util.spec_from_file_location(
            "bench", __file__.rsplit("/tests/", 1)[0] + "/bench.py")
        bench = importlib.util.module_from_spec(spec)
        sys.modules["bench"] = bench
        spec.loader.exec_module(bench)

    import qublas_tpu.utils.profiling as prof

    calls = {}

    def fake_device_busy(run):
        run()
        calls["ran"] = True
        return parse_trace_events(_fixture())

    monkeypatch.setattr(prof, "device_busy", fake_device_busy)
    t = bench._device_op_time(lambda a, b: __import__("numpy")
                              .zeros((16, 256)), None, None)
    assert calls.get("ran")
    want = sum(e["dur"] for e in _device_rows(_fixture())) / 1e6
    assert abs(t - want) < 1e-12
