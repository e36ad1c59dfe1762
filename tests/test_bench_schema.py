"""Headline bench record schema.

Every record carries the device it was measured on (``platform``,
``device_kind``, ``device_count``); a device-trace measurement becomes the
primary value with the host-clock numbers kept beside it.  Without a GPU the
bench refuses to run and writes nothing.
"""

import importlib.util
import json
import os
import sys

import pytest


def _load_bench():
    # import bench.py as a module without running main()
    if "bench" in sys.modules:
        return sys.modules["bench"]
    spec = importlib.util.spec_from_file_location(
        "bench", __file__.rsplit("/tests/", 1)[0] + "/bench.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bench"] = mod
    spec.loader.exec_module(mod)
    return mod


class _Dev:
    def __init__(self, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
        self.platform, self.device_kind = platform, kind


STAMP = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
         "device_count": 1}


def test_device_stamp_reads_the_devices():
    bench = _load_bench()
    assert bench.device_stamp([_Dev()] * 4) == dict(STAMP, device_count=4)


def test_device_stamp_defaults_to_jax_devices():
    import jax

    bench = _load_bench()
    st = bench.device_stamp()
    assert st == {"platform": jax.devices()[0].platform,
                  "device_kind": jax.devices()[0].device_kind,
                  "device_count": len(jax.devices())}


def test_headline_record_carries_the_stamp():
    bench = _load_bench()
    rec = bench.headline_record(200000.0, 205000.0, 3, STAMP)
    parsed = json.loads(json.dumps(rec))
    for key, val in STAMP.items():
        assert parsed[key] == val
    assert parsed["metric"] == "int8_qgemul_gops"
    assert parsed["unit"] == "GOP/s"
    assert parsed["vs_baseline"] == round(200000.0 / 205000.0, 4)
    assert parsed["roofline_gops"] == 205000.0
    assert parsed["ab_pairs"] == 3
    assert parsed["timing"] == "wall"
    assert "wall_gops" not in parsed


def test_headline_record_prefers_device_trace():
    """A device-trace measurement becomes value/vs_baseline; the host-clock
    numbers move to wall_* fields."""
    bench = _load_bench()
    rec = bench.headline_record(
        200000.0, 205000.0, 3, STAMP,
        device={"gops": 380000.0, "roofline_gops": 384000.0, "ab_pairs": 2})
    parsed = json.loads(json.dumps(rec))
    assert parsed["timing"] == "device-trace"
    assert parsed["value"] == 380000.0
    assert parsed["roofline_gops"] == 384000.0
    assert parsed["vs_baseline"] == round(380000.0 / 384000.0, 4)
    assert parsed["wall_gops"] == 200000.0
    assert parsed["wall_vs_baseline"] == round(200000.0 / 205000.0, 4)
    assert parsed["device_ab_pairs"] == 2
    assert parsed["platform"] == "gpu"


@pytest.mark.parametrize("argv", [[], ["--tree"], ["--all"]])
def test_bench_refuses_without_gpu(argv, monkeypatch):
    """No CPU fallback: on a non-GPU backend every mode exits non-zero with
    a message, before any measurement."""
    bench = _load_bench()
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    ran = []
    monkeypatch.setitem(bench.EXTRA, "tree", lambda: ran.append("tree"))
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert "needs an NVIDIA GPU" in str(exc.value.code)
    assert not ran


def test_run_all_prints_one_stamped_document(capsys, monkeypatch, tmp_path):
    """--all prints every row and one stamped JSON document, records a
    failing row's error, and writes no file."""
    bench = _load_bench()

    def broken():
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "EXTRA", {
        "ok": lambda: {"metric": "ok", "value": 1.0},
        "bad": broken})
    monkeypatch.chdir(tmp_path)
    assert bench.run_all() == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    doc = json.loads(last)
    assert doc["schema"] == 2
    assert doc["rows"]["ok"] == {"metric": "ok", "value": 1.0}
    assert doc["rows"]["bad"] == {"error": "RuntimeError: boom"}
    assert {"platform", "device_kind", "device_count"} <= set(doc)
    assert os.listdir(tmp_path) == []
