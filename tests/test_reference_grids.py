"""Replay the reference's own generated test grids (test/ArbiInt/*).

The reference commits 59.6k LoC of generated GoogleTest cases: each
``TEST(staticShiftLeft, N_s)`` draws one ``ArbiInt<N>::fill()`` from the
global seed-1 stream and positionally checks the shifted binary string
against the raw one (staticShiftLeft.cpp:10-30, staticShiftRight.cpp:10-26).
Tests run in registration (file) order sharing the stream, so with
``refrand`` replicating mt19937(1) + the libstdc++ distribution draws
bit-for-bit we can replay the *exact same vectors* the reference tests —
all 2,500 + 1,225 cases — against our shift semantics and the compiled
multiword engine.

Skipped when /root/reference is not mounted (the parse reads its files).
"""

import pathlib
import re

import numpy as np
import pytest

from qublas_tpu import native, refrand

REF = pathlib.Path("/root/reference/test/ArbiInt")

pytestmark = pytest.mark.skipif(not REF.exists(),
                                reason="reference checkout not mounted")


def _cases(fname: str, kind: str):
    text = (REF / fname).read_text()
    return [(int(a), int(b)) for a, b in
            re.findall(rf"TEST\({kind}, (\d+)_(\d+)\)", text)]


def to_bits(v: int, width: int) -> str:
    return format(v & ((1 << width) - 1), f"0{width}b")


# stream checkpoints from the compiled reference (grid_probe over the
# exact TEST order of staticShiftLeft.cpp): draw index -> value
LEFT_CHECKPOINTS = {
    0: -2,
    100: -1969,
    1000: 7950256076883966881841578,
    2499: -169683389135561348065267242501085827457015751465237226517445,
}


def test_replay_static_shift_left_grid():
    cases = _cases("staticShiftLeft.cpp", "staticShiftLeft")
    assert len(cases) == 2500
    gen = refrand.MT19937(1)  # fresh binary: fresh global stream
    native_ok = native.available()
    for idx, (n, shift) in enumerate(cases):
        v = refrand.fill_raw(gen, n)
        if idx in LEFT_CHECKPOINTS:
            # pins the replayed stream to the compiled reference's draws
            assert v == LEFT_CHECKPOINTS[idx], (idx, n, v)
        shifted = v << shift
        raw_s = to_bits(v, n)
        out_s = to_bits(shifted, n + shift)
        # reference checker (staticShiftLeft.cpp:10-30): low `shift` bits
        # zero, next n bits equal raw's low n bits
        assert out_s[len(out_s) - shift:] == "0" * shift, (n, shift)
        assert out_s[len(out_s) - shift - n: len(out_s) - shift] == raw_s, \
            (n, shift)
        if native_ok and n > 64:
            got = native.shift_wide(np.array([v], dtype=object), shift)
            if got is not None:
                assert int(got[0]) == shifted, (n, shift)


def test_replay_static_shift_right_grid():
    cases = _cases("staticShiftRight.cpp", "staticShiftRight")
    assert len(cases) == 1225
    gen = refrand.MT19937(1)
    native_ok = native.available()
    for n, shift in cases:
        v = refrand.fill_raw(gen, n)
        shifted = v >> shift  # arithmetic, like staticShiftRight
        raw_s = to_bits(v, n)
        keep = n - shift
        out_s = to_bits(shifted, max(keep, 1))
        # reference checker (staticShiftRight.cpp:10-26): low (n - shift)
        # bits of shifted equal raw bits starting `shift` from the right
        for i in range(keep):
            assert out_s[len(out_s) - 1 - i] == \
                raw_s[len(raw_s) - 1 - i - shift], (n, shift, i)
        if native_ok and n > 64:
            got = native.shift_wide(np.array([v], dtype=object), -shift)
            if got is not None:
                assert int(got[0]) == shifted, (n, shift)


def _wide_grid_values(fname: str, kind: str):
    """Replay the stream and collect the >64-bit cases: (n, shift, value)."""
    cases = _cases(fname, kind)
    gen = refrand.MT19937(1)
    out = []
    for n, shift in cases:
        v = refrand.fill_raw(gen, n)
        if n > 64:
            out.append((n, shift, v))
    return out


def test_replay_shift_grids_device_limbs():
    """The same reference-generated vectors, pushed through the DEVICE
    N-limb shift primitives (ops/limbint.py lshl/lshr) in batched jnp
    calls — the reference's structural shift grid running on device lanes."""
    from collections import defaultdict

    from qublas_tpu.ops import limbint as L

    groups = defaultdict(list)  # (K, shift, 'l'|'r') -> [(v, want)]
    for n, shift, v in _wide_grid_values("staticShiftLeft.cpp",
                                         "staticShiftLeft"):
        K = L.bits_to_limbs(n + shift + 1)
        if 32 * K <= 1024:
            groups[(K, shift, "l")].append((v, v << shift))
    for n, shift, v in _wide_grid_values("staticShiftRight.cpp",
                                         "staticShiftRight"):
        K = L.bits_to_limbs(n + 1)
        groups[(K, shift, "r")].append((v, v >> shift))
    assert groups, "no wide cases parsed"
    total = 0
    for (K, shift, side), pairs in groups.items():
        vals = np.array([p[0] for p in pairs], dtype=object)
        limbs = L.limbs_from_ints(vals, K)
        res = L.lshl(limbs, shift) if side == "l" else L.lshr(limbs, shift)
        got = [int(x) for x in L.ints_from_limbs(res)]
        want = [p[1] for p in pairs]
        assert got == want, (K, shift, side)
        total += len(pairs)
    # every reference wide case (n in 65..200) must have been replayed
    assert total > 2000, total
