#!/usr/bin/env python3
"""Worked example: simulating a fixed-point ASIC datapath on an accelerator.

The QuBLAS workflow — pick formats, run the quantized datapath bit-exactly,
inspect where precision is lost, export golden vectors for RTL comparison —
end to end on qublas_tpu.  Runs on CPU or GPU (same bits either way).

    python examples/asic_datapath_sim.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import qublas_tpu as q
from qublas_tpu import OverflowMode, RoundMode, qformat


def main():
    rng = np.random.RandomState(1)

    # 1. Datapath formats: 8-bit activations/weights, a 20-bit accumulator,
    #    convergent rounding back to 8 bits with overflow-to-zero (a common
    #    ASIC "flag overflow loudly" choice).
    act = qformat(3, 4)                      # Q3.4, int8 storage
    wgt = qformat(1, 6)                      # Q1.6, int8 storage
    acc = qformat(12, 8)                     # wide accumulate
    out = qformat(3, 4, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_ZERO)

    # 2. Inputs: exact double -> fixed conversion (bit-identical to the
    #    reference's 2400-bit constructor path).
    x = q.from_float(rng.randn(64, 128) * 0.8, act)
    w = q.from_float(rng.randn(128, 64) * 0.4, wgt)

    # 3. The quantized GEMM: per-product quantization to `acc`, tree
    #    accumulation at `acc`, converting assignment into `out`.  The
    #    exactness proof routes this to one integer matmul with a fused
    #    shift-round-saturate epilogue.
    y = q.qgemul(x, w, out, mul_to=acc, add_formats=(acc,))
    print("GEMM out:", y)

    # 4. Where is precision going?  Saturation/rounding diagnostics the
    #    C++ simulator cannot produce at speed.
    stats = q.requant_stats(x, qformat(1, 4))
    print(f"requant act->Q1.4: {int(stats.saturated)}/{int(stats.total)} "
          f"saturate, {int(stats.rounded)} round")
    print("range report:", q.format_range_report(y))

    # 5. A LUT nonlinearity (ASIC ROM) fused into the epilogue.
    table = q.build_table(q.sqrt_func, out, out)
    y_act = q.qgemul(x, w, out, mul_to=acc, add_formats=(acc,),
                     epilogue_lut=table)
    print("with fused sqrt ROM:", y_act)

    # 6. Golden vectors for RTL comparison: the BitStream wire format.
    record = q.dumps_bits(y[:2, :4])
    print("BitStream record:", record.splitlines()[0],
          record.splitlines()[1][:48] + "...")
    back = q.loads_bits(record)
    assert (np.asarray(back.raw()) == np.asarray(y[:2, :4].raw())).all()

    # 7. Checkpoint the whole state.
    q.save("/tmp/datapath_ckpt.npz", {"x": x, "w": w, "y": y})
    restored = q.load("/tmp/datapath_ckpt.npz")
    assert (np.asarray(restored["y"].raw()) == np.asarray(y.raw())).all()
    print("checkpoint round-trip OK")

    # 8. Scale out: the same GEMM sharded over every available chip.
    import jax

    if len(jax.devices()) > 1:
        mesh = q.make_mesh(dp=1)
        ys = q.shard_qgemul(x, w, out, mesh, mul_to=acc, add_formats=(acc,))
        assert (np.asarray(ys.raw()) == np.asarray(y.raw())).all()
        print(f"sharded over {len(jax.devices())} devices: bit-identical")


if __name__ == "__main__":
    main()
