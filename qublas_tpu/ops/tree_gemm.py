"""Streaming binary-carry evaluation of the order-sensitive quantized GEMM.

The general Qgemul config (per-product requantization + per-layer quantized
tree accumulation, e.g. the canonical ``Qu<8,8,TRN::TCPL,SAT::ZERO>`` GEMM)
cannot use an integer matmul: every product must be individually requantized
before it is summed, and every tree layer requantizes again, so the
computation is an elementwise integer program.  The naive implementation materializes the
``[m, k, n]`` product tensor and reduces it layer by layer — O(log k) device-memory
round trips of O(mkn) data.

This module evaluates the *exact same tree* as a single left-to-right stream
over k using the classic binary-counter trick: keep one partial sum per tree
level ("slots"); pushing product t merges it into slot 0, 1, … for each
trailing one-bit of t, each merge being the reference's layer-l ``Qadd``
requantized to that layer's format.  Because every merge combines two
*adjacent complete subtrees* of equal span, the sequence of adds is exactly
the balanced-tree pairing of the reference's vector-path reducer
(QuBLAS.h:4960-4990), and the final drain reproduces the ragged right edge —
including the odd-tail converting assignments (QuBLAS.h:4977-4980) — for any
k, verified element-for-element against the host golden model.

Backends sharing the schedule:

* :func:`tree_gemm_tiled` — the GPU path: one Pallas kernel on the Triton
  route; each program owns an output tile and keeps its slot stack in
  registers while it walks k, so products and partial sums never touch
  device memory.  ``qgemul`` takes it when the default backend is the GPU.
* :func:`tree_gemm_scan` — ``lax.scan`` over k-blocks with a binary-carry
  slot stack.  Portable (CPU / any shape), no [m,k,n] intermediate.

Products route through ``widths.route_mul``: "i32", "split" (the split-B
int32 trick for >32-bit products whose requantization drops bits), or the
64-bit "pair" emulation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..qformat import QFormat, add_merge
from . import wideint as W
from .reduce import layer_format
from .widths import (
    Interval,
    dtype_for,
    fmt_interval,
    requant_out_interval,
    route_mul,
    route_requant,
)

__all__ = ["plan_tree", "TreePlan", "tree_gemm_scan", "tree_gemm_tiled",
           "tile_shape", "level_formats", "drain_ops"]


@dataclass(frozen=True)
class TreePlan:
    """Static schedule for the streaming tree evaluation."""

    k: int
    prod_route: str          # "i32" | "split" | "pair"
    prod_frac: int
    mul_fmt: QFormat
    levels: int              # number of slot levels (floor(log2(k)) + 1)
    level_fmts: Tuple[QFormat, ...]   # format of a value at each level
    merge_fmts: Tuple[QFormat, ...]   # layer-l format (merge level l -> l+1)
    drain: Tuple[Tuple[str, int], ...]  # ("seed"|"convert"|"add", level)
    final_fmt: QFormat


def level_formats(value_fmt: QFormat, add_formats, k: int):
    """Per-level (value_fmt list, merge_fmt list) of the reducer tree —
    pure structure, no lane-route restrictions."""
    levels = max(k.bit_length(), 1)
    level_fmts = [value_fmt]
    merge_fmts = []
    for l in range(levels):
        lf = layer_format(add_formats, l)
        if lf is None:
            lf = add_merge(level_fmts[l], level_fmts[l])
        merge_fmts.append(lf)
        level_fmts.append(lf)
    return level_fmts, merge_fmts


def drain_ops(k: int, levels: int):
    """Drain schedule (binary-carry ragged edge) — ("seed"|"convert"|"add",
    level) ops, independent of formats."""
    drain = []
    carry_active = False
    occupied = [bool(k & (1 << l)) for l in range(levels)]
    for l in range(levels):
        remaining_above = any(occupied[l + 1:])
        if occupied[l] and carry_active:
            drain.append(("add", l))
        elif occupied[l] or carry_active:
            if occupied[l]:
                drain.append(("seed", l))
            if remaining_above:
                drain.append(("convert", l))
            carry_active = True
        if not remaining_above and carry_active:
            break
    return drain


def plan_tree(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
              k: int, out_fmt: QFormat) -> Optional[TreePlan]:
    """Build the schedule and prove every step fits int32 lanes (products may
    use the 64-bit pair path).  Returns None when any step would need the
    host path."""
    if k < 1:
        return None
    prod_route, prod_iv, prod_frac = route_mul(fa, fb, mul_fmt)
    if prod_route == "host":
        return None

    def union(a: Interval, b: Interval) -> Interval:
        return Interval(min(a.lo, b.lo), max(a.hi, b.hi))

    levels = max(k.bit_length(), 1)
    level_fmts = [mul_fmt]
    merge_fmts = []
    # track the actual value interval at each level (post-saturation), so the
    # route proofs are tight rather than assuming full storage ranges
    iv, _ = requant_out_interval(prod_iv, prod_frac, mul_fmt)
    level_ivs = [iv]
    for l in range(levels):
        cur = level_fmts[l]
        lf = layer_format(add_formats, l)
        if lf is None:
            lf = add_merge(cur, cur)
        merge_fmts.append(lf)
        level_fmts.append(lf)
        s = level_ivs[l] + level_ivs[l]
        if not s.fits32:
            return None
        if route_requant(s, cur.frac_bits, lf) != "i32":
            return None
        if route_requant(level_ivs[l], cur.frac_bits, lf) != "i32":
            return None  # tail converting assignment at this layer
        pair_iv, _ = requant_out_interval(s, cur.frac_bits, lf)
        tail_iv, _ = requant_out_interval(level_ivs[l], cur.frac_bits, lf)
        level_ivs.append(union(pair_iv, tail_iv))

    # drain schedule: the binary-carry ragged edge comes from drain_ops
    # (single source of truth — tree_gemm_scan/_tiled and the streaming
    # wide GEMM all execute this schedule); the route proofs layer over
    # the returned ops.  Invariant: a carry entering layer l always has
    # format level_fmts[l].
    drain = drain_ops(k, levels)
    carry_iv = None
    cur_fmt = level_fmts[0]
    for op, l in drain:
        if op == "seed":
            cur_fmt = level_fmts[l]
            carry_iv = level_ivs[l]
        elif op == "convert":
            if route_requant(carry_iv, cur_fmt.frac_bits,
                             merge_fmts[l]) != "i32":
                return None
            carry_iv, _ = requant_out_interval(carry_iv, cur_fmt.frac_bits,
                                               merge_fmts[l])
            cur_fmt = merge_fmts[l]
        else:  # add: slot l (format level_fmts[l]) merges with the carry
            s = level_ivs[l] + carry_iv
            if not s.fits32:
                return None
            if route_requant(s, level_fmts[l].frac_bits,
                             merge_fmts[l]) != "i32":
                return None
            carry_iv, _ = requant_out_interval(s, level_fmts[l].frac_bits,
                                               merge_fmts[l])
            cur_fmt = merge_fmts[l]
    final_fmt = cur_fmt
    if route_requant(carry_iv, final_fmt.frac_bits, out_fmt) != "i32":
        return None
    if dtype_for(out_fmt) is None:
        return None
    return TreePlan(k, prod_route, prod_frac, mul_fmt, levels,
                    tuple(level_fmts), tuple(merge_fmts), tuple(drain),
                    final_fmt)


def _merge_count(t: int, levels: int):
    """Number of trailing one-bits of t (number of merges when pushing
    product t), as a traced int32 computation.  Integer arithmetic only
    (no boolean not), so it also lowers inside a Triton kernel."""
    import jax.numpy as jnp

    cnt = jnp.int32(0)
    run = jnp.int32(1)          # 1 while every lower bit has been one
    for l in range(levels):
        run = run * ((t >> l) & 1)
        cnt = cnt + run
    return cnt


def _product(plan: TreePlan, col, row):
    """Requantized outer product (one level-0 value)."""
    if plan.prod_route == "i32":
        return W.requantize_i32(col * row, plan.prod_frac, plan.mul_fmt)
    if plan.prod_route == "split":
        return W.requantize_split_mul(col, row, plan.prod_frac, plan.mul_fmt)
    return W.requantize_pair(W.mul32_wide(col, row), plan.prod_frac,
                             plan.mul_fmt)


def _merge(plan: TreePlan, l: int, left, right):
    """Layer-l Qadd: align (same format, no shift), add, requantize."""
    lf = plan.merge_fmts[l]
    cur = plan.level_fmts[l]
    return W.requantize_i32(left + right, cur.frac_bits, lf)


def _drain(plan: TreePlan, read_slot):
    """Run the drain schedule; ``read_slot(l)`` yields slot l's array."""
    carry = None
    for op, l in plan.drain:
        if op == "seed":
            carry = read_slot(l)
        elif op == "convert":
            cur = plan.level_fmts[l]
            carry = W.requantize_i32(carry, cur.frac_bits, plan.merge_fmts[l])
        else:  # add: slot l is the earlier (left) operand
            carry = _merge(plan, l, read_slot(l), carry)
    return carry


# ---------------------------------------------------------------------------
# lax.scan backend
# ---------------------------------------------------------------------------

def _block_size(k: int) -> int:
    """Products per scan step: the largest power of two dividing k, capped.
    The in-step tree handles the low ``log2(blk)`` levels vectorized; the
    carry stack handles levels above."""
    blk = k & (-k)  # largest power-of-two divisor
    return min(blk, 16)


def tree_gemm_scan(a_data, b_data, plan: TreePlan, out_fmt: QFormat):
    """[..., m, k] @ [..., k, n] via a scan over k-blocks.

    Each step computes ``blk`` quantized outer products, folds them with the
    first ``log2(blk)`` tree layers vectorized in-step (shape
    ``[..., blk/2^l, m, n]``), then pushes the block result into the
    binary-carry slot stack; ``lax.switch`` over the trailing-ones count runs
    exactly the merges this step needs.  Slot ``l`` is live iff bit ``l`` of
    the running block count is set, so no mask array is needed.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    a32 = a_data.astype(jnp.int32)
    b32 = b_data.astype(jnp.int32)
    batch = jnp.broadcast_shapes(a32.shape[:-2], b32.shape[:-2])
    m, k = a32.shape[-2:]
    _, n = b32.shape[-2:]
    a32 = jnp.broadcast_to(a32, batch + (m, k))
    b32 = jnp.broadcast_to(b32, batch + (k, n))
    out_shape = batch + (m, n)

    blk = _block_size(k)
    inblk_levels = blk.bit_length() - 1          # layers folded in-step
    nblocks = k // blk
    top_levels = max(plan.levels - inblk_levels, 1)

    # [nblocks, blk, ..., m, 1] / [nblocks, blk, ..., 1, n]
    cols = jnp.moveaxis(a32, -1, 0).reshape(
        (nblocks, blk) + batch + (m, 1))
    rows = jnp.moveaxis(b32, -2, 0).reshape(
        (nblocks, blk) + batch + (1, n))

    def block_value(col, row):
        """Fold one block of products through the in-step tree layers."""
        v = _product(plan, col, row)                 # [blk, ..., m, n]
        for l in range(inblk_levels):
            v = _merge(plan, l, v[0::2], v[1::2])
        return v[0]                                  # [..., m, n]

    # derive the initial carry from the operands so it inherits their
    # varying-manual-axes type under shard_map (a plain jnp.zeros carry
    # mismatches the loop output's vma and scan rejects it)
    zero = (cols[0, 0] * rows[0, 0]) * 0             # [..., m, n]
    slots0 = (jnp.zeros((top_levels,) + out_shape, dtype=jnp.int32)
              + zero[None])

    def make_branch(j):
        # j carry-merges (tree levels inblk_levels .. inblk_levels+j-1),
        # then store at slot j — all indices static
        def br(slots, v):
            for l in range(j):
                v = _merge(plan, inblk_levels + l, slots[l], v)
            return slots.at[j].set(v)
        return br

    branches = [make_branch(j) for j in range(top_levels)]

    def step(carry, xs):
        slots, t = carry
        col, row = xs
        v = block_value(col, row)
        cnt = _merge_count(t, top_levels)
        slots = lax.switch(cnt, branches, slots, v)
        return (slots, t + 1), None

    (slots, _), _ = lax.scan(step, (slots0, jnp.int32(0)), (cols, rows))

    def read_slot(l):
        # slot level l (in product units) = carry level l - inblk_levels;
        # levels below inblk_levels never survive (k % blk == 0)
        assert l >= inblk_levels or nblocks == 1
        return slots[max(l - inblk_levels, 0)]

    result = _drain(plan, read_slot)
    raw = W.requantize_i32(result, plan.final_fmt.frac_bits, out_fmt)
    return raw.astype(dtype_for(out_fmt))


# ---------------------------------------------------------------------------
# GPU kernel (Pallas on Triton)
# ---------------------------------------------------------------------------

_TILE = 32       # output tile edge (rows and columns) of one program
_BLK = 16        # products folded per loop step
_NUM_WARPS = 4


def tile_shape(m: int, n: int, tile: int = _TILE):
    """(bm, bn, m_pad, n_pad): power-of-two tile edges no larger than the
    problem needs, and the operand extents padded to whole tiles."""
    bm = min(tile, 1 << max(m - 1, 0).bit_length())
    bn = min(tile, 1 << max(n - 1, 0).bit_length())
    return bm, bn, -(-m // bm) * bm, -(-n // bn) * bn


def tree_gemm_tiled(a_data, b_data, plan: TreePlan, out_fmt: QFormat,
                    tile: int = _TILE, blk: int = _BLK,
                    num_warps: int = _NUM_WARPS, interpret: bool = False):
    """[m, k] @ [k, n] as one Pallas kernel on the Triton route.

    Each program owns one ``[bm, bn]`` output tile and walks k in a loop
    inside the kernel.  A step loads ``blk`` rows of A^T and B, folds the
    block's products through the low ``log2(blk)`` tree layers with a
    static counter, and pushes the block value into the binary-carry slot
    stack, which lives in registers as loop carries; ``lax.switch`` on the
    trailing-ones count runs exactly the merges the step needs.  The
    ``k % blk`` leftover products are pushed one by one after the loop (at
    levels below ``log2(blk)``, so they never carry into the block
    stack), and ``plan.drain`` then folds the ragged right edge, odd tails
    included.  Products and partial sums never leave the chip.

    Output rows and columns are independent, so m and n pad with zeros to
    whole tiles; k is never padded.  ``interpret=True`` runs the kernel in
    the Pallas interpreter (tests only).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    m, k = a_data.shape
    _, n = b_data.shape
    bm, bn, m_pad, n_pad = tile_shape(m, n, tile)
    blk = min(blk, 1 << (k.bit_length() - 1))
    c = blk.bit_length() - 1              # tree levels folded inside a step
    q, r = divmod(k, blk)
    top = max(plan.levels - c, 1)         # block-level slots
    out_dtype = dtype_for(out_fmt)

    at = jnp.pad(a_data.T, ((0, 0), (0, m_pad - m)))
    bp = jnp.pad(b_data, ((0, 0), (0, n_pad - n)))

    def kernel(at_ref, b_ref, out_ref):
        def product(p):
            col = at_ref[p, :].astype(jnp.int32)[:, None]
            row = b_ref[p, :].astype(jnp.int32)[None, :]
            return _product(plan, col, row)

        def push(stack, j, v):
            # static binary counter over product-level tree layers
            l = 0
            while j & (1 << l):
                v = _merge(plan, l, stack.pop(l), v)
                l += 1
            stack[l] = v

        def branch(j):
            def br(slots, v):
                slots = list(slots)
                for l in range(j):
                    v = _merge(plan, c + l, slots[l], v)
                slots[j] = v
                return tuple(slots)
            return br

        branches = [branch(j) for j in range(top)]

        def step(t, slots):
            stack = {}
            for j in range(blk):
                push(stack, j, product(t * blk + j))
            cnt = _merge_count(t, top)
            return lax.switch(cnt, branches, slots, stack[c])

        zero = jnp.zeros((bm, bn), jnp.int32)
        slots = lax.fori_loop(0, q, step, (zero,) * top)
        low = {}
        for j in range(r):
            push(low, j, product(q * blk + j))
        result = _drain(plan, lambda l: low[l] if l < c else slots[l - c])
        raw = W.requantize_i32(result, plan.final_fmt.frac_bits, out_fmt)
        out_ref[...] = raw.astype(out_dtype)

    out = pl.pallas_call(
        kernel,
        grid=(m_pad // bm, n_pad // bn),
        in_specs=[pl.BlockSpec((k, bm), lambda i, j: (0, i)),
                  pl.BlockSpec((k, bn), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        # inside shard_map the output varies over the operands' mesh axes
        out_shape=jax.ShapeDtypeStruct(
            (m_pad, n_pad), out_dtype,
            vma=jax.typeof(at).vma | jax.typeof(bp).vma),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="tree_gemm_tiled",
    )(at, bp)
    return out[:m, :n]


# ---------------------------------------------------------------------------
# Prefix-lossless hybrid: block integer dots + elementwise tree tail
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HybridPlan:
    """Proof artifact for the prefix-lossless hybrid evaluation.

    When the product quantize and the first ``L`` tree layers are provably
    lossless (every step only left-shifts, nothing rounds or saturates),
    the value at level L of each 2^L-product subtree equals the *plain
    integer dot* of that k-block shifted by ``dl`` — so the prefix runs as
    ``nb = k / 2^L`` exact block matmuls, and only the remaining
    (order-sensitive) ⌈log₂ nb⌉ layers run as elementwise requantize
    folds.  A device strategy with no reference counterpart: the
    reference evaluates every layer scalar-by-scalar regardless.
    """

    s: int                     # block size 2^L
    level: int                 # first lossy layer index (= L)
    dl: int                    # left shift from raw-product scale to level L
    level_fmts: Tuple[QFormat, ...]
    merge_fmts: Tuple[QFormat, ...]
    final_fmt: QFormat


def plan_hybrid(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
                k: int, out_fmt: QFormat,
                min_level: int = 3) -> Optional[HybridPlan]:
    """Prove the longest lossless tree prefix and the routes of the lossy
    tail.  Returns None when the prefix is shorter than ``min_level``
    layers (the block dots would not amortize) or any tail step needs a
    non-i32 route."""
    from .gemm import _lossless_requant

    if k < 2:
        return None
    pf = fa.frac_bits + fb.frac_bits
    prod_iv = fmt_interval(fa) * fmt_interval(fb)
    iv = _lossless_requant(prod_iv, pf, mul_fmt)
    if iv is None:
        return None

    level_fmts, merge_fmts = level_formats(mul_fmt, add_formats, k)
    cur_fmt = mul_fmt
    lvl = 0
    ivs = iv
    while (1 << (lvl + 1)) <= k and k % (1 << (lvl + 1)) == 0:
        lf = merge_fmts[lvl]
        nxt = _lossless_requant(ivs + ivs, cur_fmt.frac_bits, lf)
        if nxt is None:
            break
        ivs, cur_fmt = nxt, lf
        lvl += 1
    if lvl < min_level:
        return None
    s = 1 << lvl
    dl = cur_fmt.frac_bits - pf
    # the raw block dot itself and every partial sum must fit int32 (the
    # matmul accumulators), as must the shifted level-L value
    dot_iv = Interval(min(s * prod_iv.lo, prod_iv.lo),
                      max(s * prod_iv.hi, prod_iv.hi))
    if not (dot_iv.fits32 and ivs.fits32 and 0 <= dl <= 31):
        return None

    # tail proof: fold nb block values through layers lvl.. with i32 routes
    # (identical structure to plan_tree's layer walk, incl. odd tails)
    nb = k // s
    cur_iv, cur = ivs, cur_fmt
    level = lvl
    n_vals = nb
    while n_vals > 1:
        lf = merge_fmts[level]
        ssum = cur_iv + cur_iv
        if not ssum.fits32:
            return None
        if route_requant(ssum, cur.frac_bits, lf) != "i32":
            return None
        if n_vals % 2 and route_requant(cur_iv, cur.frac_bits, lf) != "i32":
            return None
        pair_iv, _ = requant_out_interval(ssum, cur.frac_bits, lf)
        tail_iv, _ = requant_out_interval(cur_iv, cur.frac_bits, lf)
        cur_iv = Interval(min(pair_iv.lo, tail_iv.lo),
                          max(pair_iv.hi, tail_iv.hi))
        cur = lf
        level += 1
        n_vals = (n_vals + 1) // 2
    if route_requant(cur_iv, cur.frac_bits, out_fmt) != "i32":
        return None
    if dtype_for(out_fmt) is None:
        return None
    return HybridPlan(s, lvl, dl, tuple(level_fmts), tuple(merge_fmts), cur)


def tree_gemm_hybrid(a_data, b_data, plan: HybridPlan, out_fmt: QFormat):
    """[..., m, k] @ [..., k, n]: exact block dots over the lossless
    prefix, then the quantized tree tail (same association order as the
    reference's vector-path reducer from level ``plan.level`` up)."""
    import jax.numpy as jnp

    s = plan.s
    batch = jnp.broadcast_shapes(a_data.shape[:-2], b_data.shape[:-2])
    m, k = a_data.shape[-2:]
    n = b_data.shape[-1]
    a32 = jnp.broadcast_to(a_data, batch + (m, k))
    b32 = jnp.broadcast_to(b_data, batch + (k, n))
    nb = k // s
    As = a32.reshape(batch + (m, nb, s))
    Bs = b32.reshape(batch + (nb, s, n))
    dots = jnp.einsum("...mts,...tsn->...tmn", As, Bs,
                      preferred_element_type=jnp.int32)
    vals = jnp.moveaxis(dots, -3, 0)          # [nb, ..., m, n]
    if plan.dl:
        vals = vals << plan.dl

    level = plan.level
    while vals.shape[0] > 1:
        cnt = vals.shape[0]
        cur = plan.level_fmts[level]
        lf = plan.merge_fmts[level]
        pair = W.requantize_i32(vals[0 : (cnt // 2) * 2 : 2]
                                + vals[1 : (cnt // 2) * 2 : 2],
                                cur.frac_bits, lf)
        if cnt % 2:
            tail = W.requantize_i32(vals[cnt - 1 : cnt], cur.frac_bits, lf)
            pair = jnp.concatenate([pair, tail], axis=0)
        vals = pair
        level += 1
    raw = W.requantize_i32(vals[0], plan.final_fmt.frac_bits, out_fmt)
    return raw.astype(dtype_for(out_fmt))
