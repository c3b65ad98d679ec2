"""Bit-sliced-index (BSI) ops — Sum/Min/Max/Range/Percentile/Distinct as
bit-plane algebra on the device.

The port of ``pilosa_tpu/ops/bsi.py``. A BSI field stores an integer per
column as ``bit_depth`` bit-plane rows plus a not-null row at plane index
``bit_depth`` (reference fragment.go:467-836). ``planes`` is an int32
[D+1, W] stack for one shard or the staged [S, D+1, W] stack for a shard
batch; filters are [W] / [S, W] words.

  * Sum's per-plane counts run on K4 (``packed.groupby_reduce`` with no
    dimension: the one group is the filter);
  * Range's five recurrences run on K5 (``ops/kernels/bsi_range.cu``):
    their scalar state depends only on the predicate, so the host lowers
    it to one opcode byte per plane (``range_program``) and the kernel
    reads each plane once. Predicates are Python ints: any depth up to 63;
  * Min and Max run on K8 (``ops/kernels/bsi_minmax.cu``): one launch
    runs every shard's recurrence, a thread-block cluster per shard;
  * Distinct runs on K9 (``ops/kernels/distinct_presence.cu``): one
    launch marks every considered column's value in a presence bitmap;
  * Percentile runs on K10 (``ops/kernels/bsi_percentile.cu``): one
    cooperative launch walks every plane step of the search, each step's
    count over every shard reduced across the grid on the card, so
    nothing leaves the card before the caller's one fetch.

CPU tensors run the plain versions (the tests); CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import cuda
from pilosa_tpu_torch.ops.packed import _on_cuda, groupby_reduce, popcount

# K5 opcodes (one nibble each; the low nibble runs first) and output
# selectors — the table in ops/kernels/bsi_range.cu.
NOP, B_AND, B_ANDNOT, GT_STEP, GT_KEEP, LT_STEP, LT_KEEP = range(7)
OUT_B, OUT_K1, OUT_K2, OUT_NEQ = range(4)
RANGE_OPS = ("==", "!=", "<", "<=", ">", ">=", "><")


def range_program(op: str, bit_depth: int, pred: int, pred_max: int = 0):
    """Lower a Range predicate to (code, out_sel): code[i] the opcode byte
    of plane i (i < bit_depth). Replays the CPU recurrences of
    core/fragment.py range_eq/_neq/_lt/_gt/_between (reference
    fragment.go:678-840) on the predicate alone, so the kernel's one pass
    gives the same row. ``pred`` and ``pred_max`` are non-negative base
    values of any width up to ``bit_depth`` bits."""
    if op not in RANGE_OPS:
        raise ValueError(f"invalid range operation: {op}")
    if not 0 <= bit_depth <= cuda.BSI_MAX_DEPTH:
        raise ValueError(f"bit depth {bit_depth} outside [0, {cuda.BSI_MAX_DEPTH}]")
    code = [NOP] * bit_depth
    out = OUT_B

    def bit(v: int, i: int) -> int:
        return (v >> i) & 1

    if op in ("==", "!="):
        for i in range(bit_depth):
            code[i] = B_AND if bit(pred, i) else B_ANDNOT
        return tuple(code), OUT_NEQ if op == "!=" else OUT_B
    if op in ("<", "<="):
        allow_eq = op == "<="
        leading = True
        for i in reversed(range(bit_depth)):
            b = bit(pred, i)
            if leading:
                if b == 0:
                    code[i] = B_ANDNOT
                    continue
                leading = False
            if i == 0 and not allow_eq:
                if b == 0:
                    out = OUT_K2  # return keep
                else:
                    code[i] = LT_STEP
                break
            if b == 0:
                code[i] = LT_STEP
            elif i > 0:
                code[i] = LT_KEEP
        return tuple(code), out
    if op in (">", ">="):
        allow_eq = op == ">="
        for i in reversed(range(bit_depth)):
            b = bit(pred, i)
            if i == 0 and not allow_eq:
                if b == 1:
                    out = OUT_K1  # return keep
                else:
                    code[i] = GT_STEP
                break
            if b == 1:
                code[i] = GT_STEP
            elif i > 0:
                code[i] = GT_KEEP
        return tuple(code), out
    # BETWEEN, inclusive at both ends: the GTE(min) side, then LTE(max)
    for i in reversed(range(bit_depth)):
        lo = GT_STEP if bit(pred, i) else (GT_KEEP if i > 0 else NOP)
        hi = LT_STEP if not bit(pred_max, i) else (LT_KEEP if i > 0 else NOP)
        code[i] = lo | (hi << 4)
    return tuple(code), OUT_B


def _step(op: int, b, k1, k2, row):
    if op == B_AND:
        b = b & row
    elif op == B_ANDNOT:
        b = b & ~row
    elif op == GT_STEP:
        b = b & ~(b & ~row & ~k1)
    elif op == GT_KEEP:
        k1 = k1 | (b & row)
    elif op == LT_STEP:
        b = b & ~(row & ~k2)
    elif op == LT_KEEP:
        k2 = k2 | (b & ~row)
    return b, k1, k2


def bsi_range_plain(planes: torch.Tensor, code, out_sel: int) -> torch.Tensor:
    """Run a range program over [S, D+1, W] planes -> i32[S, W]: the
    kernel's arithmetic in plain PyTorch."""
    depth = planes.shape[-2] - 1
    nn = planes.select(-2, depth)
    b = nn.clone()
    k1 = torch.zeros_like(b)
    k2 = torch.zeros_like(b)
    for i in reversed(range(depth)):
        op = code[i]
        if op == NOP:
            continue
        row = planes.select(-2, i)
        b, k1, k2 = _step(op & 15, b, k1, k2, row)
        b, k1, k2 = _step(op >> 4, b, k1, k2, row)
    if out_sel == OUT_K1:
        return k1
    if out_sel == OUT_K2:
        return k2
    if out_sel == OUT_NEQ:
        return nn & ~b
    return b


def bsi_range(planes: torch.Tensor, op: str, bit_depth: int, pred: int, pred_max: int = 0):
    """Range(field <op> pred) over [D+1, W] or [S, D+1, W] planes -> the
    row's words ([W] or [S, W]). Launches K5 on CUDA tensors."""
    if planes.shape[-2] != bit_depth + 1:
        raise ValueError(f"{planes.shape[-2]} planes for bit depth {bit_depth}")
    code, out_sel = range_program(op, bit_depth, pred, pred_max)
    p3 = planes.unsqueeze(0) if planes.dim() == 2 else planes
    if _on_cuda(p3):
        out = cuda.bsi_range(p3, code, out_sel)
    else:
        out = bsi_range_plain(p3, code, out_sel)
    return out[0] if planes.dim() == 2 else out


# The JAX package's five entry points, same names and arguments.


def bsi_range_eq(planes, predicate: int, *, bit_depth: int):
    return bsi_range(planes, "==", bit_depth, int(predicate))


def bsi_range_neq(planes, predicate: int, *, bit_depth: int):
    return bsi_range(planes, "!=", bit_depth, int(predicate))


def bsi_range_lt(planes, predicate: int, *, bit_depth: int, allow_equality: bool):
    return bsi_range(planes, "<=" if allow_equality else "<", bit_depth, int(predicate))


def bsi_range_gt(planes, predicate: int, *, bit_depth: int, allow_equality: bool):
    return bsi_range(planes, ">=" if allow_equality else ">", bit_depth, int(predicate))


def bsi_range_between(planes, pred_min: int, pred_max: int, *, bit_depth: int):
    return bsi_range(planes, "><", bit_depth, int(pred_min), int(pred_max))


# -- Sum: per-plane counts on K4 ----------------------------------------------------


def bsi_plane_counts_batched(planes, filter_rows, *, bit_depth: int, has_filter: bool):
    """Per-plane counts over a shard batch: planes [S, D+1, W], filter
    [S, W] -> i32[D+1]; counts[D] is the filtered not-null count. The
    host assembles Σ counts[i] << i in Python ints."""
    filt = filter_rows if has_filter else None
    return groupby_reduce((), filt, planes)[1][0]


def bsi_plane_counts(planes, filter_row, *, bit_depth: int, has_filter: bool):
    """One shard: planes [D+1, W], filter [W] -> i32[D+1]."""
    return bsi_plane_counts_batched(
        planes.unsqueeze(0),
        filter_row.reshape(1, -1) if has_filter else None,
        bit_depth=bit_depth,
        has_filter=has_filter,
    )


# -- Min / Max: K8 ----------------------------------------------------------------


def _consider(planes, filter_rows, has_filter: bool):
    exists = planes.select(-2, planes.shape[-2] - 1)
    if has_filter:
        return exists & filter_rows.reshape(exists.shape)
    return exists.contiguous()


def _minmax(planes, filter_row, bit_depth: int, has_filter: bool, is_min: bool):
    """One shard's recurrence over its [D+1, W] planes in plain PyTorch
    -> (bits bool[D], count i32)."""
    consider = _consider(planes, filter_row, has_filter)
    bits = []
    for i in reversed(range(bit_depth)):
        row = planes.select(-2, i)
        x = consider & ~row if is_min else consider & row
        pred = popcount(x).sum() > 0
        consider = torch.where(pred, x, consider)
        # min: bit i is set iff no considered column has it clear
        bits.append(~pred if is_min else pred)
    count = popcount(consider).sum().to(torch.int32)
    stacked = torch.stack(bits[::-1]) if bits else torch.zeros(0, dtype=torch.bool, device=planes.device)
    return stacked, count


def bsi_minmax_plain(planes, filt, is_min: bool):
    """K8's function in plain PyTorch: each shard's recurrence over
    [S, D+1, W] planes and an optional [S, W] filter -> (bits bool[S, D],
    count i32[S])."""
    s, d1, _ = planes.shape
    bits = torch.zeros((s, d1 - 1), dtype=torch.bool, device=planes.device)
    count = torch.zeros(s, dtype=torch.int32, device=planes.device)
    for i in range(s):
        f = None if filt is None else filt[i]
        bits[i], count[i] = _minmax(planes[i], f, d1 - 1, filt is not None, is_min)
    return bits, count


def bsi_minmax_batched(planes, filter_rows, *, is_min: bool, bit_depth: int, has_filter: bool):
    """Min (or Max) of every shard of a [S, D+1, W] batch under an
    optional [S, W] filter -> (bits bool[S, D], count i32[S]), one
    recurrence per shard: bits[s, i] is bit i of shard s's extreme value,
    count[s] the columns holding it (0: no value). One K8 launch on CUDA
    tensors."""
    if planes.shape[-2] != bit_depth + 1:
        raise ValueError(f"{planes.shape[-2]} planes for bit depth {bit_depth}")
    filt = filter_rows if has_filter else None
    if _on_cuda(planes):
        return cuda.bsi_minmax(planes, filt, is_min)
    return bsi_minmax_plain(planes, filt, is_min)


def _fold_minmax(bits, count, is_min: bool):
    """Per-shard (bits [S, D], count [S]) -> the global (bits [D], count)
    on the device: the extreme value over shards with a count, and the
    columns of every shard holding it; with none, what the recurrence
    gives an empty set (all ones for Min, zeros for Max; count 0)."""
    depth = bits.shape[1]
    shifts = torch.arange(depth, dtype=torch.int64, device=bits.device)
    vals = (bits.to(torch.int64) << shifts).sum(dim=1)
    valid = count > 0
    fill = torch.full_like(vals, torch.iinfo(torch.int64).max if is_min else -1)
    keyed = torch.where(valid, vals, fill)
    best = keyed.min() if is_min else keyed.max()
    hit = valid & (vals == best)
    total = torch.where(hit, count.to(torch.int64), torch.zeros_like(vals)).sum()
    empty = torch.full((depth,), is_min, dtype=torch.bool, device=bits.device)
    return torch.where(valid.any(), ((best >> shifts) & 1).bool(), empty), total.to(torch.int32)


def _minmax_op(planes, filter_row, bit_depth: int, has_filter: bool, is_min: bool):
    batch = planes.unsqueeze(0) if planes.dim() == 2 else planes
    f = filter_row.reshape(batch.shape[0], -1) if has_filter else None
    bits, count = bsi_minmax_batched(batch, f, is_min=is_min, bit_depth=bit_depth, has_filter=has_filter)
    if planes.dim() == 2:
        return bits[0], count[0]
    return _fold_minmax(bits, count, is_min)


def bsi_min(planes, filter_row, *, bit_depth: int, has_filter: bool):
    """Min recurrence (reference fragment.min:599-630) -> (bits bool[D],
    count i32): bits[i] is bit i of the minimum; count the columns that
    hold it. One shard's [D+1, W] is one K8 recurrence; a [S, D+1, W]
    batch is taken as one set of columns (the per-shard results folded
    on the device)."""
    return _minmax_op(planes, filter_row, bit_depth, has_filter, True)


def bsi_max(planes, filter_row, *, bit_depth: int, has_filter: bool):
    """Max recurrence (reference fragment.max:632-661)."""
    return _minmax_op(planes, filter_row, bit_depth, has_filter, False)


# -- Percentile: K10; Distinct: K9 ------------------------------------------------------


def bsi_percentile_plain(planes, filt, nth_bp: int):
    """K10's function in plain PyTorch: the nearest-rank search over
    [S, D+1, W] planes and an optional [S, W] filter -> (bits bool[D],
    count i32). Every count is a popcount sum; ``torch.where`` takes the
    place of the branch, so on the card nothing waits for the host."""
    depth = planes.shape[-2] - 1
    consider = _consider(planes, filt, filt is not None)
    count = popcount(consider).sum()
    q = count // 10000
    r = count % 10000
    k = nth_bp * q + (nth_bp * r + 9999) // 10000
    k = torch.minimum(torch.clamp(k, min=1), torch.clamp(count, min=1))
    bits = []
    for i in reversed(range(depth)):
        plane = planes.select(-2, i)
        zeros = consider & ~plane
        c = popcount(zeros).sum()
        pred = k <= c
        bits.append(~pred)
        consider = torch.where(pred, zeros, consider & plane)
        k = torch.where(pred, k, k - c)
    stacked = torch.stack(bits[::-1]) if bits else torch.zeros(0, dtype=torch.bool, device=planes.device)
    return stacked, count.to(torch.int32)


def bsi_percentile_batched(planes, filter_rows, nth_bp: int, *, bit_depth: int, has_filter: bool):
    """Nearest-rank percentile as a bit-sliced binary search over a
    [S, D+1, W] batch -> (bits bool[D], count i32). ``nth_bp`` is in basis
    points, so k = ceil(nth * n / 100) is exact integer arithmetic. Walking
    planes high to low: if at least k considered columns have bit i clear,
    the k-th smallest has it clear and the zeros are kept; else bit i is
    set and k drops by the zeros count. count == 0 means no value. One K10
    launch on CUDA tensors, with no host sync."""
    if planes.shape[-2] != bit_depth + 1:
        raise ValueError(f"{planes.shape[-2]} planes for bit depth {bit_depth}")
    filt = filter_rows if has_filter else None
    if _on_cuda(planes):
        return cuda.bsi_percentile(planes, filt, int(nth_bp))
    return bsi_percentile_plain(planes, filt, int(nth_bp))


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """i32[W] -> i64[W * 32], bit p of word j at index j * 32 + p."""
    pos = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words.unsqueeze(-1) >> pos) & 1).reshape(-1).to(torch.int64)


def bsi_distinct_presence_plain(planes, filt, bit_depth: int):
    """K9's function in plain PyTorch: planes [S, D+1, W] and an optional
    [S, W] filter -> i32 packed presence words over the value domain
    [0, 2^D). Each existing (and filtered) column's value is reassembled
    from its plane bits and marks its slot; shards OR into one presence
    vector, one shard wide at a time."""
    domain = 1 << bit_depth
    nwords = max((domain + 31) // 32, 1)
    pres = torch.zeros(nwords * 32, dtype=torch.bool, device=planes.device)
    for s in range(planes.shape[0]):
        sp = planes[s]
        exists = sp[bit_depth] & filt[s] if filt is not None else sp[bit_depth]
        vals = torch.zeros(sp.shape[-1] * 32, dtype=torch.int64, device=planes.device)
        for i in range(bit_depth):
            vals |= _unpack(sp[i]) << i
        pres[vals[_unpack(exists).bool()]] = True
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    words = (pres.view(nwords, 32).to(torch.int64) << shifts).sum(dim=1)
    # u32 bit patterns as int32
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def bsi_distinct_presence(planes, filter_rows, *, bit_depth: int, has_filter: bool):
    """Distinct as a presence bitmap over the value domain [0, 2^D):
    planes [S, D+1, W] -> i32 packed presence words (bit v set iff some
    existing, filtered column holds v). One K9 launch on CUDA tensors,
    with no host sync; callers bound D (the bitmap holds 2^D bits)."""
    if planes.shape[-2] != bit_depth + 1:
        raise ValueError(f"{planes.shape[-2]} planes for bit depth {bit_depth}")
    filt = filter_rows if has_filter else None
    if _on_cuda(planes):
        return cuda.distinct_presence(planes, filt, bit_depth)
    return bsi_distinct_presence_plain(planes, filt, bit_depth)
