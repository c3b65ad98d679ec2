"""Word-delta scatter — refreshing staged tensors under writes.

Counterpart of ``pilosa_tpu/ops/delta.py``. A fragment's delta log
(core/fragment.py) replays onto an already staged tensor as one scatter
of per-word masks instead of a whole re-upload: one ``Set`` costs a
K-word patch, not a 128 KiB row (or a 190 MB plane stack).

Host side (numpy, copied): an ordered bit-delta stream collapses to
per-word OR / AND-NOT masks (``coalesce_bit_updates`` — the last op per
bit wins). Device side: ``flat[idx[k]] = (flat[idx[k]] | or[k]) &
~andnot[k]``, in two forms. ``apply_word_updates(_2d)`` return a NEW
tensor, as the JAX package's functions return a new array.
``apply_word_updates_`` patches the tensor in place; the stager calls it
only when no reader holds the staged snapshot (executor/stager.py), so
the batcher's rule "same live object ⇔ same snapshot" still holds.

Each device function has a plain PyTorch version (``*_plain``) and, for
a CUDA tensor, the hand-written kernel K7 (``ops/kernels/word_delta.cu``,
bound in ``ops/cuda.py``). The port compiles nothing per shape, so its
callers need no power-of-two padding; the functions still accept the
JAX contract's padding (``idx == total_words``, ``shard_idx == S``) and
drop it, so both packages take the same inputs. The parity shims at
the end (``coalesce_position_updates``, ``pad_updates``,
``apply_position_wave``) have no caller in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import cuda
from pilosa_tpu_torch.ops.packed import _on_cuda, words_from_numpy


def coalesce_bit_updates(
    word_idx: np.ndarray, bit_idx: np.ndarray, is_set: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse an ordered bit-delta stream to per-word update masks.

    word_idx[i] is the flat u32-word index of delta i, bit_idx[i] its
    bit within that word (0..31), is_set[i] True for set / False for
    clear. The LAST op per (word, bit) wins; surviving sets OR-combine
    into or_mask and surviving clears into andnot_mask.

    Returns (idx i32[K], or_mask u32[K], andnot_mask u32[K]) with idx
    unique and sorted; or_mask and andnot_mask are disjoint.
    """
    key = word_idx.astype(np.int64) * 32 + bit_idx.astype(np.int64)
    _, last_rev = np.unique(key[::-1], return_index=True)
    keep = key.size - 1 - last_rev
    k = key[keep]
    s = np.asarray(is_set)[keep]
    words = k >> 5
    bits = (k & 31).astype(np.uint32)
    uniq_words, inv = np.unique(words, return_inverse=True)
    or_mask = np.zeros(uniq_words.size, dtype=np.uint32)
    andnot_mask = np.zeros(uniq_words.size, dtype=np.uint32)
    bitmask = (np.uint32(1) << bits).astype(np.uint32)
    np.bitwise_or.at(or_mask, inv[s], bitmask[s])
    np.bitwise_or.at(andnot_mask, inv[~s], bitmask[~s])
    return uniq_words.astype(np.int32), or_mask, andnot_mask


def _i32(a, device) -> torch.Tensor:
    """An index or mask array (numpy u32/i32, or a tensor) as a
    contiguous int32 tensor on ``device``, same bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.int32:
            raise TypeError(f"update arrays must be int32, got {a.dtype}")
        return a.to(device).contiguous()
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.itemsize != 4 or arr.dtype.kind not in "ui":
        arr = arr.astype(np.int64).astype(np.uint32)
    return torch.from_numpy(arr.view("<i4").copy()).to(device)


def _updates(device, *arrays) -> list:
    """The update arrays on ``device`` (None stays None); host arrays
    bound for CUDA cross in one pinned upload, sliced back into views."""
    given = [a for a in arrays if a is not None]
    if device.type != "cuda" or any(isinstance(a, torch.Tensor) for a in given):
        return [None if a is None else _i32(a, device) for a in arrays]
    host = [np.ascontiguousarray(np.asarray(a)).astype(np.uint32, copy=False) for a in given]
    k = host[0].size
    if any(h.size != k for h in host):
        raise ValueError(f"update arrays differ in length: {[h.size for h in host]}")
    packed = words_from_numpy(np.concatenate(host), device)
    views = iter(packed[i * k : (i + 1) * k] for i in range(len(host)))
    return [None if a is None else next(views) for a in arrays]


def patch_words_2d_plain_(words, shard_idx, word_idx, or_mask, andnot_mask):
    """``words`` i32[S, M] patched in place:
    ``w[s, m] = (w[s, m] | or) & ~andnot`` at each valid (shard, word);
    an update whose shard or word lies outside [0, S) x [0, M) is
    dropped. ``shard_idx`` None means shard 0 of a one-shard [1, M]."""
    s, m = words.shape
    word_idx = word_idx.to(torch.int64)
    shard = (
        torch.zeros_like(word_idx) if shard_idx is None else shard_idx.to(torch.int64)
    )
    valid = (shard >= 0) & (shard < s) & (word_idx >= 0) & (word_idx < m)
    flat_idx = (shard * m + word_idx)[valid]
    flat = words.view(-1)
    cur = flat[flat_idx]
    flat[flat_idx] = (cur | or_mask[valid]) & ~andnot_mask[valid]
    return words


def apply_word_updates_2d_plain(words, shard_idx, word_idx, or_mask, andnot_mask):
    """New i32[S, M]: ``patch_words_2d_plain_`` on a copy of ``words``."""
    return patch_words_2d_plain_(words.clone(), shard_idx, word_idx, or_mask, andnot_mask)


def apply_word_updates_plain(words, idx, or_mask, andnot_mask):
    """New tensor of ``words``' shape with the per-word masks applied at
    the flat indexes ``idx`` (out of range = padding, dropped)."""
    flat = words.reshape(1, -1)
    return apply_word_updates_2d_plain(flat, None, idx, or_mask, andnot_mask).view(words.shape)


def apply_word_updates_2d(words: torch.Tensor, shard_idx, word_idx, or_mask, andnot_mask):
    """Shard-stack form: ``words`` i32[S, M], per-update (shard, word)
    coordinates; ``shard_idx == S`` marks padding. Returns a new
    tensor."""
    if words.dim() != 2:
        raise ValueError(f"words must be i32[S, M], got {tuple(words.shape)}")
    shard_t, word_t, om, am = _updates(words.device, shard_idx, word_idx, or_mask, andnot_mask)
    if _on_cuda(words):
        return cuda.word_delta(words, shard_t, word_t, om, am)
    return apply_word_updates_2d_plain(words, shard_t, word_t, om, am)


def apply_word_updates(words: torch.Tensor, idx, or_mask, andnot_mask):
    """Scatter-apply per-word masks to a staged tensor of any shape:
    ``idx`` indexes the flattened words (out of range = padding,
    dropped). Returns a new tensor of the same shape."""
    word_t, om, am = _updates(words.device, idx, or_mask, andnot_mask)
    flat = words.reshape(1, -1)
    if _on_cuda(words):
        return cuda.word_delta(flat, None, word_t, om, am).view(words.shape)
    return apply_word_updates_2d_plain(flat, None, word_t, om, am).view(words.shape)


def apply_word_updates_(words: torch.Tensor, idx, or_mask, andnot_mask) -> torch.Tensor:
    """``apply_word_updates`` in place: patches the K words of the
    contiguous ``words`` and returns it. The caller must know that no
    reader holds ``words``' storage."""
    if not words.is_contiguous():
        raise ValueError("an in-place patch needs a contiguous tensor")
    word_t, om, am = _updates(words.device, idx, or_mask, andnot_mask)
    flat = words.view(1, -1)
    if _on_cuda(words):
        cuda.word_delta_(flat, None, word_t, om, am)
    else:
        patch_words_2d_plain_(flat, None, word_t, om, am)
    return words


# -- parity shims ----------------------------------------------------------
#
# No caller in the port: they keep the JAX package's contract (a write
# wave's flat positions, compile-cache padding) so tests/test_torch_delta.py
# runs the same inputs through both packages.


def coalesce_position_updates(
    positions: np.ndarray, is_set: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``coalesce_bit_updates`` over flat fragment bit positions
    (row * SHARD_WIDTH + col), the coordinate a write wave carries."""
    pos = np.asarray(positions, dtype=np.int64)
    return coalesce_bit_updates(
        pos >> 5, (pos & 31).astype(np.int64), np.asarray(is_set, dtype=bool)
    )


def pad_updates(
    idx: np.ndarray,
    or_mask: np.ndarray,
    andnot_mask: np.ndarray,
    total_words: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad an update batch to the next power of two with idx =
    total_words (out of range: dropped) and zero masks — the JAX
    package's compile-cache bucketing, kept for input parity."""
    k = idx.size
    target = 1 << (max(k, 1) - 1).bit_length()  # the next power of two
    if target == k:
        return idx, or_mask, andnot_mask
    pad = target - k
    return (
        np.concatenate([idx, np.full(pad, total_words, dtype=np.int32)]),
        np.concatenate([or_mask, np.zeros(pad, dtype=np.uint32)]),
        np.concatenate([andnot_mask, np.zeros(pad, dtype=np.uint32)]),
    )


def apply_position_wave(words: torch.Tensor, positions, is_set):
    """One coalesced scatter for a whole write wave (flat bit positions
    into ``words`` of any shape)."""
    idx, or_mask, andnot_mask = coalesce_position_updates(positions, is_set)
    return apply_word_updates(words, idx, or_mask, andnot_mask)
