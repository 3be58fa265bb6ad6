"""Length bucketing for ragged message batches (counterpart of
curve25519_tpu/utils/bucketing.py).

A batch of messages of many lengths is grouped by SHA-512 block count: all
messages whose padded stream needs nb = ceil((len + 17) / 128) blocks share
one fixed-shape call at the padded length L = 128*nb - 17 (the largest
length with nb blocks), so no lane hashes blocks that only a longer message
needs. The buckets are padded on the host, moved to the device of the
per-row arguments (else `device=`, else the card), run once each, and the
results scattered back to input order.
"""

import numpy as np
import torch

from curve25519_tpu_torch.ops.cuda import pick_device
from curve25519_tpu_torch.ops.sha512 import BLOCK_LEN

__all__ = ["nblocks", "bucket_length", "bucket_indices", "apply_bucketed"]

_TAIL = 17          # the 0x80 pad byte and the 128-bit length field


def nblocks(length):
    """SHA-512 block count of a message of `length` bytes."""
    return (int(length) + _TAIL + BLOCK_LEN - 1) // BLOCK_LEN


def bucket_length(nb):
    """The padded length of an nb-block bucket: the largest message length
    that still fits nb blocks."""
    return BLOCK_LEN * nb - _TAIL


def bucket_indices(lengths):
    """{nb: np.ndarray of the indices with nb blocks}, ascending nb."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nbs = (lengths + _TAIL + BLOCK_LEN - 1) // BLOCK_LEN
    return {int(nb): np.nonzero(nbs == nb)[0] for nb in np.unique(nbs)}


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lengths(msgs):
    """The message lengths of a ragged batch, and the batch with a
    (padded, lengths) pair brought to the host and checked."""
    if not isinstance(msgs, tuple):
        return np.array([len(m) for m in msgs], dtype=np.int64), msgs
    padded = _host(msgs[0]).astype(np.uint8, copy=False)
    lengths = _host(msgs[1]).astype(np.int64)
    if padded.ndim != 2 or lengths.shape != padded.shape[:1] or (
            lengths > padded.shape[1]).any() or (lengths < 0).any():
        raise ValueError("expected ([B, W] bytes, [B] lengths <= W), got %s "
                         "and %s" % (padded.shape, lengths.shape))
    return lengths, (padded, lengths)


def _rows(msgs, lengths, idx, width):
    """[len(idx), width] uint8: the messages idx, zero past each length."""
    if isinstance(msgs, tuple):
        padded = msgs[0]
        rows = np.zeros((len(idx), width), np.uint8)
        w = min(width, padded.shape[1])
        rows[:, :w] = padded[idx, :w]
        rows[np.arange(width) >= lengths[idx, None]] = 0
        return rows
    # one slice copy per message, with no [rows, width] index arrays
    buf = bytearray(len(idx) * width)
    for r, i in enumerate(idx.tolist()):
        buf[r * width:r * width + lengths[i]] = msgs[i]
    return np.frombuffer(buf, np.uint8).reshape(len(idx), width)


def _stack(pieces, fn):
    """Apply fn to the lists of matching leaves of equal pytrees (tensor,
    tuple, list or dict)."""
    first = pieces[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in pieces], fn) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(leaves), fn)
                           for leaves in zip(*pieces))
    return fn(pieces)


def apply_bucketed(fn, msgs, *row_args, device=None):
    """Run fn(msg_batch, lengths, *row_arg_rows) once per block-count bucket
    of a ragged batch and return the results in input order.

    fn: takes ([b, L] uint8 messages, [b] int32 lengths, *per-row tensors)
        and returns a tensor (or a tuple, list or dict of them) with leading
        axis b.
    msgs: a list of bytes-like messages, or a tuple (padded [B, W] uint8,
        lengths [B]) of arrays or tensors.
    row_args: tensors with first axis len(msgs), all on one device; each
        call gets the rows of its bucket.
    device: where the buckets go when there are no row tensors (default
        the card)."""
    lengths, msgs = _lengths(msgs)
    dev = pick_device(*row_args, device=device)
    for a in row_args:
        if a.device != dev:
            raise ValueError("per-row arguments on %s and %s"
                             % (dev, a.device))
    pieces, order = [], []
    for nb, idx in bucket_indices(lengths).items():
        rows = _rows(msgs, lengths, idx, bucket_length(nb))
        idx_t = torch.from_numpy(idx).to(dev)
        pieces.append(fn(torch.from_numpy(rows).to(dev),
                         torch.from_numpy(lengths[idx].astype(np.int32)).to(
                             dev),
                         *(a[idx_t] for a in row_args)))
        order.append(idx)
    inv = np.empty(len(lengths), dtype=np.int64)
    inv[np.concatenate(order)] = np.arange(len(lengths))
    inv_t = torch.from_numpy(inv).to(dev)
    return _stack(pieces, lambda leaves: torch.cat(leaves)[inv_t])
