"""Plain PyTorch version of the attention-dropout position hash.

The same function as ``csrc/dropout_hash.cuh``, which the flash-attention
forward and backward kernels and the dump kernel share; counterpart of the
TPU kernels' ``_keep_mask`` (turkish_asr_tpu/ops/_flash_attention_impl.py
:62) and ``dump_keep_mask`` (:152-199). The TPU drew its bits from a
hardware PRNG seeded per grid program, so they depended on the tiling;
here the bits are a hash of (seed, batch, query head, query row, key), so
every tiling, and this version, gives the same mask:

    stream = fmix32(seed ^ (b * H + h + 1) * 0x9E3779B1)
    row    = fmix32(stream ^ (t + 1) * 0x85EBCA77)
    bits   = fmix32(row ^ (j + 1) * 0xC2B2AE3D)
    keep   = bits >= threshold

All arithmetic is 32-bit unsigned with wraparound, done here in int64 with
products split so that no intermediate exceeds 2^49.
"""

import torch

_M32 = 0xFFFFFFFF


def keep_threshold(rate):
    """The uint32 threshold of a keep: bits >= min(floor(rate * 2^32), 2^32 - 1),
    as the TPU kernel's ``_keep_mask`` computes it."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def fmix32(h):
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _row_hashes(seed, bh, t):
    """The row hashes of query rows ``t`` of (batch, head) index ``bh`` =
    b * H + h, int64 tensors broadcast together."""
    stream = fmix32(int(seed) ^ _mul32(bh + 1, 0x9E3779B1))
    return fmix32(stream ^ _mul32(t + 1, 0x85EBCA77))


def _keeps(row, T, rate):
    """row's keep bits against keys 0..T-1, on a new last axis."""
    keys = torch.arange(1, T + 1, dtype=torch.int64, device=row.device)
    return fmix32(row[..., None] ^ _mul32(keys, 0xC2B2AE3D)) >= keep_threshold(rate)


def keep_mask_ref(seed, B, H, T, rate, device="cpu"):
    """(B, H, T, T) bool keep mask of query rows against keys, for query
    heads H (MQA and MHA alike). ``seed`` is an int in [0, 2^32)."""
    i64 = dict(dtype=torch.int64, device=device)
    bh = torch.arange(B, **i64)[:, None] * H + torch.arange(H, **i64)[None, :]
    return _keeps(_row_hashes(seed, bh[:, :, None], torch.arange(T, **i64)), T, rate)


def keep_rows_ref(seed, b, H, h, rows, T, rate, device="cpu"):
    """(len(rows), T) bool: query rows ``rows`` (ints in [0, T)) of batch
    ``b`` and query head ``h`` (of H) of ``keep_mask_ref``'s mask, without
    the rest of it: a check of a dump too large to rebuild whole."""
    i64 = dict(dtype=torch.int64, device=device)
    row = _row_hashes(seed, torch.tensor(b * H + h, **i64), torch.as_tensor(rows, **i64))
    return _keeps(row.reshape(-1), T, rate)
