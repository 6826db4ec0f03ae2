# Copied from turkish_asr_tpu/audio/flacio.py; only the imports and the form of the
# reference-file citations differ. The JAX package's own __init__ files
# import JAX, so this jax-free host module cannot be imported from there.
"""Self-contained FLAC decoder (pure Python; native C++ fast path through
turkish_asr_torch.native).

The reference decodes FLAC through torchaudio/ffmpeg
(reference data/preprocessing.py:66-79, its image installs ffmpeg —
Dockerfile:6-9) and its API whitelists .flac uploads (serve/api.py:117-124).
This hermetic image ships neither ffmpeg nor libsndfile, so FLAC support is
implemented from the format spec: STREAMINFO parse, frame headers (all
block-size/sample-rate/sample-size codes, UTF-8 coded frame numbers),
subframe types CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32), partitioned
Rice residuals (4- and 5-bit parameters, escape codes), wasted bits, and
the left/side, right/side and mid/side stereo decorrelation modes.

This module is the always-available fallback and the correctness oracle
for the C++ decoder (native/src/asr_native.cpp flac_decode). CRCs are
parsed but not verified (decode speed; structural sync bits ARE checked).
"""

import numpy as np


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    __slots__ = ("data", "pos", "bit")

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos      # byte position
        self.bit = 0        # bits consumed within data[pos]

    def read(self, n):
        """Read n bits as an unsigned int."""
        out = 0
        pos, bit, data = self.pos, self.bit, self.data
        while n > 0:
            if pos >= len(data):
                raise ValueError("FLAC: unexpected end of stream")
            avail = 8 - bit
            take = min(n, avail)
            byte = data[pos]
            out = (out << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            bit += take
            n -= take
            if bit == 8:
                bit = 0
                pos += 1
        self.pos, self.bit = pos, bit
        return out

    def read_signed(self, n):
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self):
        """Count zero bits until the terminating 1 bit."""
        count = 0
        pos, bit, data = self.pos, self.bit, self.data
        while True:
            if pos >= len(data):
                raise ValueError("FLAC: unexpected end of stream (unary)")
            byte = data[pos]
            rem = (byte << bit) & 0xFF
            if rem == 0:
                count += 8 - bit
                pos += 1
                bit = 0
                continue
            lead = 8 - rem.bit_length()  # leading zeros within remaining bits
            count += lead
            bit += lead + 1
            if bit >= 8:
                bit -= 8
                pos += 1
            self.pos, self.bit = pos, bit
            return count

    def align(self):
        if self.bit:
            self.bit = 0
            self.pos += 1


def _read_utf8_number(br):
    """FLAC's extended UTF-8 coded frame/sample number."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_follow = 0
    mask = 0x40
    while b0 & mask:
        n_follow += 1
        mask >>= 1
    if n_follow == 0 or n_follow > 6:
        raise ValueError("FLAC: invalid UTF-8 coded number")
    val = b0 & (mask - 1)
    for _ in range(n_follow):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("FLAC: invalid UTF-8 continuation")
        val = (val << 6) | (b & 0x3F)
    return val


_BLOCK_SIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                     8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                     13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATE_TABLE = {0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000,
                      5: 16000, 6: 22050, 7: 24000, 8: 32000, 9: 44100,
                      10: 48000, 11: 96000}
_SAMPLE_SIZE_TABLE = {0: None, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br, block_size, order):
    """Partitioned Rice-coded residual -> list of ints."""
    method = br.read(2)
    if method > 1:
        raise ValueError(f"FLAC: reserved residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError("FLAC: partition count doesn't divide block size")
    out = []
    for p in range(n_parts):
        n = block_size // n_parts - (order if p == 0 else 0)
        if n < 0:
            raise ValueError("FLAC: predictor order exceeds first partition")
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                out.extend([0] * n)
            else:
                out.extend(br.read_signed(raw_bits) for _ in range(n))
        else:
            for _ in range(n):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                out.append((v >> 1) ^ -(v & 1))  # zigzag
    return out


def _decode_subframe(br, block_size, bps):
    """One subframe -> list of ints (bps-bit samples)."""
    if br.read(1):
        raise ValueError("FLAC: subframe sync bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    if stype == 0:  # CONSTANT
        v = br.read_signed(bps)
        samples = [v] * block_size
    elif stype == 1:  # VERBATIM
        samples = [br.read_signed(bps) for _ in range(block_size)]
    elif 8 <= stype <= 12:  # FIXED, order = stype - 8
        order = stype - 8
        samples = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, block_size, order)
        coef = _FIXED_COEFFS[order]
        for i, r in enumerate(resid):
            pred = 0
            base = order + i
            for j, c in enumerate(coef):
                pred += c * samples[base - 1 - j]
            samples.append(pred + r)
    elif stype >= 32:  # LPC, order = stype - 31
        order = stype - 31
        samples = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("FLAC: invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("FLAC: negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        resid = _decode_residual(br, block_size, order)
        for i, r in enumerate(resid):
            base = order + i
            acc = 0
            for j, c in enumerate(coefs):
                acc += c * samples[base - 1 - j]
            samples.append((acc >> shift) + r)
    else:
        raise ValueError(f"FLAC: reserved subframe type {stype}")

    if wasted:
        samples = [s << wasted for s in samples]
    return samples


def _decode_frame(br, stream_bps):
    """One frame -> (channel sample lists, block_size)."""
    sync = br.read(14)
    if sync != 0b11111111111110:
        raise ValueError(f"FLAC: lost frame sync (got {sync:#x})")
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    _read_utf8_number(br)

    if bs_code == 0:
        raise ValueError("FLAC: reserved block size code 0")
    elif bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCK_SIZE_TABLE[bs_code]

    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise ValueError("FLAC: invalid sample rate code")

    bps = _SAMPLE_SIZE_TABLE.get(ss_code)
    if bps is None:
        if ss_code == 0:
            bps = stream_bps
        else:
            raise ValueError(f"FLAC: reserved sample size code {ss_code}")

    br.read(8)  # CRC-8 (not verified)

    if ch_code < 8:
        n_ch = ch_code + 1
        chans = [_decode_subframe(br, block_size, bps) for _ in range(n_ch)]
    elif ch_code == 8:   # left/side
        left = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        chans = [left, [l - s for l, s in zip(left, side)]]
    elif ch_code == 9:   # right/side
        side = _decode_subframe(br, block_size, bps + 1)
        right = _decode_subframe(br, block_size, bps)
        chans = [[r + s for r, s in zip(right, side)], right]
    elif ch_code == 10:  # mid/side
        mid = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        left, right = [], []
        for m, s in zip(mid, side):
            m = (m << 1) | (s & 1)
            left.append((m + s) >> 1)
            right.append((m - s) >> 1)
        chans = [left, right]
    else:
        raise ValueError(f"FLAC: reserved channel assignment {ch_code}")

    br.align()
    br.read(16)  # CRC-16 (not verified)
    return chans, block_size


def read_flac_bytes(data):
    """Decode a FLAC stream.

    Returns:
        (waveform, sample_rate): float32 (channels, samples) in [-1, 1].
    """
    if len(data) < 4 or data[:4] != b"fLaC":
        raise ValueError("Not a FLAC stream")
    pos = 4
    sample_rate = None
    n_channels = None
    bps = None
    total = None
    # metadata blocks
    while True:
        if pos + 4 > len(data):
            raise ValueError("FLAC: truncated metadata")
        head = data[pos]
        last = head & 0x80
        btype = head & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if btype == 0:  # STREAMINFO
            if length < 34:
                raise ValueError("FLAC: short STREAMINFO")
            br = _BitReader(body)
            br.read(16)  # min block size
            br.read(16)  # max block size
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            sample_rate = br.read(20)
            n_channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("FLAC: missing STREAMINFO")

    br = _BitReader(data, pos)
    chans = [[] for _ in range(n_channels)]
    done = 0
    while br.pos < len(data) and (total == 0 or done < total):
        # tolerate trailing padding/garbage after the last frame
        if total == 0 and br.pos + 2 <= len(data):
            if data[br.pos] != 0xFF or (data[br.pos + 1] >> 2) != 0x3E:
                break
        frame, block = _decode_frame(br, bps)
        if len(frame) != n_channels:
            raise ValueError("FLAC: frame channel count != STREAMINFO")
        for c, samples in zip(chans, frame):
            c.extend(samples)
        done += block

    scale = float(1 << (bps - 1))
    out = np.asarray(chans, dtype=np.float64) / scale
    if total:
        out = out[:, :total]
    return np.ascontiguousarray(out.astype(np.float32)), sample_rate


def read_flac(path):
    """Decode a FLAC file -> (float32 (channels, samples), sample_rate).

    Uses the native C++ decoder when available, this pure-Python
    implementation otherwise.
    """
    with open(path, "rb") as f:
        data = f.read()
    try:
        from turkish_asr_torch.native.loader import flac_decode_native
        native = flac_decode_native(data)
        if native is not None:
            return native
    except ValueError:
        pass  # native rejected the stream: fall through to the oracle
    return read_flac_bytes(data)
