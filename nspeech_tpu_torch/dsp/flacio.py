"""Pure-Python FLAC decoder (RFC 9639): a copy of
``nspeech_tpu/dsp/flacio.py`` (numpy only).

LibriSpeech-style corpora ship .flac files, and ``wavio.load_wav``
dispatches them here. Supports the mandatory subset a decoder needs for
real-world files: CONSTANT/VERBATIM/FIXED(0-4)/LPC(1-32) subframes, rice +
rice2 partitioned residuals with escape codes, wasted bits, all stereo
decorrelation modes, header CRC-8 and frame CRC-16 verification.
Bits-per-sample up to 26.
"""

from __future__ import annotations

import numpy as np

_FIXED_COEF = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))
# Hostile-input bound on decoded samples.
MAX_STREAM_SAMPLES = 1 << 28
_RATE_CODES = (0, 88200, 176400, 192000, 8000, 16000, 22050, 24000, 32000,
               44100, 48000, 96000)
_SIZE_CODES = (0, 8, 12, -1, 16, 20, 24, 32)


class FlacError(ValueError):
    pass


class _Reader:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0   # byte index
        self.bit = 0   # bits consumed of data[pos]

    def bits(self, n: int) -> int:
        v = 0
        while n > 0:
            if self.pos >= len(self.data):
                raise FlacError("truncated stream")
            avail = 8 - self.bit
            take = n if n < avail else avail
            v = (v << take) | (
                (self.data[self.pos] >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            n -= take
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def signed(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.bits(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def unary(self) -> int:
        q = 0
        while True:
            if self.pos >= len(self.data):
                raise FlacError("truncated stream")
            b = (self.data[self.pos] >> (7 - self.bit)) & 1
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
            if b:
                return q
            q += 1

    def align(self) -> None:
        if self.bit:
            self.bit = 0
            self.pos += 1


def _crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _coded_number(r: _Reader) -> int:
    b0 = r.bits(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    for mask, lead in ((0xE0, 0xC0), (0xF0, 0xE0), (0xF8, 0xF0),
                       (0xFC, 0xF8), (0xFE, 0xFC), (0xFF, 0xFE)):
        n_extra += 1
        if (b0 & mask) == lead:
            v = b0 & (0xFF >> (n_extra + 2)) if n_extra < 6 else 0
            break
    else:
        raise FlacError("bad coded number")
    for _ in range(n_extra):
        b = r.bits(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("bad coded-number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _residual(r: _Reader, order: int, blocksize: int, out: list) -> None:
    method = r.bits(2)
    if method > 1:
        raise FlacError("reserved residual method")
    po = r.bits(4)
    parts = 1 << po
    if blocksize % parts:
        raise FlacError("partition order does not divide block size")
    per_part = blocksize >> po
    param_bits, escape = (4, 15) if method == 0 else (5, 31)
    idx = order
    for p in range(parts):
        n = per_part - (order if p == 0 else 0)
        if n < 0:
            raise FlacError("bad first partition")
        param = r.bits(param_bits)
        if param == escape:
            rbits = r.bits(5)
            for _ in range(n):
                out[idx] = r.signed(rbits)
                idx += 1
        else:
            for _ in range(n):
                q = r.unary()
                u = (q << param) | r.bits(param)
                out[idx] = (u >> 1) ^ -(u & 1)
                idx += 1


def _subframe(r: _Reader, bps: int, blocksize: int) -> list:
    if r.bits(1):
        raise FlacError("bad subframe padding bit")
    kind = r.bits(6)
    wasted = 0
    if r.bits(1):
        wasted = r.unary() + 1
    bps -= wasted
    if bps <= 0:
        raise FlacError("wasted bits exceed sample size")
    out = [0] * blocksize

    if kind == 0:  # CONSTANT
        out = [r.signed(bps)] * blocksize
    elif kind == 1:  # VERBATIM
        out = [r.signed(bps) for _ in range(blocksize)]
    elif 8 <= kind <= 12:  # FIXED
        order = kind & 7
        if order > blocksize:
            raise FlacError("predictor order exceeds block size")
        for i in range(order):
            out[i] = r.signed(bps)
        _residual(r, order, blocksize, out)
        coef = _FIXED_COEF[order]
        for i in range(order, blocksize):
            out[i] += sum(c * out[i - 1 - j] for j, c in enumerate(coef))
    elif kind >= 32:  # LPC
        order = (kind & 31) + 1
        if order > blocksize:
            raise FlacError("predictor order exceeds block size")
        for i in range(order):
            out[i] = r.signed(bps)
        precision = r.bits(4) + 1
        if precision == 16:
            raise FlacError("invalid LPC precision")
        shift = r.signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coef = [r.signed(precision) for _ in range(order)]
        _residual(r, order, blocksize, out)
        for i in range(order, blocksize):
            out[i] += sum(c * out[i - 1 - j]
                          for j, c in enumerate(coef)) >> shift
    else:
        raise FlacError("reserved subframe type")
    if wasted:
        out = [v << wasted for v in out]
    return out


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """FLAC bytes -> (mono float32 in [-1, 1], sample_rate)."""
    if len(data) < 42 or data[:4] != b"fLaC":
        raise FlacError("not a FLAC file")
    pos = 4
    sample_rate = channels = bps = 0
    total = 0
    have_si = last = False
    while not last and pos + 4 <= len(data):
        last = bool(data[pos] & 0x80)
        block_type = data[pos] & 0x7F
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        pos += 4
        if pos + length > len(data):
            raise FlacError("truncated metadata block")
        if block_type == 0 and length >= 34:
            s = data[pos: pos + 34]
            sample_rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4)
            channels = ((s[12] >> 1) & 0x7) + 1
            bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1
            total = int.from_bytes(s[13:18], "big") & ((1 << 36) - 1)
            have_si = True
        pos += length
    if not have_si or not (1 <= channels <= 8) or sample_rate <= 0:
        raise FlacError("missing/bad STREAMINFO")
    if bps > 26:
        raise FlacError("unsupported bits-per-sample")

    r = _Reader(data)
    r.pos = pos
    scale = np.float64(1.0 / (1 << (bps - 1)) / channels)
    chunks = []
    decoded = 0
    while (total == 0 or decoded < total) and r.pos + 2 <= len(data):
        # Hostile-input cap: a
        # crafted stream of tiny CONSTANT frames with 65536-sample blocks
        # would otherwise amplify a few KB of input into multi-GB output.
        if decoded > MAX_STREAM_SAMPLES:
            raise FlacError("stream length cap exceeded")
        frame_start = r.pos
        if r.bits(14) != 0x3FFE:
            if total == 0 and all(
                    b == 0 for b in data[frame_start:]):
                break  # trailing padding
            raise FlacError("lost frame sync")
        r.bits(2)  # reserved + blocking strategy
        bs_code = r.bits(4)
        sr_code = r.bits(4)
        ch_code = r.bits(4)
        ss_code = r.bits(3)
        r.bits(1)
        _coded_number(r)
        if bs_code == 0:
            raise FlacError("reserved block size code")
        if bs_code == 1:
            blocksize = 192
        elif bs_code == 6:
            blocksize = r.bits(8) + 1
        elif bs_code == 7:
            blocksize = r.bits(16) + 1
        elif bs_code < 6:
            blocksize = 576 << (bs_code - 2)
        else:
            blocksize = 256 << (bs_code - 8)
        if sr_code == 15:
            raise FlacError("invalid sample-rate code")
        frame_sr = sample_rate
        if 1 <= sr_code <= 11:
            frame_sr = _RATE_CODES[sr_code]
        elif sr_code == 12:
            frame_sr = r.bits(8) * 1000
        elif sr_code == 13:
            frame_sr = r.bits(16)
        elif sr_code == 14:
            frame_sr = r.bits(16) * 10
        if frame_sr != sample_rate:
            raise FlacError("frame/stream sample-rate mismatch")
        if ss_code and _SIZE_CODES[ss_code] != bps:
            raise FlacError("frame/stream sample-size mismatch")
        if ch_code <= 7:
            mode, frame_channels = 0, ch_code + 1
        elif ch_code <= 10:
            mode, frame_channels = ch_code - 7, 2
        else:
            raise FlacError("reserved channel assignment")
        if frame_channels != channels:
            raise FlacError("frame/stream channel mismatch")
        expect = r.bits(8)
        if _crc8(data[frame_start: r.pos - 1]) != expect:
            raise FlacError("frame header CRC-8 mismatch")

        ch = []
        for c in range(channels):
            sub_bps = bps + (1 if (mode, c) in ((1, 1), (2, 0), (3, 1))
                             else 0)
            ch.append(_subframe(r, sub_bps, blocksize))
        r.align()
        crc_end = r.pos
        if _crc16(data[frame_start: crc_end]) != r.bits(16):
            raise FlacError("frame CRC-16 mismatch")

        a = np.array(ch, dtype=np.int64)
        if mode == 1:    # left/side
            a[1] = a[0] - a[1]
        elif mode == 2:  # right/side (stored side, right)
            a[0] = a[1] + a[0]
        elif mode == 3:  # mid/side
            side = a[1]
            m2 = (a[0] << 1) | (side & 1)
            a = np.stack([(m2 + side) >> 1, (m2 - side) >> 1])
        mono = (a.sum(axis=0) * scale).astype(np.float32)
        if total and decoded + blocksize > total:
            mono = mono[: total - decoded]
        chunks.append(mono)
        decoded += len(mono)
    if total and decoded < total:
        raise FlacError("stream ended before total_samples")
    wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return wav, sample_rate


def load_flac(path: str, sample_rate: int) -> np.ndarray:
    """Load a .flac as mono float32 at ``sample_rate`` (resampled)."""
    with open(path, "rb") as f:
        wav, sr = decode_flac(f.read())
    if sample_rate and sr != sample_rate:
        from fractions import Fraction

        from scipy.signal import resample_poly

        ratio = Fraction(sample_rate, sr).limit_denominator(1000)
        wav = resample_poly(wav, ratio.numerator,
                            ratio.denominator).astype(np.float32)
    return wav
