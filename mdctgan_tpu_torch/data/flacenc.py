"""Minimal pure-Python FLAC encoder (mono/stereo int16): the port's own
copy of ``mdctgan_tpu/data/flacenc.py``, which it may not import.

Dataset compression, as the reference's ``data/compress_audio.sh`` (an
ffmpeg wav->flac batch script) does, with no ffmpeg:

    python -m mdctgan_tpu_torch.data.flacenc DIR

converts every ``.wav`` under ``DIR`` to a ``.flac`` beside it, reading
through the port's ``data/native.py``.  FLAC is lossless, so a file decodes
back to its int16 samples bit for bit; the bytes are the JAX package's
encoder's for the same samples.

Emits CONSTANT / VERBATIM / FIXED(0-2) / LPC subframes with
single-partition Rice residuals, correct CRC-8/CRC-16 framing, and the
STREAMINFO MD5, under the fixed-blocksize strategy.  Format: RFC 9639.
"""

from __future__ import annotations

import hashlib
import os
import sys
from typing import Optional

import numpy as np


class BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a 1

    def align(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def bytes(self) -> bytes:
        assert self._nbits == 0, "unaligned"
        return bytes(self._buf)


def crc8(data: bytes) -> int:
    """CRC-8, poly x^8+x^2+x+1 (0x07), init 0 (frame-header CRC)."""
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def crc16(data: bytes) -> int:
    """CRC-16, poly x^16+x^15+x^2+1 (0x8005), init 0 (frame CRC)."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _coded_number(bw: BitWriter, n: int) -> None:
    """FLAC's UTF-8-style frame-number coding."""
    if n < 0x80:
        bw.write(n, 8)
        return
    # count payload bits
    for extra in range(1, 7):
        head_bits = 6 - extra  # payload bits in the first byte
        if n < (1 << (head_bits + 6 * extra)):
            prefix = (0xFF << (7 - extra)) & 0xFF  # extra+1 ones then 0
            bw.write(prefix | (n >> (6 * extra)), 8)
            for i in range(extra - 1, -1, -1):
                bw.write(0x80 | ((n >> (6 * i)) & 0x3F), 8)
            return
    raise ValueError("frame number too large")


def _zigzag(v: np.ndarray) -> np.ndarray:
    # int64 is ample: residuals of 17-bit side channels stay far below 2^62
    return np.where(v >= 0, v * 2, -v * 2 - 1).astype(np.int64)


def _write_residual(bw: BitWriter, res: np.ndarray) -> None:
    """Method 0 (4-bit Rice), partition order 0, one partition."""
    u = _zigzag(res.astype(np.int64))
    best_p, best_cost = 0, None
    for p in range(15):
        cost = int((u >> p).sum()) + len(u) * (p + 1)
        if best_cost is None or cost < best_cost:
            best_p, best_cost = p, cost
    bw.write(0, 2)       # residual method 0
    bw.write(0, 4)       # partition order 0
    bw.write(best_p, 4)  # rice parameter
    for x in u:
        x = int(x)
        bw.write_unary(x >> best_p)
        bw.write(x & ((1 << best_p) - 1), best_p)


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1]}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _write_subframe(bw: BitWriter, x: np.ndarray, bps: int,
                    force: Optional[str]) -> None:
    x = x.astype(np.int64)
    n = len(x)
    kind = force
    if kind is None:
        if np.all(x == x[0]):
            kind = "constant"
        elif n <= 4:
            kind = "verbatim"
        else:
            costs = {
                k: np.abs(_fixed_residual(x, k)).sum() for k in (0, 1, 2)
            }
            kind = f"fixed{min(costs, key=costs.get)}"

    if kind == "constant":
        bw.write(0, 1 + 6 + 1)  # pad, type 0, no wasted bits
        bw.write_signed(int(x[0]), bps)
    elif kind == "verbatim":
        bw.write(0b0_000001_0, 8)
        for v in x:
            bw.write_signed(int(v), bps)
    elif kind.startswith("fixed"):
        order = int(kind[5:])
        bw.write((0b001000 | order) << 1, 8)  # pad, type 8+order, no wasted
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        _write_residual(bw, _fixed_residual(x, order))
    elif kind == "lpc2":
        # LPC with the fixed order-2 predictor coefficients [2, -1], shift 0,
        # precision 4 — numerically identical residual to fixed order 2, but
        # exercises the LPC decode path.
        bw.write((0b100000 | 1) << 1, 8)  # pad, LPC order-1 = 1, no wasted
        for v in x[:2]:
            bw.write_signed(int(v), bps)
        bw.write(3, 4)   # precision - 1
        bw.write(0, 5)   # shift
        bw.write_signed(2, 4)
        bw.write_signed(-1, 4)
        _write_residual(bw, _fixed_residual(x, 2))
    else:
        raise ValueError(f"unknown subframe kind {kind!r}")


_STEREO_ASSIGN = {"independent": None, "left_side": 8, "right_side": 9,
                  "mid_side": 10}


def write_flac(
    path: str,
    samples: np.ndarray,
    sample_rate: int,
    block_size: int = 4096,
    stereo_mode: str = "independent",
    force_subframe: Optional[str] = None,
) -> None:
    """Encode int16 ``samples`` — shape (n,) or (n, channels<=2) — to FLAC."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        raise TypeError("samples must be int16")
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    if channels not in (1, 2):
        raise ValueError("mono or stereo only")
    if stereo_mode != "independent" and channels != 2:
        raise ValueError("stereo_mode requires 2 channels")
    bps = 16

    out = bytearray()
    out += b"fLaC"
    # STREAMINFO (type 0, last metadata block, 34 bytes)
    si = BitWriter()
    si.write(block_size, 16)  # min blocksize
    si.write(block_size, 16)  # max blocksize
    si.write(0, 24)           # min framesize unknown
    si.write(0, 24)           # max framesize unknown
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    md5 = hashlib.md5(samples.astype("<i2").tobytes()).digest()
    body = si.bytes() + md5
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    assign = _STEREO_ASSIGN[stereo_mode]
    for fi, start in enumerate(range(0, n, block_size)):
        block = samples[start : start + block_size]
        bs = len(block)
        bw = BitWriter()
        bw.write(0x3FFE, 14)  # sync
        bw.write(0, 1)        # reserved
        bw.write(0, 1)        # fixed-blocksize strategy
        bw.write(7, 4)        # blocksize: 16-bit value-1 follows
        bw.write(0, 4)        # sample rate: from STREAMINFO
        bw.write(assign if assign is not None else channels - 1, 4)
        bw.write(4, 3)        # sample size: 16-bit
        bw.write(0, 1)        # reserved
        _coded_number(bw, fi)
        bw.write(bs - 1, 16)
        header = bw.bytes()
        hdr_crc = crc8(header)

        fb = BitWriter()
        if assign is None:
            chans = [(block[:, c], bps) for c in range(channels)]
        else:
            left = block[:, 0].astype(np.int64)
            right = block[:, 1].astype(np.int64)
            side = left - right
            if assign == 8:      # left/side
                chans = [(left, bps), (side, bps + 1)]
            elif assign == 9:    # right/side (side first)
                chans = [(side, bps + 1), (right, bps)]
            else:                # mid/side
                mid = (left + right) >> 1
                chans = [(mid, bps), (side, bps + 1)]
        for data, ch_bps in chans:
            _write_subframe(fb, np.asarray(data), ch_bps, force_subframe)
        fb.align()
        frame = header + bytes([hdr_crc]) + fb.bytes()
        out += frame + crc16(frame).to_bytes(2, "big")

    with open(path, "wb") as f:
        f.write(out)


def compress_audio(root: str, remove_wav: bool = False) -> int:
    """Recursively convert .wav under ``root`` to .flac (the reference's
    data/compress_audio.sh, sans ffmpeg).  Returns the file count."""
    from mdctgan_tpu_torch.data import native

    count = 0
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if not name.lower().endswith(".wav"):
                continue
            src = os.path.join(dirpath, name)
            data, sr = native.read(src)
            pcm = np.clip(np.rint(np.asarray(data) * 32768.0), -32768, 32767)
            write_flac(os.path.splitext(src)[0] + ".flac",
                       pcm.astype(np.int16), sr)
            if remove_wav:
                os.remove(src)
            count += 1
    return count


if __name__ == "__main__":
    target = sys.argv[1] if len(sys.argv) > 1 else "."
    print(f"compressed {compress_audio(target)} wav files under {target}")
