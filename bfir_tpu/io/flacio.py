"""Pure-python FLAC codec (subset): decoder for impulse-file loading and a
minimal encoder (fixed predictors + rice) for writing/tests.

The reference loads impulse responses through libsndfile, which accepts any
format it was built with — including FLAC (/root/reference/brutefir/
buffer.cpp:37-139 simply calls sf_wchar_open on whatever path it is given).
Round 1 of this repo was WAV-only; this module
closes the gap natively: no external binaries, numpy-assisted bit twiddling.

Decoder coverage: STREAMINFO parsing, fixed + variable blocking, all
block-size/rate/sample-size codes, channel assignments independent /
left-side / right-side / mid-side, subframe types CONSTANT / VERBATIM /
FIXED(0-4) / LPC(1-32), wasted bits, rice + rice2 residual partitions with
escape codes, frame CRC-16 verification and whole-stream MD5 verification
against STREAMINFO (so a decoder bug cannot pass silently).

Encoder: fixed-order 0-2 predictors, single rice partition, constant and
verbatim fallbacks — valid, verifiable FLAC (checked by the decoder's MD5
gate), modest compression. 8/16/24-bit PCM.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# CRCs (FLAC frame integrity)
# ---------------------------------------------------------------------------


def _make_crc8_table():
    t = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        t.append(c)
    return t


def _make_crc16_table():
    t = []
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        t.append(c)
    return t


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Bit IO
# ---------------------------------------------------------------------------


class BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.byte = pos_bytes
        self.bit = 0  # bits already consumed in current byte (0..7)

    def tell_bytes(self) -> int:
        return self.byte

    def aligned(self) -> bool:
        return self.bit == 0

    def align(self) -> None:
        if self.bit:
            self.byte += 1
            self.bit = 0

    def read(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        v = 0
        byte, bit, data = self.byte, self.bit, self.data
        while n > 0:
            avail = 8 - bit
            take = min(avail, n)
            cur = data[byte]
            v = (v << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            bit += take
            n -= take
            if bit == 8:
                byte += 1
                bit = 0
        self.byte, self.bit = byte, bit
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count 0 bits until (and consuming) the terminating 1 bit."""
        q = 0
        byte, bit, data = self.byte, self.bit, self.data
        while True:
            cur = data[byte] & ((1 << (8 - bit)) - 1)  # mask consumed high bits
            if cur == 0:
                q += 8 - bit
                byte += 1
                bit = 0
                continue
            top = cur.bit_length()  # position of highest set bit (1..8-bit)
            zeros = (8 - bit) - top
            q += zeros
            bit += zeros + 1
            if bit == 8:
                byte += 1
                bit = 0
            self.byte, self.bit = byte, bit
            return q

    def read_utf8_number(self) -> int:
        """FLAC's UTF-8-style coded number (frame/sample index, up to 7 bytes)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x80
        while b0 & mask:
            n += 1
            mask >>= 1
        v = b0 & (mask - 1)
        for _ in range(n - 1):
            v = (v << 6) | (self.read(8) & 0x3F)
        return v


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int) -> None:
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, v: int, n: int) -> None:
        self.write(v & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def write_utf8_number(self, v: int) -> None:
        if v < 0x80:
            self.write(v, 8)
            return
        # count payload bits -> bytes needed
        for nbytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
            if v < (1 << bits):
                break
        lead = (0xFF << (8 - nbytes)) & 0xFF
        shift = 6 * (nbytes - 1)
        self.write(lead | ((v >> shift) & ((1 << (7 - nbytes)) - 1)), 8)
        for i in range(nbytes - 2, -1, -1):
            self.write(0x80 | ((v >> (6 * i)) & 0x3F), 8)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCKSIZE_TABLE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
_RATE_TABLE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLESIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class FlacError(ValueError):
    pass


class StreamInfo:
    def __init__(self, rate, channels, bps, total_samples, md5):
        self.rate = rate
        self.channels = channels
        self.bps = bps
        self.total_samples = total_samples
        self.md5 = md5


def _parse_metadata(data: bytes) -> Tuple[StreamInfo, int]:
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    info = None
    while True:
        hdr = data[pos : pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        length = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = BitReader(body)
            br.read(16)  # min blocksize
            br.read(16)  # max blocksize
            br.read(24)  # min framesize
            br.read(24)  # max framesize
            rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            md5 = body[18:34]
            info = StreamInfo(rate, channels, bps, total, md5)
        pos += 4 + length
        if last:
            break
    if info is None:
        raise FlacError("FLAC stream has no STREAMINFO")
    return info, pos


def _decode_residual(br: BitReader, blocksize: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual coding method {method}")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    po = br.read(4)
    nparts = 1 << po
    if blocksize % nparts:
        raise FlacError("partition order does not divide block size")
    res: List[int] = []
    for part in range(nparts):
        n = (blocksize >> po) - (order if part == 0 else 0)
        k = br.read(pbits)
        if k == escape:
            raw = br.read(5)
            if raw:
                res.extend(br.read_signed(raw) for _ in range(n))
            else:
                res.extend([0] * n)
        else:
            for _ in range(n):
                q = br.read_unary()
                v = (q << k) | br.read(k) if k else q
                res.append((v >> 1) ^ -(v & 1))  # zigzag
    return res


def _decode_subframe(br: BitReader, blocksize: int, bps: int) -> List[int]:
    if br.read(1):
        raise FlacError("subframe sync error (padding bit set)")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted
    if stype == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = [v] * blocksize
    elif stype == 1:  # VERBATIM
        out = [br.read_signed(bps) for _ in range(blocksize)]
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        out = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        coef = _FIXED_COEFFS[order]
        for r in res:
            pred = sum(c * out[-1 - i] for i, c in enumerate(coef))
            out.append(pred + r)
    elif stype >= 32:  # LPC
        order = (stype & 31) + 1
        out = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise FlacError("invalid LPC precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        for r in res:
            pred = sum(c * out[-1 - i] for i, c in enumerate(coefs)) >> shift
            out.append(pred + r)
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        out = [v << wasted for v in out]
    return out


def _decode_frame(data: bytes, pos: int, info: StreamInfo):
    br = BitReader(data, pos)
    sync = br.read(14)
    if sync != 0x3FFE:
        raise FlacError(f"bad frame sync at byte {pos}")
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    rate_code = br.read(4)
    chan_code = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    br.read_utf8_number()
    if bs_code == 0:
        raise FlacError("reserved block size code 0")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCKSIZE_TABLE[bs_code]
    if rate_code == 12:
        br.read(8)
    elif rate_code in (13, 14):
        br.read(16)
    elif rate_code == 15:
        raise FlacError("invalid sample rate code")
    bps = info.bps if ss_code == 0 else _SAMPLESIZE_TABLE[ss_code]
    # CRC-8 over the header bytes
    hdr_end = br.tell_bytes() + (1 if not br.aligned() else 0)
    if crc8(data[pos:hdr_end]) != data[hdr_end]:
        raise FlacError(f"frame header CRC-8 mismatch at byte {pos}")
    br = BitReader(data, hdr_end + 1)

    if chan_code <= 7:
        nch = chan_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
    elif chan_code == 8:  # left/side
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [left, [l - s for l, s in zip(left, side)]]
    elif chan_code == 9:  # right/side
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        chans = [[s + r for s, r in zip(side, right)], right]
    elif chan_code == 10:  # mid/side
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [[]] * 2
        l = []
        r = []
        for m, s in zip(mid, side):
            m2 = (m << 1) | (s & 1)
            l.append((m2 + s) >> 1)
            r.append((m2 - s) >> 1)
        chans = [l, r]
    else:
        raise FlacError(f"reserved channel assignment {chan_code}")
    br.align()
    end = br.tell_bytes()
    if crc16(data[pos:end]) != int.from_bytes(data[end : end + 2], "big"):
        raise FlacError(f"frame CRC-16 mismatch at byte {pos}")
    return chans, end + 2, bps


def _md5_of_samples(arr: np.ndarray, bps: int) -> bytes:
    """MD5 of interleaved signed little-endian samples, ceil(bps/8) bytes
    each (the STREAMINFO convention). arr: [frames, channels] int."""
    nbytes = (bps + 7) // 8
    a = arr.astype("<i4").tobytes()
    buf = np.frombuffer(a, dtype=np.uint8).reshape(-1, 4)[:, :nbytes].tobytes()
    return hashlib.md5(buf).digest()


def read_flac(path: str, verify_md5: bool = True):
    """Decode a FLAC file -> (audio float64 [frames, channels] in [-1, 1),
    sample_rate). Raises FlacError on malformed input or CRC/MD5 mismatch."""
    data = open(path, "rb").read()
    info, pos = _parse_metadata(data)
    per_chan: List[List[int]] = [[] for _ in range(info.channels)]
    got = 0
    while pos < len(data) and (info.total_samples == 0 or got < info.total_samples):
        chans, pos, _ = _decode_frame(data, pos, info)
        for c in range(info.channels):
            per_chan[c].extend(chans[c])
        got += len(chans[0])
    arr = np.stack([np.asarray(c, dtype=np.int64) for c in per_chan], axis=1)
    if info.total_samples:
        arr = arr[: info.total_samples]
    if verify_md5 and info.md5 != b"\x00" * 16:
        if _md5_of_samples(arr, info.bps) != info.md5:
            raise FlacError("decoded audio MD5 mismatch (corrupt file or decoder bug)")
    scale = float(1 << (info.bps - 1))
    return arr.astype(np.float64) / scale, info.rate


def read_flac_info(path: str) -> StreamInfo:
    with open(path, "rb") as f:
        head = f.read(65536)
    info, _ = _parse_metadata(head)
    return info


# ---------------------------------------------------------------------------
# Encoder (fixed predictors + single rice partition)
# ---------------------------------------------------------------------------


def _best_fixed_order(x: np.ndarray, max_order: int = 2) -> int:
    best, best_cost = 0, None
    d = x.astype(np.int64)
    for order in range(max_order + 1):
        cost = np.abs(d).sum()
        if best_cost is None or cost < best_cost:
            best, best_cost = order, cost
        d = np.diff(d)
        if d.size == 0:
            break
    return best


def _rice_param(res: np.ndarray) -> int:
    if res.size == 0:
        return 0
    mean = max(float(np.abs(res).mean()), 0.1)
    k = max(0, int(np.ceil(np.log2(mean + 1))))
    return min(k, 14)


def _write_residual(bw: BitWriter, res: np.ndarray) -> None:
    bw.write(0, 2)  # rice method 1 (4-bit params)
    bw.write(0, 4)  # partition order 0
    k = _rice_param(res)
    bw.write(k, 4)
    for v in res:
        u = (int(v) << 1) ^ (int(v) >> 63)  # zigzag (arbitrary-width python int)
        bw.write_unary(u >> k)
        if k:
            bw.write(u & ((1 << k) - 1), k)


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int) -> None:
    xi = x.astype(np.int64)
    if np.all(xi == xi[0]):
        bw.write(0, 1)
        bw.write(0, 6)  # CONSTANT
        bw.write(0, 1)
        bw.write_signed(int(xi[0]), bps)
        return
    order = _best_fixed_order(xi)
    res = xi.copy()
    for _ in range(order):
        res = np.diff(res)
    # verbatim fallback when rice would expand
    k = _rice_param(res)
    rice_bits = res.size * (k + 2) + int((np.abs(res) >> max(k, 0)).sum()) * 2
    if rice_bits > xi.size * bps:
        bw.write(0, 1)
        bw.write(1, 6)  # VERBATIM
        bw.write(0, 1)
        for v in xi:
            bw.write_signed(int(v), bps)
        return
    bw.write(0, 1)
    bw.write(8 + order, 6)  # FIXED
    bw.write(0, 1)
    for v in xi[:order]:
        bw.write_signed(int(v), bps)
    _write_residual(bw, res)


def write_flac(path: str, audio: np.ndarray, sample_rate: int, bps: int = 16,
               block_size: int = 4096) -> None:
    """Encode float audio [frames, channels] in [-1, 1] (or int samples if an
    integer dtype) to FLAC at ``bps`` bits (8/16/24)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    if np.issubdtype(audio.dtype, np.floating):
        scale = float(1 << (bps - 1))
        xi = np.clip(np.rint(audio * scale), -scale, scale - 1).astype(np.int64)
    else:
        xi = audio.astype(np.int64)
    frames, channels = xi.shape
    if channels > 8:
        raise FlacError("FLAC supports at most 8 channels")

    out = bytearray(b"fLaC")
    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(frames, 36)
    body = si.getvalue() + _md5_of_samples(xi, bps)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frame_no = 0
    for start in range(0, frames, block_size):
        blk = xi[start : start + block_size]
        n = blk.shape[0]
        bw = BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocking
        bw.write(7, 4)  # block size: 16-bit at end of header
        bw.write(0, 4)  # rate: from STREAMINFO
        bw.write(channels - 1, 4)
        bw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps], 3)
        bw.write(0, 1)
        bw.write_utf8_number(frame_no)
        bw.write(n - 1, 16)
        bw.align()
        hdr = bw.getvalue()
        hdr += bytes([crc8(hdr)])
        bw = BitWriter()
        for c in range(channels):
            _encode_subframe(bw, blk[:, c], bps)
        bw.align()
        frame = hdr + bw.getvalue()
        frame += crc16(frame).to_bytes(2, "big")
        out += frame
        frame_no += 1
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)
