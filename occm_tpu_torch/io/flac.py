"""FLAC decode (pure Python) + test encoder.

The port's own copy of `occm_tpu/io/flac.py`, unchanged in behaviour. It
is the decoder of last resort: `io.wav.load_audio` and the serving
front-end take the native C++ decoder (`io.native`: native/flacdec.cpp,
whole-file, ranged and streamed through `FlacStream`) where the library
is available, and this one where it is not; the two agree bit for bit.
The encoder writes the test fixtures.

Decoder coverage: 8/12/16/20/24-bit, 1-8 channels, all subframe types
(CONSTANT, VERBATIM, FIXED 0-4, LPC 1-32), rice/rice2 residual partitions
with escape codes, left/right/mid-side decorrelation, wasted bits, UTF-8
frame numbers, CRC-8/CRC-16 verification.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}

_SAMPLE_RATES = {0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000,
                 5: 16000, 6: 22050, 7: 24000, 8: 32000, 9: 44100,
                 10: 48000, 11: 96000}

_SAMPLE_SIZES = {0: None, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def tell_byte(self) -> int:
        return self.byte

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1

    def read(self, n: int) -> int:
        out = 0
        while n > 0:
            avail = 8 - self.bit
            take = min(n, avail)
            cur = self.data[self.byte]
            out = (out << take) | (
                (cur >> (avail - take)) & ((1 << take) - 1)
            )
            self.bit += take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
            n -= take
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def read_utf8(self) -> int:
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


def _read_residual(br: _BitReader, block_size: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    out: List[int] = []
    n_parts = 1 << po
    part_len = block_size >> po
    for p in range(n_parts):
        count = part_len - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            bits = br.read(5)
            for _ in range(count):
                out.append(br.read_signed(bits) if bits else 0)
        else:
            for _ in range(count):
                q = br.read_unary()
                r = br.read(param) if param else 0
                v = (q << param) | r
                out.append((v >> 1) ^ -(v & 1))
    return out


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    sftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sftype == 0:  # CONSTANT
        v = br.read_signed(bps)
        x = np.full(block_size, v, dtype=np.int64)
    elif sftype == 1:  # VERBATIM
        x = np.array([br.read_signed(bps) for _ in range(block_size)],
                     dtype=np.int64)
    elif 8 <= sftype <= 12:  # FIXED
        order = sftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _read_residual(br, block_size, order)
        x = np.empty(block_size, dtype=np.int64)
        x[:order] = warm
        coeffs = FIXED_COEFFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * x[i - 1 - j]
            x[i] = res[i - order] + pred
    elif sftype >= 32:  # LPC
        order = sftype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid qlp precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _read_residual(br, block_size, order)
        x = np.empty(block_size, dtype=np.int64)
        x[:order] = warm
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coefs[j] * x[i - 1 - j]
            x[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {sftype}")

    if wasted:
        x = x << wasted
    return x


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream. Returns (samples [n, channels] int32, sr, bps)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sr = channels = bps = None
    total = None
    # metadata blocks
    while True:
        hdr = data[pos]
        btype = hdr & 0x7F
        last = hdr & 0x80
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        body = data[pos + 4: pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)
            br.read(24)
            sr = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + length
        if last:
            break
    if sr is None:
        raise ValueError("missing STREAMINFO")

    chans: List[List[np.ndarray]] = [[] for _ in range(channels)]
    n_decoded = 0
    while pos < len(data) and (total is None or n_decoded < total or total == 0):
        if pos + 2 > len(data):
            break
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0x3FFE:
            break
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8()
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        hdr_end = br.tell_byte() + (1 if br.bit else 0)
        crc8 = br.read(8)
        if _crc8(data[pos:hdr_end]) != crc8:
            raise ValueError("frame header CRC mismatch")

        frame_bps = _SAMPLE_SIZES[ss_code] or bps

        if ch_code < 8:
            n_ch = ch_code + 1
            sub = []
            for c in range(n_ch):
                sub.append(_decode_subframe(br, block_size, frame_bps))
            outs = sub
        else:
            # stereo decorrelation; side channel carries one extra bit
            if ch_code == 8:    # left/side
                left = _decode_subframe(br, block_size, frame_bps)
                side = _decode_subframe(br, block_size, frame_bps + 1)
                outs = [left, left - side]
            elif ch_code == 9:  # right/side
                side = _decode_subframe(br, block_size, frame_bps + 1)
                right = _decode_subframe(br, block_size, frame_bps)
                outs = [side + right, right]
            elif ch_code == 10:  # mid/side
                mid = _decode_subframe(br, block_size, frame_bps)
                side = _decode_subframe(br, block_size, frame_bps + 1)
                m2 = (mid << 1) | (side & 1)
                outs = [(m2 + side) >> 1, (m2 - side) >> 1]
            else:
                raise ValueError("reserved channel assignment")
            n_ch = 2
        br.align()
        crc16 = br.read(16)
        frame_end = br.tell_byte()
        if _crc16(data[pos:frame_end - 2]) != crc16:
            raise ValueError("frame CRC16 mismatch")
        pos = frame_end

        for c in range(n_ch):
            chans[c].append(outs[c])
        n_decoded += block_size

    arrays = [np.concatenate(c) if c else np.zeros(0, np.int64)
              for c in chans]
    n = min(a.shape[0] for a in arrays)
    if total:
        n = min(n, total)
    out = np.stack([a[:n] for a in arrays], axis=1).astype(np.int32)
    return out, sr, bps


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode FLAC to float32 mono in [-1, 1] (librosa semantics)."""
    with open(path, "rb") as f:
        samples, sr, bps = decode_flac(f.read())
    x = samples.astype(np.float32) / float(1 << (bps - 1))
    if x.shape[1] > 1:
        x = x.mean(axis=1)
    else:
        x = x[:, 0]
    return np.ascontiguousarray(x), sr


# --------------------------------------------------------------- encoder
# Minimal encoder for test vectors / tooling: 16-bit, fixed 4096 blocking,
# constant / verbatim / fixed-order subframes with single-partition rice.

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        for _ in range(q):
            self.write(0, 1)
        self.write(1, 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_coded(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    nbytes = 2
    while bits > (7 - nbytes) + 6 * (nbytes - 1):
        nbytes += 1
    prefix = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(prefix | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _best_rice_param(res: List[int], plen: int) -> int:
    best, best_bits = 0, None
    for p in range(min(30, (1 << plen) - 1)):
        bits = 0
        for r in res:
            z = (abs(r) << 1) - (1 if r < 0 else 0)
            bits += (z >> p) + 1 + p
            if bits > 1 << 30:
                break
        if best_bits is None or bits < best_bits:
            best, best_bits = p, bits
    return best


def encode_flac_mono16(x: np.ndarray, sr: int, block_size: int = 4096,
                       subframe: str = "fixed2", seek_every: int = 0) -> bytes:
    """Encode int16 mono to FLAC (test vectors; not a production encoder).

    subframe: constant-aware; 'verbatim', 'fixed0'..'fixed4'.
    seek_every: if > 0, write a SEEKTABLE metadata block with a point at
    every Nth frame (spec 18-byte entries: sample, byte offset relative to
    the first frame, frame sample count).
    """
    x = np.asarray(x, np.int64)
    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(0, 3)       # channels-1
    si.write(15, 5)      # bps-1
    si.write(len(x) & ((1 << 36) - 1), 36)
    si.align()
    body = si.bytes() + b"\x00" * 16  # md5 zeros

    frames: list = []  # (start_sample, n_samples, frame_bytes)
    sample_pos = 0
    frame_idx = 0
    for start in range(0, len(x), block_size):
        blk = x[start: start + block_size]
        n = len(blk)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)          # fixed blocking
        bs_code = 7             # explicit 16-bit block size
        bw.write(bs_code, 4)
        sr_code = {8000: 4, 16000: 5, 44100: 9, 48000: 10}.get(sr, 13)
        bw.write(sr_code, 4)
        bw.write(0, 4)          # 1 channel
        bw.write(4, 3)          # 16 bps
        bw.write(0, 1)
        for b in _utf8_coded(frame_idx):
            bw.write(b, 8)
        bw.write(n - 1, 16)
        if sr_code == 13:
            bw.write(sr, 16)
        bw.align()
        hdr = bw.bytes()
        hdr += bytes([_crc8(hdr)])

        sw = _BitWriter()
        if subframe == "constant" or (np.all(blk == blk[0]) and n > 0):
            sw.write(0, 1)
            sw.write(0, 6)
            sw.write(0, 1)
            sw.write_signed(int(blk[0]), 16)
        elif subframe == "verbatim":
            sw.write(0, 1)
            sw.write(1, 6)
            sw.write(0, 1)
            for v in blk:
                sw.write_signed(int(v), 16)
        else:
            order = int(subframe[-1])
            order = min(order, n)
            sw.write(0, 1)
            sw.write(8 + order, 6)
            sw.write(0, 1)
            for v in blk[:order]:
                sw.write_signed(int(v), 16)
            coeffs = FIXED_COEFFS[order]
            res = []
            for i in range(order, n):
                pred = sum(c * int(blk[i - 1 - j])
                           for j, c in enumerate(coeffs))
                res.append(int(blk[i]) - pred)
            sw.write(0, 2)   # rice 4-bit
            sw.write(0, 4)   # partition order 0
            param = _best_rice_param(res, 4) if res else 0
            if param >= 15:
                param = 14
            sw.write(param, 4)
            for r in res:
                z = (abs(r) << 1) - (1 if r < 0 else 0)
                sw.write_unary(z >> param)
                if param:
                    sw.write(z & ((1 << param) - 1), param)
        sw.align()
        frame = hdr + sw.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        frames.append((sample_pos, n, frame))
        sample_pos += n
        frame_idx += 1

    meta = [(0, body)]
    if seek_every > 0:
        st = bytearray()
        offset = 0
        for i, (spos, n, fr) in enumerate(frames):
            if i % seek_every == 0:
                st += spos.to_bytes(8, "big")
                st += offset.to_bytes(8, "big")
                st += n.to_bytes(2, "big")
            offset += len(fr)
        meta.append((3, bytes(st)))
    for i, (btype, b) in enumerate(meta):
        last = 0x80 if i == len(meta) - 1 else 0x00
        out += bytes([last | btype]) + len(b).to_bytes(3, "big") + b
    for _, _, fr in frames:
        out += fr
    return bytes(out)


_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
_STEREO_CODES = {"left_side": 8, "right_side": 9, "mid_side": 10}


def _signed_bits(vals) -> int:
    """Smallest n with every v in [-2^(n-1), 2^(n-1))."""
    n = 1
    for v in vals:
        need = (int(v).bit_length() + 1) if v >= 0 \
            else ((-int(v) - 1).bit_length() + 1)
        n = max(n, need)
    return n


def _encode_subframe_bits(sw: "_BitWriter", blk: np.ndarray, bps: int,
                          kind: str, rice_method: int, po: int,
                          force_escape: bool, wasted: int,
                          lpc_precision: int, lpc_shift: int) -> None:
    """One subframe, full spec surface: CONSTANT/VERBATIM/FIXED/LPC,
    rice/rice2 partitions, escape partitions, wasted bits."""
    n = len(blk)
    if wasted:
        assert not np.any(blk & ((1 << wasted) - 1)), \
            "wasted bits declared but low bits are not zero"
        blk = blk >> wasted
        bps -= wasted
    if kind == "constant":
        assert n and np.all(blk == blk[0])
    if kind.startswith("fixed"):
        order = min(int(kind[-1]), n)
    elif kind.startswith("lpc"):
        order = min(int(kind[3:]), max(n, 1))
    else:
        order = 0

    sw.write(0, 1)
    if kind == "constant":
        sw.write(0, 6)
    elif kind == "verbatim":
        sw.write(1, 6)
    elif kind.startswith("fixed"):
        sw.write(8 + order, 6)
    else:
        sw.write(31 + order, 6)
    if wasted:
        sw.write(1, 1)
        sw.write_unary(wasted - 1)
    else:
        sw.write(0, 1)

    if kind == "constant":
        sw.write_signed(int(blk[0]), bps)
        return
    if kind == "verbatim":
        for v in blk:
            sw.write_signed(int(v), bps)
        return

    for v in blk[:order]:
        sw.write_signed(int(v), bps)
    if kind.startswith("fixed"):
        coeffs = FIXED_COEFFS[order]
        shift = 0
    else:
        # LPC mirroring the fixed-order predictor at the given shift
        # (coefs within the precision range; residuals stay small)
        base = list(FIXED_COEFFS[min(order, 4)]) + [0] * max(0, order - 4)
        coeffs = tuple(c << lpc_shift for c in base[:order])
        shift = lpc_shift
        lim = 1 << (lpc_precision - 1)
        assert all(-lim <= c < lim for c in coeffs), (coeffs, lpc_precision)
        sw.write(lpc_precision - 1, 4)
        sw.write_signed(shift, 5)
        for c in coeffs:
            sw.write_signed(c, lpc_precision)
    res = []
    for i in range(order, n):
        acc = sum(c * int(blk[i - 1 - j]) for j, c in enumerate(coeffs))
        res.append(int(blk[i]) - (acc >> shift))

    plen = 4 if rice_method == 0 else 5
    escape = (1 << plen) - 1
    po_eff = po
    while po_eff and (n % (1 << po_eff) or (n >> po_eff) < max(order, 1)):
        po_eff -= 1  # tail frames fall back to coarser partitions
    sw.write(rice_method, 2)
    sw.write(po_eff, 4)
    part_len = n >> po_eff
    pos = 0
    for p in range(1 << po_eff):
        count = part_len - (order if p == 0 else 0)
        part = res[pos: pos + count]
        pos += count
        if force_escape:
            bits = _signed_bits(part) if part else 0
            assert bits <= 31, "residuals exceed the 5-bit escape width"
            sw.write(escape, plen)
            sw.write(bits, 5)
            if bits:
                for r in part:
                    sw.write_signed(r, bits)
        else:
            param = min(_best_rice_param(part, plen) if part else 0,
                        escape - 1)
            sw.write(param, plen)
            for r in part:
                z = (abs(r) << 1) - (1 if r < 0 else 0)
                sw.write_unary(z >> param)
                if param:
                    sw.write(z & ((1 << param) - 1), param)


def encode_flac(x: np.ndarray, sr: int, bps: int = 16,
                block_size: int = 4096, subframe: str = "fixed2",
                stereo: str = "independent", rice_method: int = 0,
                partition_order: int = 0, force_escape: bool = False,
                wasted: int = 0, lpc_precision: int = 12,
                lpc_shift: int = 5) -> bytes:
    """Generalised FLAC encoder over the spec surface both decoders
    support (test vectors / the fuzz lane — not a production encoder):
    1-8 channels, bps in {8,12,16,20,24}, CONSTANT/VERBATIM/FIXED/LPC
    subframes, rice + rice2 residual partitions with escape partitions,
    left/right/mid-side stereo decorrelation, wasted bits.

    x: int samples [n] or [n, channels], values within bps (with `wasted`
    low zero bits when wasted > 0). stereo in {"independent",
    "left_side", "right_side", "mid_side"} (the latter three need 2ch).
    """
    x = np.asarray(x, np.int64)
    if x.ndim == 1:
        x = x[:, None]
    n_total, n_ch = x.shape
    assert bps in _BPS_CODES, f"bps {bps} unsupported"
    assert stereo == "independent" or n_ch == 2, stereo

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(n_ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n_total & ((1 << 36) - 1), 36)
    si.align()
    out += bytes([0x80]) + (len(si.bytes()) + 16).to_bytes(3, "big")
    out += si.bytes() + b"\x00" * 16  # md5 zeros

    for frame_idx, start in enumerate(range(0, n_total, block_size)):
        blk = x[start: start + block_size]
        n = len(blk)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)              # fixed blocking
        bw.write(7, 4)              # explicit 16-bit block size
        sr_code = {8000: 4, 16000: 5, 44100: 9, 48000: 10}.get(sr, 13)
        bw.write(sr_code, 4)
        ch_code = _STEREO_CODES.get(stereo, n_ch - 1)
        bw.write(ch_code, 4)
        bw.write(_BPS_CODES[bps], 3)
        bw.write(0, 1)
        for b in _utf8_coded(frame_idx):
            bw.write(b, 8)
        bw.write(n - 1, 16)
        if sr_code == 13:
            bw.write(sr, 16)
        bw.align()
        hdr = bw.bytes()
        hdr += bytes([_crc8(hdr)])

        if stereo == "independent":
            subs = [(blk[:, c], bps) for c in range(n_ch)]
        elif stereo == "left_side":
            subs = [(blk[:, 0], bps), (blk[:, 0] - blk[:, 1], bps + 1)]
        elif stereo == "right_side":
            subs = [(blk[:, 0] - blk[:, 1], bps + 1), (blk[:, 1], bps)]
        else:  # mid_side
            subs = [((blk[:, 0] + blk[:, 1]) >> 1, bps),
                    (blk[:, 0] - blk[:, 1], bps + 1)]

        sw = _BitWriter()
        for sub, sub_bps in subs:
            # a derived side/mid channel may not carry the caller's
            # wasted-low-zero-bits guarantee — declare wasted only where
            # the low bits really are zero
            w = wasted if (wasted and
                           not np.any(sub & ((1 << wasted) - 1))) else 0
            _encode_subframe_bits(
                sw, sub, sub_bps, subframe, rice_method, partition_order,
                force_escape, w, lpc_precision, lpc_shift,
            )
        sw.align()
        frame = hdr + sw.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
    return bytes(out)


def write_flac(path: str, x: np.ndarray, sr: int, **kwargs) -> None:
    """float32 [-1,1] mono -> 16-bit FLAC file (testing/tooling)."""
    pcm = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int64)
    with open(path, "wb") as f:
        f.write(encode_flac_mono16(pcm, sr, **kwargs))
