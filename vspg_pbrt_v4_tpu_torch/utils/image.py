"""Image IO and the MSE metric, in numpy alone (this package's copy of the
JAX package's ``utils/image.py``).

EXR: scanline FLOAT/HALF images, written with ZIP compression (OpenEXR's
ImfZip scheme: byte reorder, delta predictor, zlib) or none, and read
back with NONE, ZIPS, ZIP or PIZ (ImfPizCompressor: bitmap and LUT,
canonical Huffman, 2D wavelet; decode only). PFM: colour or greyscale,
either byte order. QOI: 8-bit sRGB, written and read. PNG: 8-bit RGB
written sRGB-encoded through zlib, and 8-bit greyscale, RGB or RGBA
(non-interlaced) read back as linear RGB. ``read_image`` and
``write_image`` pick the format by extension. No imaging library is
needed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_EXR_MAGIC = 20000630
_ZIP_BLOCK = 16  # scanlines per ZIP chunk
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _zip_predict(raw):
    """OpenEXR ImfZip compress transform: split even/odd bytes into two
    halves, then delta-encode."""
    arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = arr[0::2]
    tmp[half:] = arr[1::2]
    d = tmp.astype(np.int16)
    d[1:] = d[1:] - tmp[:-1].astype(np.int16) + 384
    return d.astype(np.uint8).tobytes()


def _zip_unpredict(buf):
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    d[1:] -= 384
    s = (np.cumsum(d) & 0xFF).astype(np.uint8)
    n = s.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = s[:half]
    out[1::2] = s[half:]
    return out.tobytes()


def write_exr(path, img, channel_names=("R", "G", "B"), half=False,
              compression="zip"):
    """Write (ny, nx, C) as a scanline EXR, FLOAT (or HALF with half=True),
    compression "zip" (16-line chunks) or "none"."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    ny, nx, nc = img.shape
    assert nc == len(channel_names)
    # channels are stored alphabetically
    order = np.argsort(channel_names)
    names = [channel_names[i] for i in order]
    ptype = 1 if half else 2  # 1=HALF, 2=FLOAT
    use_zip = compression == "zip"

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    chlist = b""
    for n in names:
        # name, pixel type, pLinear+reserved, xSampling, ySampling
        chlist += n.encode() + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0,
                                                   0, 0, 1, 1)
    chlist += b"\0"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression",
                   bytes([3 if use_zip else 0]))  # 3=ZIP, 0=NONE
    header += attr("dataWindow", "box2i",
                   struct.pack("<iiii", 0, 0, nx - 1, ny - 1))
    header += attr("displayWindow", "box2i",
                   struct.pack("<iiii", 0, 0, nx - 1, ny - 1))
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    dt = "<f2" if half else "<f4"
    lines_per = _ZIP_BLOCK if use_zip else 1
    chunks = []
    for y0c in range(0, ny, lines_per):
        block = b"".join(
            img[y, :, ci].astype(dt).tobytes()
            for y in range(y0c, min(y0c + lines_per, ny)) for ci in order)
        if use_zip:
            comp = zlib.compress(_zip_predict(block))
            if len(comp) >= len(block):
                comp = block  # EXR rule: store raw if zip doesn't shrink
            chunks.append(struct.pack("<ii", y0c, len(comp)) + comp)
        else:
            chunks.append(struct.pack("<ii", y0c, len(block)) + block)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        off = 8 + len(header) + 8 * len(chunks)
        for ch in chunks:
            f.write(struct.pack("<Q", off))
            off += len(ch)
        for ch in chunks:
            f.write(ch)


def read_exr(path):
    """Read a scanline EXR (FLOAT, HALF or UINT channels; NONE, ZIPS, ZIP
    or PIZ). Returns (img (ny, nx, C) float32, channel names sorted)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _ = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    chdata = attrs["channels"][1]
    channels = []
    cpos = 0
    while chdata[cpos] != 0:
        e = chdata.index(b"\0", cpos)
        cname = chdata[cpos:e].decode()
        cpos = e + 1
        ptype = struct.unpack_from("<i", chdata, cpos)[0]
        cpos += 16
        channels.append((cname, ptype))
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3, 4):
        raise NotImplementedError(f"unsupported EXR compression {comp} "
                                  "(NONE/ZIPS/ZIP/PIZ only)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    nx, ny = x1 - x0 + 1, y1 - y0 + 1

    lines_per = {0: 1, 2: 1, 3: _ZIP_BLOCK, 4: _PIZ_BLOCK}[comp]
    n_chunks = -(-ny // lines_per)
    pos += 8 * n_chunks  # skip the offset table
    line_bytes = sum(nx * (2 if pt == 1 else 4) for _, pt in channels)
    img = np.zeros((ny, nx, len(channels)), np.float32)
    for _ in range(n_chunks):
        yb, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        n_lines = min(lines_per, ny - (yb - y0))
        payload = data[pos:pos + nbytes]
        pos += nbytes
        if comp in (2, 3) and nbytes < line_bytes * n_lines:
            payload = _zip_unpredict(zlib.decompress(payload))
        elif comp == 4 and nbytes < line_bytes * n_lines:
            payload = _piz_uncompress(payload, channels, nx, n_lines)
        bpos = 0
        for li in range(n_lines):
            for ci, (_, ptype) in enumerate(channels):
                if ptype == 2:  # FLOAT
                    vals = np.frombuffer(payload, "<f4", nx, bpos)
                    bpos += nx * 4
                elif ptype == 1:  # HALF
                    vals = np.frombuffer(payload, "<f2", nx,
                                         bpos).astype(np.float32)
                    bpos += nx * 2
                else:  # UINT
                    vals = np.frombuffer(payload, "<u4", nx,
                                         bpos).astype(np.float32)
                    bpos += nx * 4
                img[yb - y0 + li, :, ci] = vals
    return img, [c[0] for c in channels]


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img):
    """Write linear (ny, nx, 3) as an sRGB-encoded 8-bit PNG."""
    img = np.asarray(img, np.float32)
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.power(np.clip(img, 1e-8, None), 1 / 2.4)
                    - 0.055)
    px = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)
    ny, nx = px.shape[:2]
    rows = np.concatenate([np.zeros((ny, 1), np.uint8),
                           px.reshape(ny, nx * 3)], 1)  # filter 0 a row
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", nx, ny, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def _png_unfilter(raw, ny, stride, bpp):
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((ny, stride), np.uint8)
    buf = np.frombuffer(raw, np.uint8).reshape(ny, stride + 1)
    prev = np.zeros(stride, np.int32)
    for y in range(ny):
        ftype, line = buf[y, 0], buf[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path):
    """Read an 8-bit greyscale, RGB or RGBA PNG as (ny, nx, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    nx, ny, depth, ctype, _, _, interlace = hdr
    nc = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or nc is None or interlace:
        raise NotImplementedError(f"{path}: only 8-bit non-interlaced "
                                  "greyscale, RGB and RGBA PNGs are read")
    px = _png_unfilter(zlib.decompress(b"".join(idat)), ny, nx * nc, nc)
    return px.reshape(ny, nx, nc)


# -- PIZ decompression (OpenEXR ImfPizCompressor/ImfHuf/ImfWav scheme) -------
# Read-side support for third-party PIZ EXRs (the reference links OpenEXR,
# util/image.cpp:1817 reads any compression; the writer here emits ZIP like
# the reference's). Decode only: wavelet + canonical-Huffman per 32-line
# block.

_PIZ_BLOCK = 32
_USHORT_RANGE = 1 << 16
_BITMAP_SIZE = _USHORT_RANGE >> 3


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get(self, n):
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _huf_unpack_enc_table(br, im, iM):
    """ImfHuf hufUnpackEncTable: 6-bit code lengths with zero-run escapes
    (SHORT_ZEROCODE_RUN=59, LONG_ZEROCODE_RUN=63), then canonical code
    assignment (hufCanonicalCodeTable)."""
    lengths = np.zeros(_USHORT_RANGE + 1, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == 63:  # LONG_ZEROCODE_RUN
            zerun = br.get(8) + 6  # SHORTEST_LONG_RUN
            i += zerun
        elif l >= 59:  # SHORT_ZEROCODE_RUN
            i += l - 59 + 2
        else:
            lengths[i] = l
            i += 1
    # canonical codes, longest first (hufCanonicalCodeTable)
    n = np.zeros(59, np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    start = np.zeros(59, np.int64)
    for l in range(58, 0, -1):
        start[l] = c
        c = (c + n[l]) >> 1
    codes = {}
    nxt = start.copy()
    for sym in np.nonzero(lengths)[0]:
        l = int(lengths[sym])
        codes[(l, int(nxt[l]))] = int(sym)
        nxt[l] += 1
    return codes


def _huf_uncompress(buf, n_out):
    """ImfHuf hufUncompress: 20-byte header (im, iM, tableLength, nBits,
    reserved), packed code-length table, MSB-first bitstream; symbol iM is
    the run-length escape (repeat previous value, 8-bit count)."""
    im, iM, _tl, n_bits = struct.unpack_from("<IIII", buf, 0)
    br = _BitReader(buf[20:])
    codes = _huf_unpack_enc_table(br, im, iM)
    # ImfHuf resumes the data bitstream at the byte AFTER the table's last
    # consumed byte: leftover bits in the unpacker's buffer are discarded
    br.c, br.lc = 0, 0
    out = np.empty(n_out, np.uint16)
    k = 0
    cur, curlen = 0, 0
    bits_read = 0
    while k < n_out and bits_read < n_bits:
        cur = (cur << 1) | br.get(1)
        curlen += 1
        bits_read += 1
        sym = codes.get((curlen, cur))
        if sym is None:
            continue
        if sym == iM:  # run-length escape
            cs = br.get(8)
            bits_read += 8
            out[k:k + cs] = out[k - 1]
            k += cs
        else:
            out[k] = sym
            k += 1
        cur, curlen = 0, 0
    if k != n_out:
        raise ValueError("PIZ: not enough Huffman data")
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hi = h.astype(np.int16).astype(np.int64)
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16).astype(np.uint16)
    b = (ai - hi).astype(np.int16).astype(np.uint16)
    return a, b


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - (1 << 15)) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(plane, nx, ny, max_value):
    """ImfWav wav2Decode on a (ny, nx) uint16 view (in place), vectorized
    per hierarchy level with strided slices."""
    wdec = _wdec14 if max_value < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        # indices of the 2x2 block corners at this level
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            a00 = plane[Y, X]
            a01 = plane[Y, X + p]
            a10 = plane[Y + p, X]
            a11 = plane[Y + p, X + p]
            i00, i10 = wdec(a00, a10)
            i01, i11 = wdec(a01, a11)
            b00, b01 = wdec(i00, i01)
            b10, b11 = wdec(i10, i11)
            plane[Y, X] = b00
            plane[Y, X + p] = b01
            plane[Y + p, X] = b10
            plane[Y + p, X + p] = b11
        if (nx & p) and ys.size:
            # odd column: px one step past the last full block
            x_last = xs[-1] + p2 if xs.size else 0
            a, b = wdec(plane[ys, x_last], plane[ys + p, x_last])
            plane[ys, x_last] = a
            plane[ys + p, x_last] = b
        if (ny & p) and xs.size:
            y_last = ys[-1] + p2 if ys.size else 0
            a, b = wdec(plane[y_last, xs], plane[y_last, xs + p])
            plane[y_last, xs] = a
            plane[y_last, xs + p] = b
        p2 = p
        p >>= 1
    return plane


def _piz_uncompress(payload, channels, nx, n_lines):
    """One PIZ chunk -> scanline-interleaved bytes (ImfPizCompressor::
    uncompress): bitmap + reverse LUT, Huffman, per-channel 2D wavelet,
    LUT application, row reorder."""
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nbm = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(payload, np.uint8, nbm,
                                                  pos)
        pos += nbm
    # reverseLutFromBitmap
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut16 = np.nonzero(bits)[0].astype(np.uint16)
    max_value = lut16.size - 1
    (length,) = struct.unpack_from("<i", payload, pos)
    pos += 4
    sizes = [1 if pt == 1 else 2 for _, pt in channels]  # shorts/sample
    n_shorts = sum(nx * n_lines * s for s in sizes)
    data = _huf_uncompress(payload[pos:pos + length], n_shorts)
    # per-channel wavelet planes
    out_rows = []
    base = 0
    planes = []
    for (cname, pt), s in zip(channels, sizes):
        cn = nx * n_lines * s
        block = data[base:base + cn].reshape(n_lines, nx * s)
        for j in range(s):
            pl = np.ascontiguousarray(block[:, j::s])
            _wav2_decode(pl, nx, n_lines, max_value)
            block[:, j::s] = pl
        planes.append(block)
        base += cn
    # applyLut + row-interleave
    raw = bytearray()
    for y in range(n_lines):
        for block in planes:
            raw += lut16[block[y]].astype("<u2").tobytes()
    return bytes(raw)


def write_pfm(path, img):
    """Write (ny,nx,3) float32 to a little-endian PFM
    (ref: util/image.cpp:1785 WritePFM; netpbm pfm.html). PFM stores rows
    bottom-to-top; a negative scale marks little-endian data."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    ny, nx, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.000000\n" % (nx, ny))
        f.write(np.ascontiguousarray(img[::-1], "<f4").tobytes())


def read_pfm(path):
    """Read a PFM (color 'PF' or grayscale 'Pf') into (ny,nx,3) float32
    (ref: util/image.cpp ReadPFM)."""
    with open(path, "rb") as f:
        data = f.read()
    toks, pos = [], 0
    while len(toks) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        toks.append(data[start:pos])
    pos += 1  # single whitespace after scale
    magic, nx, ny, scale = toks[0], int(toks[1]), int(toks[2]), float(toks[3])
    nc = 3 if magic == b"PF" else 1
    dt = "<f4" if scale < 0 else ">f4"
    img = np.frombuffer(data, dt, nx * ny * nc, pos).reshape(ny, nx, nc)
    img = np.asarray(img[::-1], np.float32) * abs(scale or 1.0)
    return img.repeat(3, -1) if nc == 1 else img


# -- QOI ("Quite OK Image", qoiformat.org) — ref: util/image.cpp:1498,1729 ---

_QOI_MAGIC = b"qoif"


def _qoi_hash(px):
    return (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64


def write_qoi(path, img):
    """Encode linear (ny,nx,3) float to an sRGB-channel QOI file
    (ref: util/image.cpp:1530 qoi_encode disposition; format per the
    public one-page QOI spec: INDEX/DIFF/LUMA/RUN/RGB/RGBA ops)."""
    img = np.asarray(img, np.float32)
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.power(np.clip(img, 1e-8, None), 1 / 2.4)
                    - 0.055)
    px8 = (np.clip(srgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    ny, nx, _ = px8.shape
    out = bytearray(_QOI_MAGIC)
    out += nx.to_bytes(4, "big") + ny.to_bytes(4, "big") + bytes([3, 0])
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    flat = px8.reshape(-1, 3)
    for i in range(flat.shape[0]):
        px = (int(flat[i, 0]), int(flat[i, 1]), int(flat[i, 2]), 255)
        if px == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h = _qoi_hash(px)
        if index[h] == px:
            out.append(h)
        else:
            index[h] = px
            dr = (px[0] - prev[0] + 128) % 256 - 128
            dg = (px[1] - prev[1] + 128) % 256 - 128
            db = (px[2] - prev[2] + 128) % 256 - 128
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(0x40 | ((dr + 2) << 4) | ((dg + 2) << 2)
                           | (db + 2))
            elif (-32 <= dg <= 31 and -8 <= dr - dg <= 7
                  and -8 <= db - dg <= 7):
                out.append(0x80 | (dg + 32))
                out.append(((dr - dg + 8) << 4) | (db - dg + 8))
            else:
                out += bytes([0xFE, px[0], px[1], px[2]])
        prev = px
    if run:
        out.append(0xC0 | (run - 1))
    out += b"\x00\x00\x00\x00\x00\x00\x00\x01"
    with open(path, "wb") as f:
        f.write(bytes(out))


def read_qoi(path):
    """Decode a QOI file to linear float (ny,nx,3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _QOI_MAGIC:
        raise ValueError("not a QOI file")
    nx = int.from_bytes(data[4:8], "big")
    ny = int.from_bytes(data[8:12], "big")
    nch = data[12]
    out = np.empty((ny * nx, 4), np.uint8)
    index = [(0, 0, 0, 0)] * 64
    px = (0, 0, 0, 255)
    pos, i, n = 14, 0, ny * nx
    while i < n:
        b0 = data[pos]
        pos += 1
        if b0 == 0xFE:  # RGB
            px = (data[pos], data[pos + 1], data[pos + 2], px[3])
            pos += 3
        elif b0 == 0xFF:  # RGBA
            px = tuple(data[pos : pos + 4])
            pos += 4
        elif b0 >> 6 == 0:  # INDEX
            px = index[b0]
        elif b0 >> 6 == 1:  # DIFF
            px = ((px[0] + ((b0 >> 4) & 3) - 2) % 256,
                  (px[1] + ((b0 >> 2) & 3) - 2) % 256,
                  (px[2] + (b0 & 3) - 2) % 256, px[3])
        elif b0 >> 6 == 2:  # LUMA
            dg = (b0 & 0x3F) - 32
            b1 = data[pos]
            pos += 1
            px = ((px[0] + dg + (b1 >> 4) - 8) % 256,
                  (px[1] + dg) % 256,
                  (px[2] + dg + (b1 & 0xF) - 8) % 256, px[3])
        else:  # RUN
            for _ in range(b0 & 0x3F):
                out[i] = px
                i += 1
        index[_qoi_hash(px)] = px
        out[i] = px
        i += 1
    raw = out.reshape(ny, nx, 4)[..., :3].astype(np.float32) / 255.0
    del nch
    return np.where(raw <= 0.04045, raw / 12.92,
                    ((raw + 0.055) / 1.055) ** 2.4)


def read_image(path):
    """Read an EXR, PFM, QOI or PNG as linear float (ny, nx, 3) (an EXR
    with other channels than R, G, B keeps its own)."""
    p = str(path)
    if p.endswith(".pfm"):
        return read_pfm(path)
    if p.endswith(".qoi"):
        return read_qoi(path)
    if p.endswith(".exr"):
        img, names = read_exr(path)
        idx = {n: i for i, n in enumerate(names)}
        if all(c in idx for c in "RGB"):
            # channels are stored alphabetically: B, G, R(, A)
            img = np.stack([img[..., idx[c]] for c in "RGB"], -1)
        return img
    if p.endswith(".png"):
        raw = read_png(path).astype(np.float32) / 255.0
        if raw.shape[-1] == 1:
            raw = np.repeat(raw, 3, -1)
        lin = np.where(raw <= 0.04045, raw / 12.92,
                       ((raw + 0.055) / 1.055) ** 2.4)
        return lin[..., :3]
    raise NotImplementedError(f"{p}: only EXR, PFM, QOI and PNG images "
                              "are read")


def write_image(path, img):
    """Write by extension (ref: util/image.cpp:1008 Image::Write): .exr (or
    no extension), .pfm, .qoi or .png; any other raises."""
    p = str(path)
    if p.endswith(".pfm"):
        write_pfm(path, img)
    elif p.endswith(".qoi"):
        write_qoi(path, img)
    elif p.endswith(".png"):
        write_png(path, img)
    elif p.endswith(".exr") or "." not in os.path.basename(p):
        write_exr(path, np.asarray(img, np.float32))
    else:
        # writing EXR bytes into e.g. out.jpg would mislabel the file
        raise ValueError(f"unsupported image extension: {p!r} "
                         "(supported: .exr .pfm .qoi .png)")


def mse(a, b):
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
