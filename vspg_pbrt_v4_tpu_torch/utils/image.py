"""Image IO and the MSE metric, in numpy alone (this package's copy of what
the CLI needs from the JAX package's ``utils/image.py``).

EXR: scanline FLOAT/HALF images, written with ZIP compression (OpenEXR's
ImfZip scheme: byte reorder, delta predictor, zlib) or none, and read
back with NONE, ZIPS or ZIP. PNG: 8-bit RGB written sRGB-encoded through
zlib, and 8-bit greyscale, RGB or RGBA (non-interlaced) read back as
linear RGB. No imaging library is needed.
"""

from __future__ import annotations

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
    """Read a scanline EXR (FLOAT, HALF or UINT channels; NONE, ZIPS or
    ZIP). Returns (img (ny, nx, C) float32, channel names sorted)."""
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
    if comp not in (0, 2, 3):
        raise NotImplementedError(f"{path}: EXR compression {comp} is not "
                                  "read here (NONE, ZIPS and ZIP are)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    nx, ny = x1 - x0 + 1, y1 - y0 + 1

    lines_per = _ZIP_BLOCK if comp == 3 else 1
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


def read_image(path):
    """Read an EXR or a PNG as linear float (ny, nx, 3) (an EXR with other
    channels than R, G, B keeps its own)."""
    p = str(path)
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
    raise NotImplementedError(f"{p}: only EXR and PNG images are read")


def mse(a, b):
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
