"""Raw Ptex (.ptx) file reader + writer in pure numpy (this package's copy
of the JAX package's ``tools/ptex.py``; it imports neither JAX nor that
package).

Role of the reference's PtexTexture (`src/pbrt/textures.h` PtexTexture,
which evaluates Disney per-face textures through the ptex library): load
.ptx face-texture files without the native ptex library, so ptex-textured
assets feed `models/textures.build_face_atlas` directly (the TPU design
bakes faces into one atlas at build time; the hot path stays a plain
bilinear gather).

Implements the published Ptex file format (ptex.us file-format doc /
PtexIO.h v1.x layout). All integers little-endian, structs packed:

  Header (60 B): magic 'Ptex'(u32) version(u32) meshtype(u32)
    datatype(u32) alphachan(i32) nchannels(u16) nlevels(u16) nfaces(u32)
    extheadersize(u32) faceinfosize(u32) constdatasize(u32)
    levelinfosize(u32) leveldatasize(u64) metadatazipsize(u32)
    metadatamemsize(u32)
  then: ExtHeader (extheadersize B, v1.4+; border modes + large-meta/edit
    sizes — skipped on read), zipped FaceInfo[nfaces] (20 B each: res
    int8x2, adjedges u8, flags u8, adjfaces i32x4), zipped constdata
    (nfaces * pixelsize B: per-face constant/average pixel), raw
    LevelInfo[nlevels] (16 B: leveldatasize u64, levelheadersize u32,
    nfaces u32), then the level blocks. A level block is a zipped
    FaceDataHeader[nfaces] array (u32 each: blocksize in bits 0..29,
    encoding in bits 30..31) followed by the face blocks back to back.

Face encodings: enc_constant=0 (pixel lives in constdata, blocksize 0),
enc_zipped=1 (zlib of row-major texels), enc_diffzipped=2 (zlib of
byte/word difference-coded texels, uint8/uint16 only — decode is a
cumulative sum, PtexUtils::decodeDifference), enc_tiled=3 (Res tileres
(2 B) + tileheadersize (u32) + zipped FaceDataHeader[ntiles] + tile
blocks; tiles row-major over the face, u fastest, each decoded like a
face). Mip levels beyond level 0 are reduction copies — the reader only
consumes level 0 (full resolution); the writer emits nlevels=1.

Tested across data types, encodings and tiling against the JAX
package's reader and writer, both ways (tests/test_torch_ptex.py). Metadata and edit blocks are preserved-size skipped.
"""

from __future__ import annotations

import struct as _struct
import zlib

import numpy as np

MAGIC = 0x78657450  # 'P','t','e','x' little-endian

MESH_TRIANGLE = 0
MESH_QUAD = 1

DT_UINT8 = 0
DT_UINT16 = 1
DT_HALF = 2
DT_FLOAT = 3

_DTYPES = {
    DT_UINT8: np.dtype("<u1"),
    DT_UINT16: np.dtype("<u2"),
    DT_HALF: np.dtype("<f2"),
    DT_FLOAT: np.dtype("<f4"),
}
_DT_NAMES = {"uint8": DT_UINT8, "uint16": DT_UINT16,
             "half": DT_HALF, "float": DT_FLOAT}
_DT_SCALE = {DT_UINT8: 255.0, DT_UINT16: 65535.0}

ENC_CONSTANT = 0
ENC_ZIPPED = 1
ENC_DIFFZIPPED = 2
ENC_TILED = 3

FLAG_CONSTANT = 1

_HEADER = _struct.Struct("<IIIIiHHIIIIIQII")
_FACEINFO = _struct.Struct("<bbBBiiii")
_LEVELINFO = _struct.Struct("<QII")


class PtexFile:
    """Decoded .ptx: float32 faces plus the mesh/adjacency metadata."""

    def __init__(self, faces, meshtype, datatype, alphachan, faceinfo):
        self.faces = faces          # list of (h, w, nchannels) float32
        self.meshtype = meshtype    # MESH_TRIANGLE | MESH_QUAD
        self.datatype = datatype    # DT_* of the on-disk texels
        self.alphachan = alphachan  # -1 if none
        self.faceinfo = faceinfo    # list of dicts: adjfaces, adjedges, flags


def _decode_difference(raw, dtype):
    """PtexUtils::decodeDifference: cumulative sum of byte/word deltas."""
    if dtype.itemsize == 1:
        return np.cumsum(np.frombuffer(raw, np.uint8), dtype=np.uint8
                         ).tobytes()
    return np.cumsum(np.frombuffer(raw, "<u2"), dtype=np.uint16).tobytes()


def _encode_difference(arr):
    flat = arr.view(np.uint8 if arr.dtype.itemsize == 1 else np.uint16
                    ).ravel()
    out = flat.copy()
    out[1:] = flat[1:] - flat[:-1]
    return out.astype(flat.dtype).tobytes()


def _to_float(arr, datatype):
    arr = arr.astype(np.float32)
    scale = _DT_SCALE.get(datatype)
    return arr / scale if scale else arr


def _from_float(arr, datatype):
    dt = _DTYPES[datatype]
    scale = _DT_SCALE.get(datatype)
    if scale:
        return np.clip(np.round(arr * scale), 0, scale).astype(dt)
    return arr.astype(dt)


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated .ptx file")
        self.pos += n
        return b

    def unzip(self, zipsize, memsize):
        out = zlib.decompress(self.take(zipsize))
        if len(out) != memsize:
            raise ValueError(
                f"ptex zip block: got {len(out)} bytes, want {memsize}")
        return out


def _read_face_block(cur, fdh_word, vres, ures, nchan, datatype):
    """Decode one face (or tile) data block at the cursor."""
    dtype = _DTYPES[datatype]
    blocksize = fdh_word & 0x3FFFFFFF
    enc = (fdh_word >> 30) & 0x3
    psize = dtype.itemsize * nchan
    if enc == ENC_CONSTANT:
        px = np.frombuffer(cur.take(psize) if blocksize else b"\0" * psize,
                           dtype, count=nchan)
        return np.broadcast_to(px, (vres, ures, nchan)).copy()
    if enc in (ENC_ZIPPED, ENC_DIFFZIPPED):
        raw = cur.unzip(blocksize, vres * ures * psize)
        if enc == ENC_DIFFZIPPED:
            raw = _decode_difference(raw, dtype)
        return np.frombuffer(raw, dtype).reshape(vres, ures, nchan)
    # ENC_TILED: Res tileres + u32 tileheadersize + zipped tile fdh array
    tul, tvl = _struct.unpack("<bb", cur.take(2))
    tu, tv = 1 << tul, 1 << tvl
    (tilehdrsize,) = _struct.unpack("<I", cur.take(4))
    ntiles = (ures // tu) * (vres // tv)
    tile_fdh = np.frombuffer(cur.unzip(tilehdrsize, 4 * ntiles), "<u4")
    out = np.empty((vres, ures, nchan), dtype)
    for t in range(ntiles):
        r, c = divmod(t, ures // tu)  # row-major, u fastest
        out[r * tv:(r + 1) * tv, c * tu:(c + 1) * tu] = _read_face_block(
            cur, int(tile_fdh[t]), tv, tu, nchan, datatype)
    return out


def read_ptx(path):
    """Parse a .ptx file into float32 per-face texel arrays (level 0)."""
    with open(path, "rb") as f:
        buf = f.read()
    cur = _Cursor(buf)
    (magic, version, meshtype, datatype, alphachan, nchan, nlevels, nfaces,
     extsize, fisize, cdsize, lisize, _ldsize, mdzip, _mdmem
     ) = _HEADER.unpack(cur.take(_HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"not a Ptex file (magic {magic:#x})")
    if version != 1:
        raise ValueError(f"unsupported Ptex version {version}")
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported Ptex datatype {datatype}")
    cur.take(extsize)  # ExtHeader: border modes / edit sizes — not needed
    fi_raw = cur.unzip(fisize, _FACEINFO.size * nfaces)
    faceinfo, res = [], []
    for i in range(nfaces):
        ul, vl, adje, flags, a0, a1, a2, a3 = _FACEINFO.unpack_from(
            fi_raw, i * _FACEINFO.size)
        res.append((1 << vl, 1 << ul))
        faceinfo.append(dict(adjfaces=(a0, a1, a2, a3),
                             adjedges=tuple((adje >> (2 * e)) & 3
                                            for e in range(4)),
                             flags=flags))
    psize = _DTYPES[datatype].itemsize * nchan
    const_raw = cur.unzip(cdsize, psize * nfaces) if cdsize else None
    li_raw = cur.take(lisize)
    levels = [_LEVELINFO.unpack_from(li_raw, i * _LEVELINFO.size)
              for i in range(lisize // _LEVELINFO.size)]
    faces = []
    if levels:
        _, lvlhdr, lvlnfaces = levels[0]
        fdh = np.frombuffer(cur.unzip(lvlhdr, 4 * lvlnfaces), "<u4")
        dtype = _DTYPES[datatype]
        for i in range(lvlnfaces):
            vres, ures = res[i]
            word = int(fdh[i])
            if (word >> 30) == ENC_CONSTANT:
                px = np.frombuffer(const_raw, dtype, count=nchan,
                                   offset=i * psize)
                cur.take(word & 0x3FFFFFFF)
                arr = np.broadcast_to(px, (vres, ures, nchan)).copy()
            else:
                arr = _read_face_block(cur, word, vres, ures, nchan,
                                       datatype)
            faces.append(_to_float(arr, datatype))
    # metadata block (zipped key/value pairs) is skipped: cur.take(mdzip)
    del mdzip
    return PtexFile(faces, meshtype, datatype, alphachan, faceinfo)


def _write_face_block(arr, datatype, diff):
    """Encode one face/tile: (fdh_word, bytes). arr is on-disk dtype."""
    if (arr == arr.reshape(-1, arr.shape[-1])[0]).all():
        return (ENC_CONSTANT << 30) | arr.itemsize * arr.shape[-1], \
            arr.reshape(-1, arr.shape[-1])[0].tobytes()
    enc = ENC_DIFFZIPPED if (diff and datatype in (DT_UINT8, DT_UINT16)) \
        else ENC_ZIPPED
    raw = _encode_difference(arr) if enc == ENC_DIFFZIPPED \
        else arr.tobytes()
    z = zlib.compress(raw)
    return (enc << 30) | len(z), z


def write_ptx(path, faces, meshtype=MESH_QUAD, datatype="float",
              alphachan=-1, adjfaces=None, adjedges=None, diff=True,
              tile_size=0):
    """Write faces (list of (h, w, c) arrays, float in [0,1] for integer
    datatypes) as a .ptx. tile_size > 0 forces enc_tiled for faces larger
    than tile_size x tile_size (the real writer tiles ~64 KB+ faces)."""
    datatype = _DT_NAMES[datatype] if isinstance(datatype, str) else datatype
    faces = [np.atleast_3d(np.asarray(f, np.float32)) for f in faces]
    nchan = faces[0].shape[-1]
    psize = _DTYPES[datatype].itemsize * nchan
    fi_rows, const_rows, fdh_words, blocks = [], [], [], []
    for i, f in enumerate(faces):
        h, w, c = f.shape
        if c != nchan or (h & (h - 1)) or (w & (w - 1)):
            raise ValueError(
                f"face {i}: shape {f.shape} (need power-of-2, {nchan} ch)")
        disk = _from_float(f, datatype)
        const_rows.append(_from_float(f.mean(axis=(0, 1)), datatype))
        if tile_size and (h > tile_size or w > tile_size):
            tv, tu = min(h, tile_size), min(w, tile_size)
            t_words, t_blocks = [], []
            for r in range(h // tv):
                for ccol in range(w // tu):
                    tw, tb = _write_face_block(
                        disk[r * tv:(r + 1) * tv,
                             ccol * tu:(ccol + 1) * tu], datatype, diff)
                    t_words.append(tw)
                    t_blocks.append(tb)
            thdr = zlib.compress(np.asarray(t_words, "<u4").tobytes())
            body = (_struct.pack("<bbI", tu.bit_length() - 1,
                                 tv.bit_length() - 1, len(thdr))
                    + thdr + b"".join(t_blocks))
            word = (ENC_TILED << 30) | len(body)
            fdh_words.append(word)
            blocks.append(body)
        else:
            word, body = _write_face_block(disk, datatype, diff)
            if (word >> 30) == ENC_CONSTANT:
                # constant faces live in constdata; block carries nothing
                const_rows[-1] = np.frombuffer(body, _DTYPES[datatype])
                word, body = (ENC_CONSTANT << 30), b""
            fdh_words.append(word)
            blocks.append(body)
        flags = FLAG_CONSTANT if (fdh_words[-1] >> 30) == ENC_CONSTANT \
            and not blocks[-1] else 0
        adjf = adjfaces[i] if adjfaces else (-1, -1, -1, -1)
        adje = adjedges[i] if adjedges else (0, 0, 0, 0)
        fi_rows.append(_FACEINFO.pack(
            w.bit_length() - 1, h.bit_length() - 1,
            sum((e & 3) << (2 * k) for k, e in enumerate(adje)), flags,
            *adjf))
    fi_zip = zlib.compress(b"".join(fi_rows))
    const_zip = zlib.compress(b"".join(r.tobytes() for r in const_rows))
    lvlhdr_zip = zlib.compress(np.asarray(fdh_words, "<u4").tobytes())
    body = b"".join(blocks)
    leveldatasize = len(lvlhdr_zip) + len(body)
    li = _LEVELINFO.pack(leveldatasize, len(lvlhdr_zip), len(faces))
    header = _HEADER.pack(
        MAGIC, 1, meshtype, datatype, alphachan, nchan, 1, len(faces),
        0, len(fi_zip), len(const_zip), len(li), leveldatasize, 0, 0)
    with open(path, "wb") as f:
        f.write(header + fi_zip + const_zip + li + lvlhdr_zip + body)
