"""Raw NanoVDB (.nvdb) file reader + writer in pure numpy (this package's
copy of the JAX package's ``tools/nvdb.py``: file I/O on the host).

Role of the reference's NanoVDB ingestion (`media.h:657` NanoVDBMedium,
`cmd/nanovdb2pbrt.cpp`): load the paper's cloud assets without native VDB
libraries. Implements the NanoVDB 32.3 on-disk layout (the version pbrt-v4
vendors): FileHeader + per-grid FileMetaData, then the flat grid buffer
(GridData 672 B, TreeData 64 B, Root/Internal/Leaf nodes). Only
uncompressed (Codec NONE) float grids are supported; gzip/blosc codecs and
non-float value types raise with a clear message.

The writer emits the same layout (dense: every voxel in the index bbox gets
a leaf) and is used to round-trip-test the reader; both sides implement the
published struct layouts, so a file produced by real NanoVDB with the same
version parses identically. Offsets follow NanoVDB.h:
- TreeData::mNodeOffset[level]: byte offset from the tree (= GridData end)
  to the first node of each level [leaf, lower, upper, root].
- RootData::Tile::child and InternalData::Tile::child: byte offset from the
  OWNING node's address to the child node.
"""

from __future__ import annotations

import struct as _struct

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0"
GRID_TYPE_FLOAT = 1
GRID_CLASS_FOG = 3
CODEC_NONE = 0

# struct sizes (NanoVDB 32.3, float build type)
GRIDDATA_SIZE = 672
TREEDATA_SIZE = 64
ROOTDATA_SIZE = 64          # 24 bbox + 4 tableSize + 5*4 stats = 48 -> pad 64
ROOT_TILE_SIZE = 32         # 8 key + 8 child + 4 state + 4 value -> pad 32
UPPER_SIZE = 8256 + 32768 * 8   # hdr(24+8+4096*2+16 -> pad 8256) + table
LOWER_SIZE = 1088 + 4096 * 8    # hdr(24+8+512*2+16=1072 -> pad 1088) + table
LEAF_SIZE = 96 + 512 * 4        # 12+3+1+64+16=96, then 512 floats
FILEMETA_SIZE = 176


def _coord_key(x, y, z):
    """RootData::CoordToKey (21-bit packed upper coords, two's complement)."""
    ux = (int(x) & 0xFFFFFFFF) >> 12
    uy = (int(y) & 0xFFFFFFFF) >> 12
    uz = (int(z) & 0xFFFFFFFF) >> 12
    return np.uint64(uz | (uy << 21) | (ux << 42))


def _key_coord(key):
    """Inverse of _coord_key: field << 12 reinterpreted as int32
    (NanoVDB RootData::KeyToCoord)."""
    def dec(v):
        v = (int(v) << 12) & 0xFFFFFFFF
        return v - (1 << 32) if v & (1 << 31) else v

    z = dec(int(key) & 0x1FFFFF)
    y = dec((int(key) >> 21) & 0x1FFFFF)
    x = dec((int(key) >> 42) & 0x1FFFFF)
    return x, y, z


def write_nvdb(path, density, index_origin=(0, 0, 0), voxel_size=1.0,
               grid_name="density"):
    """Write a dense float fog-volume grid as an uncompressed .nvdb."""
    d = np.asarray(density, np.float32)
    nx, ny, nz = d.shape
    ox, oy, oz = (int(v) for v in index_origin)
    vs = float(voxel_size)
    if any((v % 8) for v in (ox, oy, oz)):
        raise ValueError("index origin must be 8-aligned")

    # pad to leaf multiples
    pad = [(-s) % 8 for s in d.shape]
    d = np.pad(d, [(0, p) for p in pad])
    lnx, lny, lnz = (s // 8 for s in d.shape)

    # enumerate nodes bottom-up; group leaves into 16^3-leaf lowers (span
    # 128), lowers into 32^3 uppers (span 4096), uppers under one root tile
    # per 4096-region.
    leaves = {}
    for i in range(lnx):
        for j in range(lny):
            for k in range(lnz):
                block = d[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8,
                          k * 8:(k + 1) * 8]
                leaves[(ox + i * 8, oy + j * 8, oz + k * 8)] = block
    lowers = {}
    for (x, y, z) in leaves:
        key = (x // 128 * 128, y // 128 * 128, z // 128 * 128)
        lowers.setdefault(key, []).append((x, y, z))
    uppers = {}
    for key in lowers:
        ukey = (key[0] // 4096 * 4096, key[1] // 4096 * 4096,
                key[2] // 4096 * 4096)
        uppers.setdefault(ukey, []).append(key)
    root_tiles = sorted(uppers.keys())

    leaf_list = sorted(leaves.keys())
    lower_list = sorted(lowers.keys())
    upper_list = sorted(uppers.keys())
    leaf_idx = {c: n for n, c in enumerate(leaf_list)}
    lower_idx = {c: n for n, c in enumerate(lower_list)}
    upper_idx = {c: n for n, c in enumerate(upper_list)}

    # tree layout: [TreeData][root][upper...][lower...][leaf...]
    # (any order is legal; offsets make it explicit)
    root_size = ROOTDATA_SIZE + ROOT_TILE_SIZE * len(root_tiles)
    off_root = TREEDATA_SIZE
    off_upper = off_root + root_size
    off_lower = off_upper + UPPER_SIZE * len(upper_list)
    off_leaf = off_lower + LOWER_SIZE * len(lower_list)
    tree_size = off_leaf + LEAF_SIZE * len(leaf_list)
    grid_size = GRIDDATA_SIZE + tree_size

    buf = bytearray(grid_size)

    # ---- GridData ----------------------------------------------------------
    wb_min = (ox * vs, oy * vs, oz * vs)
    wb_max = ((ox + nx) * vs, (oy + ny) * vs, (oz + nz) * vs)
    _struct.pack_into("<QQIIIIQ", buf, 0, MAGIC, 0, (32 << 21) | (3 << 10),
                      0, 0, 1, grid_size)
    name_b = grid_name.encode()[:255]
    buf[40:40 + len(name_b)] = name_b
    # Map: floats then doubles (identity scale by voxel size)
    mo = 296
    matf = [vs, 0, 0, 0, vs, 0, 0, 0, vs]
    invf = [1 / vs, 0, 0, 0, 1 / vs, 0, 0, 0, 1 / vs]
    _struct.pack_into("<9f9f3ff", buf, mo, *matf, *invf, 0.0, 0.0, 0.0, 0.0)
    _struct.pack_into("<9d9d3dd", buf, mo + 88, *matf, *invf,
                      0.0, 0.0, 0.0, 0.0)
    _struct.pack_into("<6d", buf, 560, *wb_min, *wb_max)
    _struct.pack_into("<3d", buf, 608, vs, vs, vs)
    _struct.pack_into("<II", buf, 632, GRID_CLASS_FOG, GRID_TYPE_FLOAT)
    _struct.pack_into("<qIIQQ", buf, 640, 0, 0, 0, 0, 0)

    # ---- TreeData ----------------------------------------------------------
    to = GRIDDATA_SIZE
    _struct.pack_into("<4q", buf, to, off_leaf, off_lower, off_upper,
                      off_root)
    _struct.pack_into("<3I", buf, to + 32, len(leaf_list), len(lower_list),
                      len(upper_list))
    _struct.pack_into("<3I", buf, to + 44, 0, 0, 0)
    _struct.pack_into("<Q", buf, to + 56, int(d.astype(bool).sum()))

    # ---- RootData ----------------------------------------------------------
    ro = to + off_root
    _struct.pack_into("<6i", buf, ro, ox, oy, oz, ox + nx, oy + ny, oz + nz)
    _struct.pack_into("<I", buf, ro + 24, len(root_tiles))
    _struct.pack_into("<5f", buf, ro + 28, 0.0, float(d.min()),
                      float(d.max()), float(d.mean()), float(d.std()))
    for n, c in enumerate(root_tiles):
        t = ro + ROOTDATA_SIZE + n * ROOT_TILE_SIZE
        child_off = (to + off_upper + UPPER_SIZE * upper_idx[c]) - ro
        _struct.pack_into("<QqIf", buf, t, int(_coord_key(*c)), child_off,
                          0, 0.0)

    # ---- upper internal nodes ---------------------------------------------
    for c, node_i in upper_idx.items():
        no = to + off_upper + UPPER_SIZE * node_i
        _struct.pack_into("<6i", buf, no, c[0], c[1], c[2],
                          c[0] + 4096, c[1] + 4096, c[2] + 4096)
        _struct.pack_into("<Q", buf, no + 24, 0)
        cmask = np.zeros(32768 // 8, np.uint8)
        table = np.zeros(32768, np.int64)
        for lc in uppers[c]:
            li = (((lc[0] - c[0]) // 128) * 32 + (lc[1] - c[1]) // 128) \
                * 32 + (lc[2] - c[2]) // 128
            cmask[li // 8] |= 1 << (li % 8)
            table[li] = (to + off_lower + LOWER_SIZE * lower_idx[lc]) - no
        buf[no + 32 + 4096:no + 32 + 8192] = cmask.tobytes()
        _struct.pack_into("<4f", buf, no + 8224, 0, 0, 0, 0)
        buf[no + 8256:no + 8256 + 262144] = table.tobytes()

    # ---- lower internal nodes ---------------------------------------------
    for c, node_i in lower_idx.items():
        no = to + off_lower + LOWER_SIZE * node_i
        _struct.pack_into("<6i", buf, no, c[0], c[1], c[2],
                          c[0] + 128, c[1] + 128, c[2] + 128)
        _struct.pack_into("<Q", buf, no + 24, 0)
        cmask = np.zeros(4096 // 8, np.uint8)
        table = np.zeros(4096, np.int64)
        for lf in lowers[c]:
            li = (((lf[0] - c[0]) // 8) * 16 + (lf[1] - c[1]) // 8) \
                * 16 + (lf[2] - c[2]) // 8
            cmask[li // 8] |= 1 << (li % 8)
            table[li] = (to + off_leaf + LEAF_SIZE * leaf_idx[lf]) - no
        buf[no + 32 + 512:no + 32 + 1024] = cmask.tobytes()
        _struct.pack_into("<4f", buf, no + 1056, 0, 0, 0, 0)
        buf[no + 1088:no + 1088 + 32768] = table.tobytes()

    # ---- leaves ------------------------------------------------------------
    for c, node_i in leaf_idx.items():
        no = to + off_leaf + LEAF_SIZE * node_i
        _struct.pack_into("<3i3BB", buf, no, c[0], c[1], c[2], 8, 8, 8, 0)
        buf[no + 16:no + 80] = b"\xff" * 64  # all voxels active
        block = leaves[c]
        _struct.pack_into("<4f", buf, no + 80, float(block.min()),
                          float(block.max()), float(block.mean()),
                          float(block.std()))
        buf[no + 96:no + 96 + 2048] = np.ascontiguousarray(
            block, np.float32).tobytes()

    # ---- file container ----------------------------------------------------
    with open(path, "wb") as f:
        f.write(_struct.pack("<QIHH", MAGIC, (32 << 21) | (3 << 10), 1,
                             CODEC_NONE))
        meta = bytearray(FILEMETA_SIZE)
        name_file = grid_name.encode() + b"\x00"
        _struct.pack_into("<4Q", meta, 0, grid_size, grid_size, 0,
                          int(d.astype(bool).sum()))
        _struct.pack_into("<II", meta, 32, GRID_TYPE_FLOAT, GRID_CLASS_FOG)
        _struct.pack_into("<6d", meta, 40, *wb_min, *wb_max)
        _struct.pack_into("<6i", meta, 88, ox, oy, oz,
                          ox + nx, oy + ny, oz + nz)
        _struct.pack_into("<3d", meta, 112, vs, vs, vs)
        _struct.pack_into("<I", meta, 136, len(name_file))
        _struct.pack_into("<4I", meta, 140, len(leaf_list), len(lower_list),
                          len(upper_list), 1)
        _struct.pack_into("<3I", meta, 156, 0, 0, 0)
        _struct.pack_into("<HHI", meta, 168, CODEC_NONE, 0,
                          (32 << 21) | (3 << 10))
        f.write(meta)
        f.write(name_file)
        f.write(bytes(buf))


def read_nvdb(path, grid_index=0):
    """Parse an uncompressed float .nvdb. Returns (density (nx,ny,nz),
    index_bbox_min (3,) int, voxel_size float, world_bbox (2,3))."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 16:
        raise ValueError("not a NanoVDB file (too small)")
    magic, _version, grid_count, codec = _struct.unpack_from("<QIHH", raw, 0)
    if magic != MAGIC:
        raise ValueError(f"bad NanoVDB magic {magic:#x}")
    if codec != CODEC_NONE:
        raise ValueError("compressed .nvdb (gzip/blosc) not supported; "
                         "re-export uncompressed")
    if grid_index >= grid_count:
        raise ValueError(f"grid {grid_index} of {grid_count}")
    off = 16
    for gi in range(grid_count):
        (grid_size, file_size, _, _) = _struct.unpack_from("<4Q", raw, off)
        gtype, gclass = _struct.unpack_from("<II", raw, off + 32)
        ibb = _struct.unpack_from("<6i", raw, off + 88)
        vs = _struct.unpack_from("<3d", raw, off + 112)[0]
        wbb = np.asarray(_struct.unpack_from("<6d", raw, off + 40),
                         np.float64).reshape(2, 3)
        (name_size,) = _struct.unpack_from("<I", raw, off + 136)
        data_off = off + FILEMETA_SIZE + name_size
        if gi == grid_index:
            if gtype != GRID_TYPE_FLOAT:
                raise ValueError(f"only float grids supported (type {gtype})")
            dens = _parse_grid(raw, data_off, ibb)
            return dens, np.asarray(ibb[:3], np.int32), float(vs), wbb
        off = data_off + file_size
    raise ValueError("grid not found")


def _parse_grid(raw, g0, ibb):
    tree = g0 + GRIDDATA_SIZE
    off_leaf, off_lower, off_upper, off_root = _struct.unpack_from(
        "<4q", raw, tree)
    ro = tree + off_root
    bb = _struct.unpack_from("<6i", raw, ro)
    (table_size,) = _struct.unpack_from("<I", raw, ro + 24)
    (background,) = _struct.unpack_from("<f", raw, ro + 28)
    ox, oy, oz = bb[0], bb[1], bb[2]
    nx, ny, nz = bb[3] - bb[0], bb[4] - bb[1], bb[5] - bb[2]
    if nx <= 0 or ny <= 0 or nz <= 0:
        # fall back to the file-meta bbox (exclusive upper in our writer)
        ox, oy, oz = ibb[0], ibb[1], ibb[2]
        nx, ny, nz = ibb[3] - ibb[0], ibb[4] - ibb[1], ibb[5] - ibb[2]
    dens = np.full((nx, ny, nz), background, np.float32)

    def put(x0, y0, z0, block):
        """Write a block at index coords, clipped to the bbox array."""
        bx, by, bz = block.shape
        i0, j0, k0 = x0 - ox, y0 - oy, z0 - oz
        si = slice(max(i0, 0), min(i0 + bx, nx))
        sj = slice(max(j0, 0), min(j0 + by, ny))
        sk = slice(max(k0, 0), min(k0 + bz, nz))
        if si.start >= si.stop or sj.start >= sj.stop or sk.start >= sk.stop:
            return
        dens[si, sj, sk] = block[si.start - i0:si.stop - i0,
                                 sj.start - j0:sj.stop - j0,
                                 sk.start - k0:sk.stop - k0]

    for t in range(table_size):
        ta = ro + ROOTDATA_SIZE + t * ROOT_TILE_SIZE
        key, child = _struct.unpack_from("<Qq", raw, ta)
        state, value = _struct.unpack_from("<If", raw, ta + 16)
        x0, y0, z0 = _key_coord(np.uint64(key))
        if child == 0:
            if state:  # active constant tile spanning 4096^3
                put(x0, y0, z0, np.full((4096, 4096, 4096), value,
                                        np.float32))
            continue
        _parse_upper(raw, ro + child, x0, y0, z0, put)
    return dens


def _parse_upper(raw, no, x0, y0, z0, put):
    cmask = np.frombuffer(raw, np.uint8, 4096, no + 32 + 4096)
    vmask = np.frombuffer(raw, np.uint8, 4096, no + 32)
    table = np.frombuffer(raw, np.int64, 32768, no + 8256)
    values = table.view(np.float32)[::2]
    child_bits = np.unpackbits(cmask, bitorder="little")
    value_bits = np.unpackbits(vmask, bitorder="little")
    for li in np.nonzero(child_bits | value_bits)[0]:
        cx = x0 + (li // (32 * 32)) * 128
        cy = y0 + ((li // 32) % 32) * 128
        cz = z0 + (li % 32) * 128
        if child_bits[li]:
            _parse_lower(raw, no + int(table[li]), cx, cy, cz, put)
        elif value_bits[li]:
            put(cx, cy, cz, np.full((128, 128, 128), values[li * 2],
                                    np.float32))


def _parse_lower(raw, no, x0, y0, z0, put):
    vmask = np.frombuffer(raw, np.uint8, 512, no + 32)
    cmask = np.frombuffer(raw, np.uint8, 512, no + 32 + 512)
    table = np.frombuffer(raw, np.int64, 4096, no + 1088)
    values = table.view(np.float32)[::2]
    child_bits = np.unpackbits(cmask, bitorder="little")
    value_bits = np.unpackbits(vmask, bitorder="little")
    for li in np.nonzero(child_bits | value_bits)[0]:
        cx = x0 + (li // (16 * 16)) * 8
        cy = y0 + ((li // 16) % 16) * 8
        cz = z0 + (li % 16) * 8
        if child_bits[li]:
            _parse_leaf(raw, no + int(table[li]), cx, cy, cz, put)
        elif value_bits[li]:
            put(cx, cy, cz, np.full((8, 8, 8), values[li * 2], np.float32))


def _parse_leaf(raw, no, x0, y0, z0, put):
    vals = np.frombuffer(raw, np.float32, 512, no + 96).reshape(8, 8, 8)
    put(x0, y0, z0, vals)
