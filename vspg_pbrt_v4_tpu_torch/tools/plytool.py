"""PLY meshes on disk (the writer and reader of ``tools/plytool.py`` in the
JAX package, without its scene-asset layer).

``write_ply`` emits binary little-endian PLY: float x, y, z [nx, ny, nz]
[u, v] per vertex and a uchar-counted int list per triangle.
``read_ply`` reads that layout back with numpy as dict(P, indices[, N][,
uv]) of numpy arrays.
"""

from __future__ import annotations

import numpy as np


def write_ply(path, P, indices, N=None, uv=None):
    """Binary little-endian PLY writer."""
    P = np.asarray(P, "<f4")
    indices = np.asarray(indices, "<i4")
    nv, nt = P.shape[0], indices.shape[0]
    hdr = ["ply", "format binary_little_endian 1.0",
           f"element vertex {nv}",
           "property float x", "property float y", "property float z"]
    if N is not None:
        hdr += ["property float nx", "property float ny", "property float nz"]
    if uv is not None:
        hdr += ["property float u", "property float v"]
    hdr += [f"element face {nt}",
            "property list uchar int vertex_indices", "end_header"]
    cols = [P]
    if N is not None:
        cols.append(np.asarray(N, "<f4"))
    if uv is not None:
        cols.append(np.asarray(uv, "<f4"))
    vdata = np.concatenate(cols, axis=1).astype("<f4")
    faces = np.zeros(nt, np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    faces["n"] = 3
    faces["v"] = indices
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(vdata.tobytes())
        f.write(faces.tobytes())


def read_ply(path):
    """Read a PLY file of ``write_ply``'s layout with numpy."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    if header[1] != "format binary_little_endian 1.0":
        raise ValueError(f"{path}: not binary little-endian PLY")
    props, nv, nt = [], 0, 0
    for line in header:
        w = line.split()
        if w[:2] == ["element", "vertex"]:
            nv = int(w[2])
        elif w[:2] == ["element", "face"]:
            nt = int(w[2])
        elif w[:2] == ["property", "float"]:
            props.append(w[2])
        elif w[0] == "property" and w[1] != "list":
            raise ValueError(f"{path}: vertex property {line!r} is not "
                             "float")
    vert = np.frombuffer(data, "<f4", nv * len(props), end).reshape(
        nv, len(props))
    faces = np.frombuffer(data, np.dtype([("n", "u1"), ("v", "<i4", 3)]),
                          nt, end + vert.nbytes)
    if not (faces["n"] == 3).all():
        raise ValueError(f"{path}: only triangles are read")
    out = dict(P=np.ascontiguousarray(vert[:, 0:3]),
               indices=np.ascontiguousarray(faces["v"], np.int32))
    if "nx" in props:
        k = props.index("nx")
        out["N"] = np.ascontiguousarray(vert[:, k:k + 3])
    if "u" in props:
        k = props.index("u")
        out["uv"] = np.ascontiguousarray(vert[:, k:k + 2])
    return out

