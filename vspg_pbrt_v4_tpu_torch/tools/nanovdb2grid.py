"""Volume-grid import tool (role of ``cmd/nanovdb2pbrt.cpp``; this
package's copy of the JAX package's ``tools/nanovdb2grid.py``).

Converts volume data into the renderer's dense-grid npz format (density +
bounds), consumable via ``GridMedium.make`` or the scene-side
``MakeNamedMedium "uniformgrid" "string gridfile"`` parameter.

Supported inputs:
- .npy / .npz dense density arrays (nx,ny,nz) [+ optional bmin/bmax keys]
- .vdb via pyopenvdb where it is installed
- .nvdb via the pure-numpy NanoVDB reader (tools/nvdb.read_nvdb,
  uncompressed float grids; round-trip tested against tools/nvdb
  .write_nvdb). World bounds come from the grid's world bbox.

Usage:
    python -m vspg_pbrt_v4_tpu_torch.tools.nanovdb2grid in.npy out.npz \
        [--bmin x y z] [--bmax x y z] [--downsample N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_volume(path):
    """Returns (density (nx,ny,nz) float32, bmin (3,), bmax (3,)) or
    raises ValueError with a pointer to the conversion path."""
    if path.endswith(".npy"):
        d = np.load(path)
        return np.asarray(d, np.float32), None, None
    if path.endswith(".npz"):
        z = np.load(path)
        d = np.asarray(z["density"], np.float32)
        bmin = np.asarray(z["bmin"], np.float32) if "bmin" in z else None
        bmax = np.asarray(z["bmax"], np.float32) if "bmax" in z else None
        return d, bmin, bmax
    if path.endswith(".vdb"):
        try:
            import pyopenvdb
        except ImportError as e:
            raise ValueError(
                ".vdb import needs pyopenvdb, which is not installed; "
                "convert offline to .npy") from e
        grid = pyopenvdb.readAllGridMetadata(path)[0]
        grid = pyopenvdb.read(path, grid.name)
        bbox = grid.evalActiveVoxelBoundingBox()
        dims = [bbox[1][i] - bbox[0][i] + 1 for i in range(3)]
        arr = np.zeros(dims, np.float32)
        grid.copyToArray(arr, ijk=bbox[0])
        return arr, np.asarray(bbox[0], np.float32), np.asarray(
            bbox[1], np.float32) + 1
    if path.endswith(".nvdb"):
        from .nvdb import read_nvdb

        dens, org, vs, wbb = read_nvdb(path)
        bmin = org.astype(np.float32) * vs
        bmax = bmin + np.asarray(dens.shape, np.float32) * vs
        return dens, bmin, bmax
    raise ValueError(f"unknown volume format: {path}")


def convert(in_path, out_path, bmin=None, bmax=None, downsample=1):
    d, file_bmin, file_bmax = load_volume(in_path)
    if downsample > 1:
        k = int(downsample)
        nx, ny, nz = (s // k * k for s in d.shape)
        d = d[:nx, :ny, :nz].reshape(
            nx // k, k, ny // k, k, nz // k, k).mean((1, 3, 5))
    bmin = np.asarray(bmin if bmin is not None else
                      (file_bmin if file_bmin is not None else (0, 0, 0)),
                      np.float32)
    bmax = np.asarray(bmax if bmax is not None else
                      (file_bmax if file_bmax is not None else d.shape),
                      np.float32)
    np.savez_compressed(out_path, density=d.astype(np.float32),
                        bmin=bmin, bmax=bmax)
    return d.shape, bmin, bmax


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nanovdb2grid")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--bmin", nargs=3, type=float, default=None)
    ap.add_argument("--bmax", nargs=3, type=float, default=None)
    ap.add_argument("--downsample", type=int, default=1)
    args = ap.parse_args(argv)
    try:
        shape, bmin, bmax = convert(args.input, args.output, args.bmin,
                                    args.bmax, args.downsample)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {args.output}: {shape} voxels, bounds {bmin} .. {bmax}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
