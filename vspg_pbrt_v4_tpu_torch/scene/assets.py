"""Asynchronous loading of a scene's asset files (counterpart of the JAX
package's ``scene/assets.py``).

The reference parser starts asynchronous imports of PLY meshes and images
while directive parsing goes on (scene.cpp RunAsync in
BasicSceneBuilder::Shape/Texture). Here a prefetch pass scans the
directive list for every file the build will read and loads each on a
pool of four threads; the builder's load sites then take the futures, or
load synchronously a file the scan missed. The loaders are file I/O and
numpy, which release the GIL, so threads overlap them.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

_futures = {}  # (kind, fname) -> Future
_pool = None


def _submit(kind, fname, fn):
    global _pool
    if not fname or (kind, fname) in _futures:
        return
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=4,
                                   thread_name_prefix="asset-loader")
    _futures[(kind, fname)] = _pool.submit(fn, fname)


def _load_image(fname):
    from ..utils.image import read_image

    return read_image(fname)


def _load_ply(fname):
    from ..tools.plytool import read_ply

    return read_ply(fname)


def _load_volume(fname):
    from ..tools.nanovdb2grid import load_volume

    return load_volume(fname)


def prefetch(directives):
    """Scan `directives` and start a background load of every asset file
    the builder reads (PLY meshes, image textures, light images, volume
    grids and heightmaps), as the JAX package does."""
    from .parser import ParameterDictionary

    for d in directives:
        try:
            name = d.name
            if name not in ("Shape", "Texture", "LightSource",
                            "MakeNamedMedium"):
                continue
            p = ParameterDictionary(d.params)
            if name == "Shape" and d.args and d.args[0] == "plymesh":
                _submit("ply", p.get_string("filename"), _load_ply)
            elif (name == "Texture" and len(d.args) > 2
                  and d.args[2] == "imagemap"):
                _submit("img", p.get_string("filename"), _load_image)
            elif name == "LightSource" and d.args and d.args[0] in (
                    "goniometric", "projection", "infinite"):
                _submit("img", p.get_string("filename"), _load_image)
            elif name == "MakeNamedMedium":
                gridfile = p.get_string("gridfile",
                                        p.get_string("filename", ""))
                mtype = p.get_string("type", "")
                if gridfile and (gridfile.endswith(".nvdb")
                                 or mtype == "nanovdb"):
                    _submit("vol", gridfile, _load_volume)
                hm = p.get_string("heightmap", "")
                if hm:
                    _submit("img", hm, _load_image)
        except Exception:  # a scan miss only loses the prefetch
            continue


def _get(kind, fname, fn):
    fut = _futures.pop((kind, fname), None)
    if fut is not None:
        return fut.result()
    return fn(fname)


def get_image(fname):
    """``read_image`` through the prefetch (raises as it does)."""
    return _get("img", fname, _load_image)


def get_ply(fname):
    """``read_ply`` through the prefetch (raises as it does)."""
    return _get("ply", fname, _load_ply)


def get_volume(fname):
    """``load_volume`` through the prefetch: (density, bmin, bmax)."""
    return _get("vol", fname, _load_volume)
