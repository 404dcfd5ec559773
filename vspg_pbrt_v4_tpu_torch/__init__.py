"""PyTorch + CUDA port of the delta-tracking volumetric path tracer.

Mirrors the layout of ``vspg_pbrt_v4_tpu`` (the JAX reference package):
``models/integrators/volpath.py`` is the torch wavefront oracle,
``ops/volpath_kernels.py`` holds the hand-written CUDA kernels for the
homogeneous-fog and grid-cloud scene classes with their plain PyTorch
versions, ``scene/`` and ``cli.py`` read and render ``.pbrt`` scene files
(``python -m vspg_pbrt_v4_tpu_torch scene.pbrt``), and ``convert.py``
turns the reference package's scene objects into this package's. Imports
torch and numpy only.
"""
