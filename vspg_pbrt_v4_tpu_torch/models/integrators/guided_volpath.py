"""Guided volumetric path tracing options and the per-wave training step
(counterpart of ``models/integrators/guided_volpath.py``).

Only what the VSPG kernel route needs is ported: ``GuidingOptions`` and
``train_step``. The XLA-style guided wave (``guided_bounce``,
``guided_wave``, ``render_guided``) is queued in ROADMAP.md §B.
"""

from __future__ import annotations

from typing import NamedTuple

from ..guiding import field as gfield


class GuidingOptions(NamedTuple):
    """Static guiding configuration (the integrator's scene-file
    parameters). The JAX package's ``surface_guiding`` (the surface half,
    triangles only) and ``refine_threshold`` (the adaptive field) wait for
    the routes they serve (ROADMAP.md §B)."""

    mode: str = "ris"  # "mis" | "ris"
    guiding_prob: float = 0.5
    volume_guiding: bool = True
    record_depth: int = 8
    train_waves: int = 128
    min_train_weight: float = 128.0
    field_res: int = 16
    n_lobes: int = 8
    # adaptive spatial refinement: not ported, anything but 0 raises
    adaptive_extra: int = 0


def train_step(field, batch):
    """One training iteration of the field on a wave's samples."""
    return gfield.field_update(field, batch)
