"""Render checkpoints: the film's accumulation state, the samples done and
the seed in one npz, in the JAX package's layout (``utils/checkpoint.py``:
``rgb_sum``, ``weight_sum``, ``splat_sum``, ``spp_done``, ``seed``), so
that an interrupted progressive render resumes exactly. This package's
film has no splats: it writes zeros and refuses a checkpoint that holds
any."""

from __future__ import annotations

import numpy as np
import torch

from ..models.film import FilmState


def save_render_state(path, film_state: FilmState, spp_done: int, seed: int):
    rgb = film_state.rgb_sum.cpu().numpy()
    np.savez(path, rgb_sum=rgb, weight_sum=film_state.weight_sum.cpu().numpy(),
             splat_sum=np.zeros_like(rgb), spp_done=spp_done, seed=seed)


def load_render_state(path, device="cuda"):
    """(FilmState on `device`, spp_done, seed)."""
    d = np.load(path)
    if np.any(d["splat_sum"]):
        raise NotImplementedError(f"{path}: splats (BDPT, light tracing) are "
                                  "not ported yet")
    state = FilmState(torch.as_tensor(d["rgb_sum"], device=device),
                      torch.as_tensor(d["weight_sum"], device=device))
    return state, int(d["spp_done"]), int(d["seed"])
