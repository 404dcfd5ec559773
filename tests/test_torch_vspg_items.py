"""B3a-d's work items: the render kernel (``csrc/vspg.cu``) runs every
(pixel, sample) as an item of its own, from a fresh lane state and with
the whole pixel's iteration cap, and sums the items' radiances per pixel in
sample order. Here, on the CPU, its plain versions show that this
decomposition is exact: the ordered sum (``reduce_samples_plain``) of the
items' radiances (``render_items_plain``, whose sample s is the
single-sample render ``render_vspg_plain(spp=1, first_sample=s)``) is the
per-pixel render of all samples bit for bit, so no lane state carries
from one sample into the next; where the pixel's iteration cap binds, the
sum drops the samples that the per-pixel loop loses to it, from the items'
iteration counts. The scenes are the small
ones of tests/test_torch_vspg_kernel*.py (its 16^3 cloud with a thinner
medium, to keep the lockstep plain versions at a few seconds, and the
teaser machines in it) at 12x12 pixels, on numpy-seeded synthetic fields
trained by the port, uniform and adaptive."""

import dataclasses

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import materials as M
from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding import field as gf
from vspg_pbrt_v4_tpu_torch.models.guiding import isgb as gi
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
from vspg_pbrt_v4_tpu_torch.ops.volpath_kernels import (I_MAX_EVENTS,
                                                        machine_tris)

from test_torch_vspg_distance import _unit
from test_torch_vspg_kernel import CFG, GOPT, VOPT, jax_setup
from test_torch_vspg_teaser import MATS

RES, SPP, SEED = 12, 4, 9
SS = (0.9, 0.8, 0.7)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def synthetic_guiding(seed, extra):
    """A port field trained on two numpy-seeded synthetic batches (refined
    after each at threshold 16 when `extra` > 0) and a ready ISGB."""
    rng = np.random.default_rng(seed)
    field = gf.GuidingField.make((-1.1,) * 3, (1.1,) * 3,
                                 res=4 if extra else 8, n_extra=extra,
                                 device="cpu")
    n = 4096
    for _ in range(2):
        batch = gf.TrainBatch(
            pos=_t(rng.uniform(-1, 1, (n, 3))), wi=_t(_unit(rng, n)),
            weight=_t(rng.uniform(0.1, 2.0, n)),
            radiance=_t(rng.uniform(0, 1, (n, 3))),
            distance=_t(rng.uniform(0.1, 2, n)),
            is_volume=torch.as_tensor(rng.uniform(size=n) < 0.5),
            c_vol=_t(rng.uniform(0, 1, n)), c_surf=_t(rng.uniform(0, 1, n)),
            valid=torch.ones(n, dtype=torch.bool))
        field = gf.field_update(field, batch)
        if extra:
            field = gf.refine_field(field, 16.0, max_splits=8)
    P = RES * RES
    pid = torch.arange(P)
    isgb = gi.ISGB.make((RES, RES), "variance", device="cpu")
    for w in range(2):
        isgb = gi.isgb_add_samples(
            isgb, pid, _t(rng.uniform(0, 1, (P, 3))),
            torch.full((P, 3), 0.5), _t(_unit(rng, P)),
            torch.as_tensor(rng.uniform(size=P) < 0.6), pid >= 0, half=w)
    return field, gi.isgb_update(isgb)


def scene(kind):
    """The cloud, or the machines in it as
    tests/test_torch_vspg_teaser.machines_setup places them."""
    cloud = jax_setup(ss=SS)[0]
    if kind == "cloud":
        return cloud
    g = cloud.geometry
    geom = JGeometry.build(triangles=machine_tris(), boxes=[dict(
        bmin=tuple(np.asarray(g.box_min)[0]),
        bmax=tuple(np.asarray(g.box_max)[0]), mat=-1, light=-1, med_in=0,
        med_out=-1)])
    return cloud._replace(geometry=geom, materials=M.Materials.build(MATS))


def port_inputs(kind, method, extra):
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    ts, tc, tf, tcfg = convert.from_jax(scene(kind), cam,
                                        JFilm.make((RES, RES)), CFG, "cpu")
    gopt = GOPT._replace(field_res=4 if extra else 8, adaptive_extra=extra,
                         refine_threshold=16.0)
    tg, tv = convert.options_from_jax(
        gopt, VOPT._replace(sampling_method=method))
    field, isgb = synthetic_guiding(3, extra)
    tr = None
    if method == "nds+":
        tr = _t(np.random.default_rng(8).uniform(0.3, 1.0, (RES * RES, 3)))
    return sk.kernel_inputs(ts, tc, tf, tcfg, tg, tv, field, isgb, tr)


@pytest.mark.parametrize("kind,method,extra,single", [
    ("cloud", "resampling", 0, True),
    ("cloud", "nds", 0, False),
    ("cloud", "nds+", 0, True),
    ("machines", "resampling", 0, False),
    ("cloud", "resampling", 128, False),
], ids=["resampling", "nds", "nds+", "tris", "adaptive"])
def test_items_sum_to_the_per_pixel_render(kind, method, extra, single):
    """The ordered sum of the SPP items of each pixel (every (pixel,
    sample) a lane of its own from a fresh state) equals the per-pixel
    SPP-sample render (the render wrapper's plain version for CPU tensors)
    bit for bit, with no item and no pixel at the cap. Where `single`, the
    last item is also the single-sample render from first_sample = its
    sample, bit for bit (the film's imaging ratio is 1, so that image is
    the sample's radiance)."""
    c, g, ftab, itab = port_inputs(kind, method, extra)
    assert c.imaging_ratio == 1.0 and (c.n_tri > 0) == (kind == "machines")
    assert (g.cells is not None) == (extra > 0)
    full, at_cap = sk.render_vspg_items(c, g, ftab, itab, SPP, SEED)
    assert at_cap.tolist() == [0]
    counts = {}
    L, n_it = sk.render_items_plain(c, g, ftab, itab, SPP, SEED, counts)
    assert counts["capped"] == 0 and tuple(L.shape) == (SPP, RES * RES, 3)
    cap = SPP * int(c.iconst[I_MAX_EVENTS]) * 12
    assert tuple(n_it.shape) == (SPP, RES * RES)
    assert int(n_it.min()) >= 1 and int(n_it.sum(0).max()) <= cap
    summed = sk.reduce_samples_plain(L, n_it, cap, c.imaging_ratio / SPP)
    assert torch.equal(summed.reshape(full.shape), full)
    if single:
        last = sk.render_vspg_plain(c, g, ftab, itab, 1, SEED,
                                    first_sample=SPP - 1)
        assert torch.equal(last.reshape(-1, 3), L[-1])
    assert bool((L > 0).any()) and bool(torch.isfinite(full).all())


@pytest.mark.parametrize("kind,method,max_events", [
    ("cloud", "resampling", 1), ("machines", "nds", 2)],
    ids=["resampling", "tris-nds"])
def test_items_sum_to_the_per_pixel_render_where_the_cap_binds(
        kind, method, max_events):
    """With max_events cut to 1 or 2 the pixel's cap (SPP * max_events * 12
    iterations) cuts samples in many pixels, and the per-pixel loop loses
    the sample the cap cuts and every later one. The ordered sum of the items, each run with
    the whole pixel's cap and counting its iterations (cap + 1 at the cap),
    drops the same samples: it equals the per-pixel render bit for bit, on
    the whole image and on a crop of it."""
    c, g, ftab, itab = port_inputs(kind, method, 0)
    ic = c.iconst.clone()
    ic[I_MAX_EVENTS] = max_events
    c = dataclasses.replace(c, iconst=ic)
    cap = SPP * max_events * 12
    counts = {}
    full = sk.render_vspg_plain(c, g, ftab, itab, SPP, SEED, counts)
    item_counts = {}
    L, n_it = sk.render_items_plain(c, g, ftab, itab, SPP, SEED, item_counts)
    cut = n_it.to(torch.int64).sum(0) > cap
    # the cap binds on some pixels, not on all, and stops some items
    assert counts["capped"] > 0 and 0 < int(cut.sum()) < RES * RES
    assert item_counts["capped"] == int((n_it == cap + 1).sum()) > 0
    summed = sk.reduce_samples_plain(L, n_it, cap, c.imaging_ratio / SPP)
    assert torch.equal(summed.reshape(full.shape), full)
    crop = torch.arange(3 * RES, 5 * RES)
    part = sk.render_vspg_plain(c, g, ftab, itab, SPP, SEED, pixels=crop)
    assert torch.equal(part, full.reshape(-1, 3)[crop])


@pytest.mark.parametrize("kind,method", [("cloud", "resampling"),
                                         ("machines", "nds")],
                         ids=["resampling", "tris-nds"])
def test_record_wave_draws_the_single_sample_render(kind, method):
    """A training wave draws the render's paths: the record variant's plain
    version (train_wave_plain) gives render_vspg_plain's 1-spp image at the
    same seed bit for bit and counts the same work; its record rows only
    add writes. So one plain run holds both kernels at 1 spp
    (chip_smoke.py's parity checks)."""
    c, g, ftab, itab = port_inputs(kind, method, 0)
    counts_w, counts_r = {}, {}
    img, rec = sk.train_wave_plain(c, g, ftab, itab, SEED, 6, counts_w)
    ren = sk.render_vspg_plain(c, g, ftab, itab, 1, SEED, counts_r)
    assert torch.equal(img, ren) and counts_w == counts_r
    assert bool((rec[7] > 0).any()) and bool((img > 0).any())


def test_reduce_samples_plain_adds_in_sample_order():
    """The plain reduce is the Python loop acc = acc + L[s] from zero, in
    sample order while the pixel's running iteration total stays within
    the cap, then the scale; the wrapper serves a CPU tensor with it."""
    rng = np.random.default_rng(4)
    S, P, cap = 7, 5, 40
    L = _t(rng.lognormal(0.0, 3.0, (S, P, 3)))
    n_it = torch.as_tensor(rng.integers(1, 12, (S, P)), dtype=torch.int32)
    n_it[2, 1] = cap + 1  # an item stopped at the cap
    want = torch.zeros(P, 3)
    for p in range(P):
        used = 0
        for s in range(S):
            used += int(n_it[s, p])
            if used > cap:
                break
            want[p] = want[p] + L[s, p]
    assert not torch.equal(want, L.sum(0))
    got = sk.reduce_samples_plain(L, n_it, cap, 0.125)
    assert torch.equal(got, want * 0.125)
    assert torch.equal(sk.reduce_samples(L, n_it, cap, 0.125), want * 0.125)
    with pytest.raises(ValueError):
        sk.reduce_samples(L, n_it, cap, 0.125, first=False)
