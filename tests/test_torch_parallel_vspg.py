"""The port's sharded VSPG training render
(``parallel/mesh.render_vspg_sharded`` on two gloo ranks, each a process
of its own) against the JAX package's on two devices of the 8-device CPU
mesh. Each rank's lanes are the JAX shard's pixels. As for the
unsharded ``render_vspg`` (tests/test_torch_vspg_render.py), most pixels
agree exactly and the rest within Monte Carlo error: a last-bit difference
in the trained field sends a guided decision the other way."""

import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.parallel import mesh as jmesh
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.parallel import dryrun

from test_torch_parallel import (FOG_CFG, MESH, RES, W, _close, _devices,
                                 _fog)
from test_torch_vspg_kernel import QUADRANTS


def test_render_vspg_sharded_matches_jax():
    """The sharded VSPG training render (film, ISGB and TrBuffer rows by
    rank, each wave's batch gathered for one EM step on the whole wave,
    the ISGB gathered for its updates) against JAX's on two devices: at
    least 0.8 of pixels within 1e-3, each quadrant's mean difference within
    four standard errors, the same training iterations and a ready ISGB on
    both, every rank holding the same field."""
    scene, cam, film = _fog()
    gopt = jgv.GuidingOptions(field_res=4, record_depth=4,
                              min_train_weight=16.0)
    vopt = jvspg.VSPGOptions()
    spp = 4
    ref, jfield, jisgb = jmesh.render_vspg_sharded(
        scene, cam, film, spp, cfg=FOG_CFG, gopt=gopt, vopt=vopt, seed=5,
        mesh=_devices("rays"), spp_per_pass=1)
    ref = np.asarray(ref)
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, FOG_CFG, "cpu")
    tg, tv = convert.options_from_jax(gopt, vopt)
    img, field, isgb = dryrun.spawn(
        W, MESH + "render_vspg_sharded", (ts, tc, tf, spp),
        dict(cfg=tcfg, gopt=tg, vopt=tv, seed=5, spp_per_pass=1))
    img = img.numpy()
    assert field.iteration == int(jfield.iteration) > 0
    assert isgb.ready and bool(jisgb.ready)
    assert tuple(isgb.vsp_est.shape) == (RES * RES,)
    assert np.isfinite(img).all()
    frac = _close(img, ref, atol=1e-5)
    print(f"render_vspg_sharded: {frac:.4f} of pixels within 1e-3 of JAX")
    assert frac >= 0.8, frac
    for sl in QUADRANTS:
        diff = (img[sl] - ref[sl]).mean(-1).reshape(-1)
        err = diff.std(ddof=1) / np.sqrt(diff.size)
        assert abs(diff.mean()) <= 4.0 * err + 1e-6, (diff.mean(), err)
