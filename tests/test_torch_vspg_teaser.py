"""B3c/B4c, the VSPG kernel with triangles: its plain versions against the
Pallas kernel run in interpret mode on the teaser machines (48 triangles:
glass, metal and a diffuse part) in the bf16-exact 16^3 cloud of
tests/test_torch_vspg_kernel.py, RIS direction mode (the MIS mode has its
own file). A JAX record wave on a fresh field, then the frozen render on
the field and ISGB it trained, the port fed the bf16-rounded field table.
Both run the same per-lane machine on the same random stream, so they
agree lane by lane except where the port does not copy a fault of the
Pallas kernel: a surface NEE's shadow walk there starts from the previous
walk's transmittance (ROADMAP.md §C), which moves the few lanes whose
surface NEE follows another walk."""

import jax.numpy as jnp
import numpy as np
import pytest

from vspg_pbrt_v4_tpu.models import materials as M
from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu.models.guiding import recording as jrec
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
from vspg_pbrt_v4_tpu_torch.ops.volpath_kernels import machine_tris

from test_torch_vspg_kernel import (CFG, GOPT, RES, VOPT, bf16_table,
                                    exit_lanes, jax_setup, lanes_close,
                                    port_inputs, wave_rows)

MATS = [dict(type=M.DIFFUSE, albedo=(0.65, 0.3, 0.2)),
        dict(type=M.DIELECTRIC, eta=1.5, roughness=0.0),
        dict(type=M.CONDUCTOR, albedo=(0.9, 0.75, 0.5), roughness=0.0)]


def machines_setup():
    """The lit cloud of jax_setup with the bench's machines in it."""
    scene, cam, film = jax_setup()
    g = scene.geometry
    geom = JGeometry.build(triangles=machine_tris(), boxes=[dict(
        bmin=tuple(np.asarray(g.box_min)[0]),
        bmax=tuple(np.asarray(g.box_max)[0]), mat=-1, light=-1, med_in=0,
        med_out=-1)])
    return (scene._replace(geometry=geom, materials=M.Materials.build(MATS)),
            cam, film)


def record_then_render(mode):
    """(record-wave lane fraction, render pixel fraction, render means):
    the plain versions against the interpret-mode Pallas kernel."""
    scene, cam, film = machines_setup()
    gopt = GOPT._replace(mode=mode)
    field = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=8,
                                     n_lobes=8)
    isgb = jisgb.ISGB.make((RES, RES), "variance", "atrous")
    img_j, seg_j, fa_j, fn_j, fv_j, L_j, _ = jpk.train_wave_pallas(
        scene, cam, film, CFG, gopt, VOPT, field, isgb, seed=jnp.uint32(1),
        interpret=True)
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb, gopt=gopt)
    assert c.n_tri == 48 and tuple(ftab.shape) == (80, 512)
    counts = {}
    img, rec = sk.train_wave_plain(c, g, ftab, itab, 1, GOPT.record_depth,
                                   counts)
    seg, fa, fn, fv = sk.records_to_segments(rec)
    # surface vertices (row 18 zero) are recorded
    assert bool((seg.valid & ~seg.is_volume).any())
    f_rec = lanes_close(wave_rows(img, seg, fa, fn, fv),
                        wave_rows(img_j, seg_j, fa_j, fn_j, fv_j))
    pid = jnp.arange(RES * RES, dtype=jnp.int32)
    isgb = jisgb.isgb_update(jisgb.isgb_add_samples(
        isgb, pid, L_j, fa_j, fn_j, fv_j, pid >= 0, half=0))
    field = jgv.train_step(field, jrec.propagate(seg_j))
    ref = np.asarray(jpk.render_vspg_pallas(scene, cam, film, 2, CFG, gopt,
                                            VOPT, field, isgb, seed=9,
                                            interpret=True))
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb, gopt=gopt)
    out = sk.render_vspg_plain(c, g, bf16_table(ftab), itab, 2, 9,
                               counts).numpy()
    # no lane of either run starts at the box's exit
    assert exit_lanes(counts) == 0, counts
    d = np.abs(out - ref)
    f_ren = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"teaser ({mode}): record {f_rec:.4f} of lanes, render "
          f"{f_ren:.4f} of pixels")
    return f_rec, f_ren, out.mean(), ref.mean()


@pytest.mark.parametrize("mode", ["ris"])
def test_teaser_plain_matches_pallas(mode):
    """0.98 of lanes and pixels (measured 0.9961 and 0.9961 on this CPU)."""
    f_rec, f_ren, m, m_ref = record_then_render(mode)
    assert f_rec >= 0.98 and f_ren >= 0.98, (f_rec, f_ren)
    assert abs(m - m_ref) < 0.02 * m_ref
