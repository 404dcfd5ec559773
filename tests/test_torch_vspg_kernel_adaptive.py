"""B3d/B4d, the VSPG kernel on an adaptive guiding field: its plain
versions against the Pallas kernel run in interpret mode on a JAX-refined
field, lane for lane, as tests/test_torch_vspg_kernel.py holds B3a/B4a.

The field (res 4: 64 coarse cells, 128 extra leaves) is trained on two
numpy-seeded synthetic batches with a refinement after each (threshold
16, 8 splits a step), so that 16 cells resolve through their children and
the children hold data of their own. The Pallas kernel reads the field
through bf16 (its leaf centres included) and its indirection as exact
bf16 halves; the port reads the bf16-rounded float32 table and an int32
indirection table, so both resolve the same leaf and read the same
parameters. Tolerances are those of tests/test_torch_vspg_kernel.py and,
with triangles, of tests/test_torch_vspg_teaser.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpk
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

from test_torch_vspg_distance import _unit
from test_torch_vspg_kernel import (CFG, GOPT, RES, VOPT, bf16_table,
                                    check_render, jax_setup, lanes_close,
                                    port_inputs, wave_rows)
from test_torch_vspg_teaser import machines_setup

FRES, EXTRA = 4, 128
AGOPT = GOPT._replace(field_res=FRES, adaptive_extra=EXTRA,
                      refine_threshold=16.0)


def refined_guiding(seed):
    """A JAX adaptive field trained on two synthetic batches, refined after
    each, and a ready JAX ISGB on synthetic pixel samples."""
    rng = np.random.default_rng(seed)
    jf = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=FRES,
                                  n_lobes=8, n_extra=EXTRA)
    n = 4096
    for _ in range(2):
        batch = jfield.TrainBatch(
            pos=jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32),
            wi=jnp.asarray(_unit(rng, n)), weight=jnp.asarray(
                rng.uniform(0.1, 2.0, n), jnp.float32),
            radiance=jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32),
            distance=jnp.asarray(rng.uniform(0.1, 2, n), jnp.float32),
            is_volume=jnp.asarray(rng.uniform(size=n) < 0.5),
            c_vol=jnp.asarray(rng.uniform(0, 1, n), jnp.float32),
            c_surf=jnp.asarray(rng.uniform(0, 1, n), jnp.float32),
            valid=jnp.ones(n, bool))
        jf = jfield.refine_field(jfield.field_update(jf, batch), 16.0,
                                 max_splits=8)
    assert int(jf.n_leaves) == FRES ** 3 + EXTRA
    ji = jisgb.ISGB.make((RES, RES), "variance", "atrous")
    pid = jnp.arange(RES * RES, dtype=jnp.int32)
    for w in range(2):
        ji = jisgb.isgb_add_samples(
            ji, pid, jnp.asarray(rng.uniform(0, 1, (RES * RES, 3)),
                                 jnp.float32),
            jnp.full((RES * RES, 3), 0.5), jnp.asarray(_unit(rng, RES * RES)),
            jnp.asarray(rng.uniform(size=RES * RES) < 0.6), pid >= 0, half=w)
    return jf, jisgb.isgb_update(ji)


def refined_fraction(field, pos, valid):
    """Fraction of the valid query positions that resolve to a child leaf."""
    cid = convert.field_from_jax(field, "cpu").cell_id(pos[valid])
    return float((cid >= FRES ** 3).float().mean())


@pytest.fixture(scope="module")
def cloud():
    scene, cam, film = jax_setup()
    return (scene, cam, film) + refined_guiding(6)


def test_adaptive_record_wave_matches_pallas(cloud):
    """B4d (RIS): train_wave_plain against train_wave_pallas(interpret=True)
    on the refined field: the image, the raw radiance and every record row
    of each lane, 0.95 of lanes (on a trained field a lane's guided draws
    can part after a last-bit difference, as the module doc of
    tests/test_torch_vspg_kernel.py states)."""
    scene, cam, film, field, isgb = cloud
    assert jpk.supports(scene, cam, film, CFG, AGOPT, VOPT, field)
    img_j, seg_j, fa_j, fn_j, fv_j, L_j, _ = jpk.train_wave_pallas(
        scene, cam, film, CFG, AGOPT, VOPT, field, isgb, seed=jnp.uint32(2),
        interpret=True)
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb, gopt=AGOPT)
    assert tuple(ftab.shape) == (8 * sk.K_PACK + 8, FRES ** 3 + EXTRA)
    assert tuple(g.cells.shape) == (3, FRES ** 3)
    img, rec = sk.train_wave_plain(c, g, bf16_table(ftab), itab, 2,
                                   AGOPT.record_depth)
    seg, fa, fn, fv = sk.records_to_segments(rec)
    L = img.reshape(-1, 3) / c.imaging_ratio
    frac = lanes_close(np.concatenate([wave_rows(img, seg, fa, fn, fv),
                                       L.numpy()], -1),
                       np.concatenate([wave_rows(img_j, seg_j, fa_j, fn_j,
                                                 fv_j), np.asarray(L_j)], -1))
    child = refined_fraction(field, seg.pos.reshape(-1, 3),
                             seg.valid.reshape(-1))
    print(f"adaptive record wave: {frac:.4f} of lanes equal within 1e-4, "
          f"{child:.4f} of record vertices in refined cells")
    assert frac >= 0.95, frac
    assert child > 0.05, child


def test_adaptive_render_matches_pallas(cloud):
    """B3d (RIS): render_vspg_plain against render_vspg_pallas(interpret=
    True) at 2 spp on the refined field."""
    scene, cam, film, field, isgb = cloud
    check_render((scene, cam, film, field, isgb), AGOPT)


def test_adaptive_teaser_render_matches_pallas():
    """B3d with triangles (the TRIS instantiation, both field halves): the
    teaser machines in the cloud on a refined field; 0.98 of pixels, means
    within 2%."""
    scene, cam, film = machines_setup()
    field, isgb = refined_guiding(7)
    ref = np.asarray(jpk.render_vspg_pallas(scene, cam, film, 2, CFG, AGOPT,
                                            VOPT, field, isgb, seed=9,
                                            interpret=True))
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb, gopt=AGOPT)
    assert c.n_tri == 48 and ftab.shape[1] == FRES ** 3 + EXTRA
    out = sk.render_vspg_plain(c, g, bf16_table(ftab), itab, 2, 9).numpy()
    d = np.abs(out - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"adaptive teaser render: {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.98, frac
    assert abs(out.mean() - ref.mean()) < 0.02 * ref.mean()
