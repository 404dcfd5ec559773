"""The port's multi-device entry points (``parallel/mesh.py`` on
``torch.distributed``) against the JAX package's (``parallel/mesh.py`` on a
``jax.sharding.Mesh``), two devices each: two gloo ranks, each a process of
its own that imports torch and the port only (``parallel.dryrun.spawn``),
against two devices of the 8-device CPU mesh that tests/conftest.py sets.
A lane's random stream depends on the draws its batch made, so each rank
traces exactly the pixels of the JAX shard, and the volpath entry points agree
pixel for pixel. The VSPG entry points: tests/test_torch_parallel_vspg.py (the
training render) and tests/test_torch_parallel_kernel.py (the kernel
route)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.parallel import mesh as jmesh
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.parallel import dryrun, mesh

W = 2
MESH = "vspg_pbrt_v4_tpu_torch.parallel.mesh:"  # spawn's job names
RES = 16
FOG_CFG = jv.VolPathConfig(max_depth=8, max_events=32)


def _devices(axis):
    return Mesh(np.asarray(jax.devices("cpu")[:W]), (axis,))


def _fog():
    """tests/test_mesh.py's fog box, camera and film at RES^2."""
    scene = jv.make_fog_box_scene(
        [0.02] * 3, [0.6] * 3, g=0.3, env_L=[0.4, 0.4, 0.4],
        point=((0.0, 1.8, 0.0), (6.0, 6.0, 6.0)))
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    return scene, cam, JFilm.make((RES, RES))


def _close(img, ref, rtol=1e-3, atol=1e-6):
    d = np.abs(img - ref)
    return ((d <= rtol * np.abs(ref)) | (d <= atol)).all(-1).mean()


@pytest.mark.parametrize("entry,spp", [("render_sharded", 4),
                                        ("render_spp_psum", 2)])
def test_volpath_entry_points_match_jax(entry, spp):
    """Rows sharded (each rank its block of pixels for every wave) and
    samples sharded (each rank the whole frame at its own sample indices,
    all-reduced): at least 0.99 of pixels within 1e-3 relative or 1e-6
    absolute of JAX's on two devices."""
    scene, cam, film = _fog()
    axis = "rays" if entry == "render_sharded" else "spp"
    ref = np.asarray(getattr(jmesh, entry)(scene, cam, film, spp, FOG_CFG,
                                            3, mesh=_devices(axis)))
    port = convert.from_jax(scene, cam, film, FOG_CFG, "cpu")
    img = dryrun.spawn(W, MESH + entry,
                       (*port[:3], spp, port[3], 3)).numpy()
    assert img.shape == ref.shape == (RES, RES, 3)
    frac = _close(img, ref)
    print(f"{entry}: {frac:.4f} of pixels within 1e-3 of JAX")
    assert np.isfinite(img).all() and frac >= 0.99, frac


def test_entry_points_need_a_process_group():
    """Without an initialised process group every entry point raises; none
    falls back to a world of one."""
    port = convert.from_jax(*_fog(), FOG_CFG, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.render_sharded(*port[:3], 1, port[3], 0, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.default_group("cpu")


def test_dryrun_prints_ok(capsys):
    """The dry run on two gloo ranks: the four entry points on its demo scenes,
    the kernel route equal to the unsharded render on both ranks."""
    assert dryrun.main(["--world", "2", "--cpu", "--res", "16"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): ok; rays-sharded mean=" in out
    assert "vspg-kernel-sharded mean=" in out

