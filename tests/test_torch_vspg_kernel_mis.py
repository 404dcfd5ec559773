"""B3a/B4a in their MIS direction mode (``GuidingOptions(mode="mis")``:
one-sample MIS of the phase function and the guiding mixture, where the
main path runs RIS): the plain versions against the Pallas kernel run in
interpret mode, on the JAX-trained field and scene of
test_torch_vspg_kernel.py, with its tolerances and their reasons. The
field must be trained: a fresh one guides no direction."""

import jax.numpy as jnp

from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpk

from test_torch_vspg_kernel import (CFG, GOPT, VOPT, bf16_table,
                                    check_record_wave, check_render,
                                    port_inputs)
# the module fixtures of that file: one JAX wave trains the field
from test_torch_vspg_kernel import trained, wave  # noqa: F401

MIS = GOPT._replace(mode="mis")


def test_record_wave_mis_matches_pallas(trained):  # noqa: F811
    """A record wave on the trained field, both sides reading the same
    bf16-rounded table."""
    scene, cam, film, field, isgb = trained
    out = jpk.train_wave_pallas(scene, cam, film, CFG, MIS, VOPT, field,
                                isgb, seed=jnp.uint32(4), interpret=True)
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb, gopt=MIS)
    assert not g.ris
    check_record_wave(out, (c, g, bf16_table(ftab), itab), 4,
                      MIS.record_depth)


def test_render_mis_matches_pallas(trained):  # noqa: F811
    check_render(trained, MIS)
