"""The guided wave and ``render_guided`` in the RIS direction mode against
the JAX package's (the checks of test_torch_guided_volpath.py, which runs
MIS; a file of its own so that each file compiles one JAX wave)."""

import pytest

from test_torch_guided_volpath import (check_render_guided, check_wave,
                                       trained_field)


@pytest.fixture(scope="module")
def trained_ris():
    return trained_field("ris")


@pytest.mark.parametrize("which", ["untrained", "trained"])
def test_guided_wave_ris_matches_jax(which, trained_ris):
    check_wave("ris", which, trained_ris)


def test_render_guided_ris_matches_jax():
    check_render_guided("ris")
