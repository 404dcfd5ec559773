"""``volpath.render`` of the earth medium in a box pixel for pixel with the
JAX package's XLA render (a file of its own: one JAX render compile)."""

from test_torch_media_ext import check_render


def test_render_earth_matches_jax():
    """The earth medium with a generated heightmap, at 32x32x2."""
    check_render("earth")
