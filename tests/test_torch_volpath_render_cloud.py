"""``render_persistent(backend="torch")`` against the JAX package's
``render_persistent(backend="jnp")`` on the 16^3 grid cloud, pixel for
pixel (see test_torch_volpath_render.py)."""

from test_torch_volpath import cloud_scene
from test_torch_volpath_render import check_render_persistent


def test_render_persistent_matches_jax_cloud():
    check_render_persistent(cloud_scene())
