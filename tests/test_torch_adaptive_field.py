"""The port's adaptive two-level guiding field against the JAX package's on
the same numpy inputs: ``make``, the two-stage ``cell_id`` and the leaf
centres, ``refine_field`` array for array (a split, a threshold no cell
reaches, the capacity clamp, ``max_splits``), a training step on a refined
field, and ``field_from_jax``/``options_from_jax`` carrying the adaptive
arrays and ``refine_threshold``.

``make``, ``cell_id``, the centres and ``refine_field`` are exact: the same
float32 formulas, the cells picked on the host by numpy's argsort on both
sides. The training step holds 1e-5 relative (1e-6 absolute): its
scatter-add sums run in another order."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch.convert import field_from_jax, options_from_jax
from vspg_pbrt_v4_tpu_torch.models.guiding import field as tfield

B0, B1 = (-1.1, -1.0, -0.9), (1.1, 1.2, 1.0)
RES, EXTRA = 4, 128
C = RES ** 3


def _same(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def _same_field(t, j):
    """Every array of two fields equal, the adaptive ones included."""
    assert (t.res, t.n_lobes, t.n_extra, t.n_leaves) == (
        j.res, j.n_lobes, j.n_extra, int(j.n_leaves))
    for name in ("b_min", "b_max", "leaf_of", "refined", "child_base",
                 "leaf_center"):
        _same(getattr(t, name), getattr(j, name))
    for half in ("surface", "volume"):
        for f in tfield.FieldHalf.__dataclass_fields__:
            _same(getattr(getattr(t, half), f), getattr(getattr(j, half), f))


def _points(n=4096, seed=2):
    """Seeded points over the box and past it, with points on the upper
    and lower faces (clamped: their octant is 7 or 0 on that axis) and on
    the cell boundaries."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    b0, b1 = np.asarray(B0, np.float32), np.asarray(B1, np.float32)
    p[:64] = np.where(rng.uniform(size=(64, 3)) < 0.5, b1, b0)
    k = rng.integers(0, RES + 1, (64, 3))
    p[64:128] = b0 + k / RES * (b1 - b0)
    return p


def _stats(seed):
    """Seeded EM masses: a few heavy coarse cells, the rest light."""
    rng = np.random.default_rng(seed)
    sw = rng.uniform(0, 4, (C + EXTRA, 8)).astype(np.float32)
    sw[rng.choice(C, 24, replace=False)] += rng.uniform(
        10, 80, (24, 1)).astype(np.float32)
    return sw


@pytest.fixture(scope="module")
def fields():
    """A fresh adaptive JAX field with seeded masses in both halves, and
    the port's copy."""
    j = jfield.GuidingField.make(B0, B1, res=RES, n_lobes=8, n_extra=EXTRA)
    j = j.replace(surface=j.surface.replace(stats_w=jnp.asarray(_stats(1))),
                  volume=j.volume.replace(stats_w=jnp.asarray(_stats(2))))
    return j, field_from_jax(j, "cpu")


def test_make_matches_jax():
    """A fresh adaptive field: leaf-sized halves, the grid centres in the
    first C leaf centres, identity indirection."""
    j = jfield.GuidingField.make(B0, B1, res=RES, n_lobes=8, n_extra=EXTRA)
    t = tfield.GuidingField.make(B0, B1, res=RES, n_lobes=8, n_extra=EXTRA,
                                 device="cpu")
    _same_field(t, j)
    assert t.volume.weights.shape == (C + EXTRA, 8)


@pytest.mark.parametrize("splits", [0, 1])
def test_cell_id_and_center_match_jax(fields, splits):
    """cell_id on 4096 seeded points (face and boundary points included)
    and the leaf centre each resolves to, on the fresh field and after one
    refinement."""
    j, t = fields
    if splits:
        j, t = (jfield.refine_field(j, 20.0),
                tfield.refine_field(t, 20.0))
        assert t.n_leaves > C
    p = _points()
    cj = j.cell_id(jnp.asarray(p))
    ct = t.cell_id(torch.as_tensor(p))
    _same(ct, cj)
    assert bool((ct < t.n_leaves).all())
    if splits:
        assert bool((ct >= C).any())
    _same(tfield._cell_center(t, ct), jfield._cell_center(j, cj))


@pytest.mark.parametrize("case", ["split", "none", "capacity", "max_splits"])
def test_refine_field_matches_jax(fields, case):
    """refine_field array for array: a split (threshold 20, the default 16
    splits), a threshold no cell reaches, the capacity clamp (threshold 0,
    more splits asked than leaves free) and max_splits 3."""
    j, t = fields
    thr, ms = {"split": (20.0, 16), "none": (1e9, 16),
               "capacity": (0.0, 1000), "max_splits": (20.0, 3)}[case]
    j2, t2 = jfield.refine_field(j, thr, ms), tfield.refine_field(t, thr, ms)
    _same_field(t2, j2)
    want = {"split": C + 8 * 16, "none": C, "capacity": C + EXTRA,
            "max_splits": C + 24}[case]
    assert t2.n_leaves == want, t2.n_leaves
    # the refinement of a full field splits nothing more
    if case == "capacity":
        _same_field(tfield.refine_field(t2, 0.0, 1000), j2)


def test_refine_addressing():
    """tests/test_adaptive_field.py::test_refine_addressing on the port:
    a split maps the cell's octants to 8 fresh leaves, unrefined cells keep
    their identity, children inherit the parent's distribution with 1/8 of
    its statistics, a field below the threshold splits no further, and the
    capacity clamp holds."""
    f = tfield.GuidingField.make((-1, -1, -1), (1, 1, 1), res=4, n_lobes=4,
                                 n_extra=64, device="cpu")
    cid = int(f.cell_id(torch.tensor([[0.9, 0.9, 0.9]]))[0])
    sw = torch.zeros((C + 64, 4))
    sw[cid] = 200.0
    f = tfield.replace(f, surface=tfield.replace(f.surface, stats_w=sw))
    f2 = tfield.refine_field(f, threshold=100.0)
    assert f2.n_leaves == C + 8
    assert int(f2.refined.sum()) == 1
    ps = [list(o) for o in itertools.product([0.63, 0.88], repeat=3)]
    leaves = f2.cell_id(torch.tensor(ps))
    assert len(set(leaves.tolist())) == 8
    assert int(leaves.min()) == C
    # children together conserve the parent's mass (200 x 4 lobes = 800)
    assert np.isclose(float(f2.surface.stats_w[C:C + 8].sum()), 800.0,
                      rtol=1e-5)
    assert np.isclose(float(f2.surface.stats_w[C].sum()), 100.0, rtol=1e-5)
    f3 = tfield.refine_field(f2, threshold=100.0)
    assert f3.n_leaves == f2.n_leaves
    assert int(f2.cell_id(torch.tensor([[-0.9, -0.9, -0.9]]))[0]) < C
    f4 = tfield.refine_field(f2, threshold=0.0, max_splits=1000)
    assert f4.n_leaves <= C + 64


def test_field_update_on_refined_field_matches_jax(fields):
    """One training step on a refined field: the EM update and every
    statistic over all L leaves (the EM weight clamp's 0.99 quantile runs
    over the batch's samples, not the rows), samples landing in children
    and in unrefined cells alike."""
    j, t = fields
    j, t = jfield.refine_field(j, 20.0), tfield.refine_field(t, 20.0)
    rng = np.random.default_rng(5)
    n = 2048
    wi = rng.standard_normal((n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    cols = dict(
        pos=rng.uniform(-1.1, 1.2, (n, 3)).astype(np.float32), wi=wi,
        weight=rng.uniform(0.1, 3.0, n).astype(np.float32),
        radiance=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        distance=rng.uniform(0.05, 2.0, n).astype(np.float32),
        is_volume=rng.uniform(size=n) < 0.5,
        c_vol=rng.uniform(0, 1, n).astype(np.float32),
        c_surf=rng.uniform(0, 1, n).astype(np.float32),
        valid=rng.uniform(size=n) < 0.9)
    cid = t.cell_id(torch.as_tensor(cols["pos"]))
    assert bool((cid >= C).any()) and bool((cid < C).any())
    jb = jfield.TrainBatch(**{k: jnp.asarray(v) for k, v in cols.items()})
    tb = tfield.TrainBatch(**{k: torch.as_tensor(v)
                              for k, v in cols.items()})
    j2, t2 = jgv.train_step(j, jb), tfield.field_update(t, tb)
    assert t2.iteration == int(j2.iteration) == 1
    for half in ("surface", "volume"):
        for f in tfield.FieldHalf.__dataclass_fields__:
            np.testing.assert_allclose(
                getattr(getattr(t2, half), f).numpy(),
                np.asarray(getattr(getattr(j2, half), f)), rtol=1e-5,
                atol=1e-6, err_msg=f"{half}.{f}")


def test_convert_carries_the_adaptive_field(fields):
    """field_from_jax carries the five adaptive arrays and n_extra;
    options_from_jax carries adaptive_extra and refine_threshold (a JAX
    threshold of 16 stays 16, not the default 256)."""
    j, _ = fields
    j = jfield.refine_field(j, 20.0)
    _same_field(field_from_jax(j, "cpu"), j)
    tg, _ = options_from_jax(
        jgv.GuidingOptions(adaptive_extra=EXTRA, refine_threshold=16.0),
        jvspg.VSPGOptions())
    assert (tg.adaptive_extra, tg.refine_threshold) == (EXTRA, 16.0)
