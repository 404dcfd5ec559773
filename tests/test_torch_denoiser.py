"""The port's kernel-predicting U-Net ISGB denoiser
(``models/guiding/denoiser.py``) and the ISGB's ``unet`` branch against the
JAX package's, on JAX's weights (``denoiser_params_from_jax``) and seeded
numpy images at width 4 and 16x16: the kernels, their application, a
gradient, an Adam step, a short training run, the first ISGB update and
the buffer's files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import denoiser as jd
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding import denoiser as td
from vspg_pbrt_v4_tpu_torch.models.guiding import isgb as tisgb

import test_torch_volpath  # noqa: F401  (one torch thread a process)

W, NY, NX = 4, 16, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(seed=0, scale=0.1):
    """JAX parameters at width 4 with every leaf moved off its init, so
    that the head is not the Gaussian's."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + scale * jnp.asarray(rng.standard_normal(a.shape),
                                          jnp.float32),
        jd.init_params(width=W))


def _images(seed=1):
    rng = np.random.default_rng(seed)

    def img(*c):
        return rng.uniform(0, 2, (NY, NX) + c).astype(np.float32)

    ca, cb, cf, alb, nrm = (img(3) for _ in range(5))
    na = rng.integers(0, 3, (NY, NX)).astype(np.float32)
    nb = rng.integers(0, 3, (NY, NX)).astype(np.float32)
    vsp = rng.uniform(-1, 1, (NY, NX)).astype(np.float32)
    return ca, cb, cf, alb, nrm, na, nb, vsp


def _named(tree):
    return {k: v.numpy() for k, v in td.named_from_jax(_np(tree)).items()}


def test_kernels_and_their_application_match_jax():
    jp = _perturbed()
    net = td.denoiser_params_from_jax(_np(jp))
    ca, _, cf, alb, nrm, na, _, _ = _images()
    fj = jd.make_features(*(jnp.asarray(a) for a in (ca, alb, nrm, na)))
    ft = td.make_features(*(torch.as_tensor(a) for a in (ca, alb, nrm, na)))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-6)
    kj = np.array(jd.predict_kernels(jp, fj))
    kt = td.predict_kernels(net, ft).detach().numpy()
    np.testing.assert_allclose(kt, kj, rtol=0, atol=1e-5)
    assert kj.std() > 1e-3  # not the Gaussian
    np.testing.assert_allclose(
        td.apply_kernels(torch.as_tensor(kj), torch.as_tensor(cf)[None])
        .numpy(),
        np.asarray(jd.apply_kernels(jnp.asarray(kj), jnp.asarray(cf)[None])),
        rtol=0, atol=1e-5)


def test_untrained_head_is_the_gaussian_and_keeps_a_constant():
    """The port's own initial weights (a torch.Generator seeded with 7):
    zero head weights make every pixel's kernel the 5x5 Gaussian, and a
    constant image maps to itself."""
    net = td.UNet(width=W)
    ca, _, _, alb, nrm, na, _, _ = _images()
    f = td.make_features(*(torch.as_tensor(a) for a in (ca, alb, nrm, na)))
    k = td.predict_kernels(net, f).detach()
    g = np.exp(td._gaussian_log_bias())
    np.testing.assert_allclose(k.numpy(), np.broadcast_to(g, k.shape),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.exp(np.asarray(jd._gaussian_log_bias())), g, rtol=1e-6)
    const = torch.full((1, NY, NX, 3), 0.37)
    np.testing.assert_allclose(td.apply_kernels(k, const).numpy(), 0.37,
                               rtol=1e-5)


def _loss_inputs():
    ca, cb, _, alb, nrm, na, nb, _ = _images()
    wa = (na > 0).astype(np.float32)[..., None]
    wb = (nb > 0).astype(np.float32)[..., None]
    fa = [ca, alb, nrm, na]
    fb = [cb, alb, nrm, nb]
    j = (jd.make_features(*map(jnp.asarray, fa)),
         jd.make_features(*map(jnp.asarray, fb)),
         jnp.asarray(ca)[None], jnp.asarray(cb)[None], jnp.asarray(wa),
         jnp.asarray(wb))
    t = (td.make_features(*map(torch.as_tensor, fa)),
         td.make_features(*map(torch.as_tensor, fb)),
         torch.as_tensor(ca)[None], torch.as_tensor(cb)[None],
         torch.as_tensor(wa), torch.as_tensor(wb))
    return j, t


def test_gradient_matches_jax_grad():
    """torch.autograd of _loss against jax.grad, each leaf within 1e-4 of
    that leaf's largest magnitude."""
    jp = _perturbed()
    net = td.denoiser_params_from_jax(_np(jp))
    j, t = _loss_inputs()
    gj = _named(jax.grad(jd._loss)(jp, *j))
    loss = td._loss(net, *t)
    np.testing.assert_allclose(loss.item(), float(jd._loss(jp, *j)),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    for (k, _), g in zip(net.named_parameters(), grads):
        bound = 1e-4 * max(np.abs(gj[k]).max(), 1e-30)
        assert np.abs(g.numpy() - gj[k]).max() <= bound, k


@pytest.mark.parametrize("i", [0, 2])
def test_adam_step_matches_jax(i):
    """One Adam step of the JAX loop (its step i, bias correction at t =
    i + 1) and the port's adam_step fed the same gradient, from moments
    that are not zero."""
    jp = _perturbed()
    rng = np.random.default_rng(5)
    jm = jax.tree.map(lambda a: 0.01 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), jp)
    jv = jax.tree.map(lambda a: 1e-4 * jnp.asarray(
        rng.uniform(size=a.shape), jnp.float32), jp)
    j, _ = _loss_inputs()
    g = jax.grad(jd._loss)(jp, *j)
    out = jd.train_step_factory()(i, (jp, jm, jv, *j))
    net = td.denoiser_params_from_jax(_np(jp))
    names = [k for k, _ in net.named_parameters()]
    grads = [torch.as_tensor(_named(g)[k]) for k in names]
    m2, v2 = td.adam_step(net, {k: torch.as_tensor(a) for k, a in
                                _named(jm).items()},
                          {k: torch.as_tensor(a) for k, a in
                           _named(jv).items()}, grads, i + 1)
    want_p, want_m, want_v = (_named(out[0]), _named(out[1]),
                              _named(out[2]))
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k], rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(m2[k].numpy(), want_m[k], atol=1e-6)
        np.testing.assert_allclose(v2[k].numpy(), want_v[k], atol=1e-6)


def _train_both(n_b_scale=1.0, steps=4):
    jp = _perturbed()
    net = td.denoiser_params_from_jax(_np(jp))
    ca, cb, cf, alb, nrm, na, nb, vsp = _images()
    nb = nb * n_b_scale
    args = (ca, na, cb, nb, cf, na + nb, alb, nrm, vsp)
    rj = jd.train_and_denoise(jp, None, *map(jnp.asarray, args),
                              steps=steps)
    rt = td.train_and_denoise(net, None, *map(torch.as_tensor, args),
                              steps=steps)
    return jp, net, rj, rt


def test_train_and_denoise_matches_jax():
    """Four training steps, then the denoised color and VSP within 1e-3
    relative on at least 99% of pixels. (Adam's division turns
    near-zero gradients into full-size steps, so longer runs part; the
    parameters are held to JAX's through the single step above.)"""
    _, net0, rj, rt = _train_both()
    for a, b in ((rj[2], rt[2]), (rj[3], rt[3])):
        a, b = np.asarray(a), b.numpy()
        rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
        ok = (rel <= 1e-3).reshape(NY, NX, -1).all(-1)
        assert ok.mean() >= 0.99, ok.mean()
    # the weights trained, on a copy
    assert any(not torch.equal(p, q) for p, q in
               zip(net0.parameters(), rt[0].parameters()))


def test_an_empty_half_skips_training():
    """With the B half empty (the first wave) the net and Adam's state come
    back unchanged, as JAX's lax.cond keeps them."""
    _, net0, rj, rt = _train_both(n_b_scale=0.0)
    for p, q in zip(net0.parameters(), rt[0].parameters()):
        assert torch.equal(p, q)
    assert all(float(v.abs().max()) == 0 for v in rt[1][0].values())
    np.testing.assert_allclose(rt[2].numpy(), np.asarray(rj[2]), atol=1e-5)


def _buffers():
    """A JAX ISGB with the U-Net after one even wave of seeded samples."""
    rng = np.random.default_rng(9)
    P = NX * NY
    jb = jisgb.ISGB.make((NX, NY), "variance", "unet")
    jb = jisgb.isgb_add_samples(
        jb, jnp.arange(P), jnp.asarray(rng.uniform(0, 2, (P, 3)), jnp.float32),
        jnp.asarray(rng.uniform(0, 1, (P, 3)), jnp.float32),
        jnp.asarray(rng.uniform(-1, 1, (P, 3)), jnp.float32),
        jnp.asarray(rng.uniform(size=P) < 0.5),
        jnp.asarray(rng.uniform(size=P) < 0.9), half=0)
    return jb, convert.isgb_from_jax(jb, "cpu")


def test_first_isgb_update_matches_jax():
    """The first update with the U-Net (no B samples yet: the Gaussian
    head filters the buffer and the VSP map) within 1e-5; the net and its
    moments come across from JAX's buffer."""
    jb, tb = _buffers()
    assert tb.denoiser == "unet" and tb.net[0].enc0a.out_channels == 12
    j2, t2 = jisgb.isgb_update(jb), tisgb.isgb_update(tb)
    assert t2.ready
    for f in ("contrib_est", "vsp_est"):
        np.testing.assert_allclose(getattr(t2, f).numpy(),
                                   np.asarray(getattr(j2, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert (t2.vsp_est.numpy() >= 0).any()


def test_isgb_files_across_packages(tmp_path):
    """save_isgb/load_isgb round trip in the port; a file that JAX wrote
    loads equal to isgb_from_jax; the port's file loads in JAX with every
    leaf equal."""
    jb, tb = _buffers()
    jb = jisgb.isgb_update(jb)
    tb = convert.isgb_from_jax(jb, "cpu")
    jisgb.save_isgb(jb, str(tmp_path / "j.npz"))
    tisgb.save_isgb(tb, str(tmp_path / "t.npz"))
    for path in ("j.npz", "t.npz"):
        got = tisgb.load_isgb(str(tmp_path / path), device="cpu")
        assert (got.ready, got.resolution, got.vsp_criterion,
                got.denoiser) == (True, (NX, NY), "variance", "unet")
        for f in tisgb._ARRAYS:
            assert torch.equal(getattr(got, f), getattr(tb, f)), f
        for a, b in zip(got.net[0].parameters(), tb.net[0].parameters()):
            assert torch.equal(a, b)
        for sa, sb in zip(got.net[1], tb.net[1]):
            assert all(torch.equal(sa[k], sb[k]) for k in sb)
    back = jisgb.load_isgb(str(tmp_path / "t.npz"))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jb)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    atrous = tisgb.ISGB.make((4, 2), device="cpu")
    tisgb.save_isgb(atrous, str(tmp_path / "a.npz"))
    a2 = tisgb.load_isgb(str(tmp_path / "a.npz"), device="cpu")
    assert a2.net is None and a2.denoiser == "atrous"
    assert jisgb.load_isgb(str(tmp_path / "a.npz")).resolution == (4, 2)
