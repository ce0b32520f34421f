"""The port's learned whiteners against the JAX package's, on the host
(``device="cpu"``): VICReg (``Projector``, ``vicreg_loss``,
``VICRegWhitener``) and FactorVAE (its three modules, ``permute_dims``,
``reparameterize``, ``kl_divergence``, ``FactorVAE``,
``latent_correlation_diagnostics``).

The flax parameters are carried into the port's modules, then both
packages take the same batches; FactorVAE's steps take the JAX package's
draws (its ``k_z`` normal noise and the argsorts of its ``k_perm1`` and
``k_perm2`` uniforms), recomputed here from the JAX trainer's key.
Tolerances: losses and each metric 1e-5 relative a step, parameters
``atol=1e-5, rtol=1e-4`` after five steps: the same float32 arithmetic
in another order (~1e-7 relative a value), summed over a few hundred
terms, carried by Adam's lr x m / sqrt(v) steps.  Sizes: 24-d rows,
hidden 64, z_dim 8, batches of 32-64."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.training import factorvae as jfv
from rag_cobweb_tpu.training import vicreg as jvr
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.bench import train_steps
from rag_cobweb_tpu_torch.training import factorvae as tfv
from rag_cobweb_tpu_torch.training import flax_layout
from rag_cobweb_tpu_torch.training import vicreg as tvr

from test_torch_training import LOSS_RTOL, assert_same_params

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


def rows(n, d, seed):
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, 4))
    mix = rng.normal(size=(4, d))
    return (latent @ mix + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


def assert_metrics(got: dict, want: dict, what: str, scale=None):
    """Each metric within 1e-5 relative, or within 1e-5 of ``scale[k]``
    where a metric is a difference of larger terms."""
    assert set(got) == set(want), what
    for k in want:
        atol = LOSS_RTOL * (scale or {}).get(k, 0.0)
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=atol,
                                   err_msg=f"{what} {k}")


def assert_same_module(port, jax_tree, flat: dict, start: dict, moves: float):
    """The port's module against the JAX package's parameters: every entry
    within ``atol=1e-5, rtol=1e-4``, but the ``flat`` entries (their
    gradient 0 in exact arithmetic at every step: only rounding noise,
    which Adam scales to steps of ~lr in either package), which are held
    to have moved at most ``moves`` (lr a step) from ``start`` in both."""
    twin = flax_layout.load_flax(copy.deepcopy(port), jax.device_get(jax_tree))
    jax_p = dict(twin.named_parameters())
    for name, p in port.named_parameters():
        got, want = p.detach(), jax_p[name].detach()
        keep = ~flat[name]
        torch.testing.assert_close(got[keep], want[keep], atol=1e-5,
                                   rtol=1e-4, msg=name)
        for x in (got, want):
            moved = (x - start[name])[~keep].abs()
            assert not len(moved) or float(moved.max()) <= moves * 1.001, \
                name


# ---------------------------------------------------------------------------
# VICReg
# ---------------------------------------------------------------------------

def test_vicreg_loss_terms_match_jax():
    """Each term within 1e-5: the variance is the population variance
    (``jnp.var``; the unbiased one would part by n/(n-1)), the covariance
    divides by n - 1; also with the hinge active and inactive."""
    rng = np.random.default_rng(0)
    for scale in (0.3, 3.0):
        za = (scale * rng.normal(size=(32, 6))).astype(np.float32)
        zb = (za + 0.1 * rng.normal(size=za.shape)).astype(np.float32)
        jl, jm = jvr.vicreg_loss(jnp.asarray(za), jnp.asarray(zb))
        tl, tm = tvr.vicreg_loss(torch.as_tensor(za), torch.as_tensor(zb))
        assert_metrics(dict(tm, loss=tl), dict(jm, loss=jl), f"x{scale}")


def test_projector_forward_on_carried_weights():
    net = jvr.Projector(out_dim=6, hidden=32)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((1, 10)))
    x = rows(9, 10, 1)
    port = interop.projector_from_flax(jax.device_get(params), device="cpu")
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(net.apply(params, x)),
                               rtol=1e-5, atol=1e-6)


def carried_vicreg(**kw):
    jw = jvr.VICRegWhitener(**kw)
    tw = tvr.VICRegWhitener(**kw, device="cpu")
    flax_layout.load_flax(tw.net, jax.device_get(jw.state.params))
    return jw, tw


VIC = dict(in_dim=24, out_dim=8, hidden=64, lr=1e-3, seed=0)


def flat_entries(module, loss_of) -> dict:
    """Per parameter of ``module``, the entries whose gradient of
    ``loss_of(copy)`` is 0 in exact arithmetic: below 1e-9 of the module's
    largest gradient in a float64 copy (float32's rounding noise is ~1e-7
    of it)."""
    m = copy.deepcopy(module).double()
    grads = torch.autograd.grad(loss_of(m), list(m.parameters()))
    top = max(float(g.abs().max()) for g in grads)
    return {name: g.abs() <= 1e-9 * top
            for (name, _), g in zip(m.named_parameters(), grads)}


def vicreg_flat(tw, xa, xb, flat=None) -> dict:
    """``flat_entries`` of the projector on one pair of batches, and-ed
    into ``flat``.  The VICReg loss is invariant to a shift of z, so the
    last bias, and the bias of every unit active on the whole batch, has
    no gradient in exact arithmetic."""
    def loss_of(m):
        return tvr.vicreg_loss(m(torch.as_tensor(xa).double()),
                               m(torch.as_tensor(xb).double()))[0]
    new = flat_entries(tw.net, loss_of)
    return new if flat is None else {k: flat[k] & new[k] for k in flat}


def test_vicreg_steps_match_jax():
    """Five Adam steps on the same pairs of views: loss and terms within
    1e-5 at each step; the projector within atol 1e-5, rtol 1e-4 after
    them, but at the entries with no gradient in exact arithmetic
    (``vicreg_flat``), held to have moved less than lr a step."""
    X = rows(320, 24, 2)
    Y = X + 0.1 * np.random.default_rng(3).normal(size=X.shape).astype(
        np.float32)
    jw, tw = carried_vicreg(**VIC)
    start = {k: v.detach().clone() for k, v in tw.net.named_parameters()}
    flat = None
    for s in range(5):
        sl = slice(64 * s, 64 * s + 64)
        flat = vicreg_flat(tw, X[sl], Y[sl], flat)
        jw.state, jm = jw.train_step(jw.state, jnp.asarray(X[sl]),
                                     jnp.asarray(Y[sl]))
        assert_metrics(tw.train_step(X[sl], Y[sl]), dict(jm), f"step {s}")
    assert_same_module(tw.net, jw.state.params, flat, start, 5 * VIC["lr"])
    assert flat["Dense_2.bias"].all()
    assert not flat["Dense_0.weight"].any()


def test_vicreg_fit_matches_jax():
    """``fit`` draws the noisy second view, then each epoch's permutation,
    as the JAX package does, dropping the last partial batch (300 rows,
    batches of 64: 4 steps an epoch): each epoch's metrics within 1e-5,
    then ``transform`` within 1e-4 once each column's mean is taken out.
    The loss cannot see a shift of z, so the last bias walks by
    Adam-scaled rounding noise (lr a step) in each package, and the
    uncentred outputs part by up to 8 x lr."""
    X = rows(300, 24, 4)
    jw, tw = carried_vicreg(**VIC)
    want = jw.fit(X, epochs=2, batch_size=64, seed=5)
    got = tw.fit(X, epochs=2, batch_size=64, seed=5)
    for e, (g, w) in enumerate(zip(got, want)):
        assert_metrics(g, w, f"epoch {e}")
    zt, zj = tw.transform(X), jw.transform(X)
    np.testing.assert_allclose(zt - zt.mean(0), zj - zj.mean(0), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(zt, zj, atol=8 * VIC["lr"] * 1.001)
    np.testing.assert_allclose(tw.transform(X[3]), zt[3], rtol=1e-6,
                               atol=1e-6)


def test_vicreg_pickles_cross_load(tmp_path):
    X = rows(8, 24, 6)
    jw = jvr.VICRegWhitener(**dict(VIC, seed=1))
    tw = tvr.VICRegWhitener(**dict(VIC, seed=2), device="cpu")
    jw.save(str(tmp_path / "jax.pkl"))
    tw.save(str(tmp_path / "port.pkl"))
    np.testing.assert_allclose(
        jvr.VICRegWhitener.load(str(tmp_path / "port.pkl")).transform(X),
        tw.transform(X), rtol=1e-5, atol=1e-6)
    back = tvr.VICRegWhitener.load(str(tmp_path / "jax.pkl"), device="cpu")
    assert back.coeffs == jw.coeffs and back.hidden == jw.hidden
    np.testing.assert_allclose(back.transform(X), jw.transform(X),
                               rtol=1e-5, atol=1e-6)


def test_vicreg_fit_below_one_batch_raises_in_the_port():
    """Reference fault: fewer rows than a batch run no step and the JAX
    ``fit`` fails on the unbound metrics (``UnboundLocalError``); the
    port raises ``ValueError``."""
    X = rows(50, 24, 7)
    jw, tw = carried_vicreg(**VIC)
    with pytest.raises(UnboundLocalError):
        jw.fit(X, epochs=1, batch_size=64)
    with pytest.raises(ValueError, match="no batch"):
        tw.fit(X, epochs=1, batch_size=64)
    assert tw.step == 0


# ---------------------------------------------------------------------------
# FactorVAE
# ---------------------------------------------------------------------------

VAE = dict(input_dim=24, z_dim=8, hidden=64, lr=1e-3, gamma=2.0, seed=0)


def carried_vae(**kw):
    jv = jfv.FactorVAE(**kw)
    tv = tfv.FactorVAE(**kw, device="cpu")
    for module, p in zip((tv.encoder, tv.decoder, tv.disc),
                         (jv.state.enc_params, jv.state.dec_params,
                          jv.state.disc_params)):
        flax_layout.load_flax(module, jax.device_get(p))
    return jv, tv


def jax_draws(key, B, z_dim):
    """What the JAX ``train_step`` draws from its step key: eps from
    ``k_z``, the argsort permutations of ``k_perm1`` and ``k_perm2``."""
    k_z, k1, k2 = jax.random.split(key, 3)
    eps = jax.random.normal(k_z, (B, z_dim))
    perms = [jnp.argsort(jax.random.uniform(k, (z_dim, B)), axis=1)
             for k in (k1, k2)]
    return [torch.as_tensor(np.array(a)) for a in (eps, *perms)]


def test_modules_forward_on_carried_weights():
    """Encoder (mu, logvar), decoder and discriminator within 1e-5, the
    modules built from the JAX trees by ``interop``."""
    jv = jfv.FactorVAE(**VAE)
    enc, dec, disc = interop.factorvae_modules_from_flax(
        jax.device_get((jv.state.enc_params, jv.state.dec_params,
                        jv.state.disc_params)), device="cpu")
    x = rows(11, 24, 8)
    z = np.random.default_rng(9).normal(size=(11, 8)).astype(np.float32)
    with torch.no_grad():
        got = [*enc(torch.as_tensor(x)), dec(torch.as_tensor(z)),
               disc(torch.as_tensor(z))]
    want = [*jv.encoder.apply(jv.state.enc_params, x),
            jv.decoder.apply(jv.state.dec_params, z),
            jv.disc.apply(jv.state.disc_params, z)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_latent_helpers_match_jax():
    """``permute_dims`` on the JAX draws equals the JAX function's output
    exactly (each column a permutation of its own); ``reparameterize``
    and ``kl_divergence`` within 1e-6."""
    rng = np.random.default_rng(10)
    z = rng.normal(size=(64, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    perm = jnp.argsort(jax.random.uniform(key, (8, 64)), axis=1)
    want = np.asarray(jfv.permute_dims(key, jnp.asarray(z)))
    got = tfv.permute_dims(torch.as_tensor(z),
                           torch.as_tensor(np.asarray(perm))).numpy()
    np.testing.assert_array_equal(got, want)
    mu = rng.normal(size=(5, 8)).astype(np.float32)
    logvar = rng.normal(size=(5, 8)).astype(np.float32)
    eps = jax.random.normal(jax.random.PRNGKey(4), mu.shape)
    np.testing.assert_allclose(
        tfv.reparameterize(torch.as_tensor(mu), torch.as_tensor(logvar),
                           torch.as_tensor(np.asarray(eps))).numpy(),
        np.asarray(jfv.reparameterize(jax.random.PRNGKey(4), mu, logvar)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tfv.kl_divergence(torch.as_tensor(mu),
                          torch.as_tensor(logvar)).numpy(),
        np.asarray(jfv.kl_divergence(mu, logvar)), rtol=1e-6, atol=1e-6)
    perms = tfv.random_perms(8, 64, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(torch.sort(perms, dim=1).values,
                       torch.arange(64).expand(8, 64))


def test_latent_correlation_diagnostics_equal():
    rng = np.random.default_rng(11)
    a = rng.normal(size=500)
    z = np.stack([a, a + 0.1 * rng.normal(size=500), rng.normal(size=500),
                  np.zeros(500)], axis=1)
    assert (tfv.latent_correlation_diagnostics(z, top_k=4)
            == jfv.latent_correlation_diagnostics(z, top_k=4))


def test_factorvae_steps_match_jax():
    """Five fused steps on the same batches with the JAX package's draws:
    each metric (recon_mse, kl, tc, disc, vae) within 1e-5 relative a
    step, all three modules within atol 1e-5, rtol 1e-4 after them.  The
    discriminator's half-step runs first; the VAE's sees the updated
    discriminator, whose parameters its loss must not move."""
    X = rows(320, 24, 12)
    jv, tv = carried_vae(**VAE)
    key = jv._key
    for s in range(5):
        key, sub = jax.random.split(key)
        batch = X[64 * s:64 * s + 64]
        jv.state, jm = jv.train_step(jv.state, jnp.asarray(batch), sub)
        disc0 = flax_layout.to_flax(tv.disc)
        draws = jax_draws(sub, 64, VAE["z_dim"])
        with torch.no_grad():
            mu, logvar = tv.encoder(torch.as_tensor(batch))
            z = tfv.reparameterize(mu, logvar, draws[0])
            logits = (tv.disc(z).abs().mean()
                      + tv.disc(tfv.permute_dims(z, draws[2])).abs().mean())
        tm = tv.train_step(batch, *draws)
        # tc is a difference of two means of logits: held within 1e-5 of
        # their magnitude
        assert_metrics(tm, dict(jm), f"step {s}", {"tc": float(logits)})
        # the discriminator moved by its own step only: the same as the
        # JAX package's after that step
        assert_same_params(flax_layout.to_flax(tv.disc), jv.state.disc_params)
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(disc0),
            jax.tree.leaves(flax_layout.to_flax(tv.disc))))
    for port, want in ((tv.encoder, jv.state.enc_params),
                       (tv.decoder, jv.state.dec_params),
                       (tv.disc, jv.state.disc_params)):
        assert_same_params(flax_layout.to_flax(port), want)


def test_factorvae_fit_trains_on_the_host():
    """``fit`` on the port's own draws: the reconstruction error of the
    whole set falls (the JAX package's own test of its trainer, at its
    sizes), the diagnostics are finite, and one epoch's history carries
    the last step's metrics."""
    latent = np.random.default_rng(1).normal(size=(512, 4))
    mix = np.random.default_rng(2).normal(size=(4, 24))
    X = (latent @ mix + 0.05 * np.random.default_rng(3).normal(
        size=(512, 24))).astype(np.float32)
    tv = tfv.FactorVAE(**VAE, device="cpu")

    def recon_mse():
        with torch.no_grad():
            return float(torch.mean(torch.square(
                tv.decoder(tv.encode(X)) - torch.as_tensor(X))))

    before = recon_mse()
    hist = tv.fit(X, epochs=6, batch_size=64, diag_samples=512)
    assert recon_mse() < before
    assert np.isfinite(hist[-1]["mean_abs_offdiag"])
    assert {"recon_mse", "kl", "tc", "disc", "vae", "epoch"} <= set(hist[-1])
    assert tv.step == 6 * 8


def test_factorvae_pickles_cross_load(tmp_path):
    X = rows(6, 24, 13)
    jv = jfv.FactorVAE(**dict(VAE, seed=1))
    tv = tfv.FactorVAE(**dict(VAE, seed=2), device="cpu")
    jv.save(str(tmp_path / "jax.pkl"))
    tv.save(str(tmp_path / "port.pkl"))
    jback = jfv.FactorVAE.load(str(tmp_path / "port.pkl"))
    np.testing.assert_allclose(np.asarray(jback.encode(X)),
                               tv.encode(X).numpy(), rtol=1e-5, atol=1e-6)
    tback = tfv.FactorVAE.load(str(tmp_path / "jax.pkl"), device="cpu")
    assert (tback.z_dim, tback.gamma, tback.hidden) == (8, 2.0, 64)
    np.testing.assert_allclose(tback.encode(X).numpy(),
                               np.asarray(jv.encode(X)), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(
            tback.disc(torch.as_tensor(X[:, :8])).numpy(),
            np.asarray(jv.disc.apply(jv.state.disc_params, X[:, :8])),
            rtol=1e-5, atol=1e-6)


def test_factorvae_fit_below_one_batch_raises_in_the_port():
    """Reference fault: with fewer rows than a batch the JAX ``fit`` runs
    no step and fails on the unbound ``metrics``
    (``UnboundLocalError``); the port raises ``ValueError``."""
    X = rows(40, 24, 14)
    jv, tv = carried_vae(**VAE)
    with pytest.raises(UnboundLocalError):
        jv.fit(X, epochs=1, batch_size=64, diag_samples=40)
    with pytest.raises(ValueError, match="no batch"):
        tv.fit(X, epochs=1, batch_size=64, diag_samples=40)
    assert tv.step == 0


@pytest.mark.parametrize("kind", ["vicreg", "factorvae"])
def test_train_steps_hold_a_host_copy(kind):
    """``bench/train_steps.hold``, the card-versus-host check of phase 3i,
    on two host trainers in lockstep: a copy passes with every metric,
    gradient and parameter equal; a copy whose steps run on one weight
    moved by 1e-3 fails on its metrics."""
    X = rows(320, 24, 15)
    if kind == "vicreg":
        a = tvr.VICRegWhitener(**VIC, device="cpu")
        steps = train_steps.vicreg_steps(X, X[::-1].copy(), n=3, batch=64)
    else:
        a = tfv.FactorVAE(**VAE, device="cpu")
        steps = train_steps.factorvae_steps(a, X, n=3, batch=64)
    b = train_steps.host_copy(a)
    rec = train_steps.hold(a, b, steps)
    assert rec["ok"] and rec["worst_metric_rel"] == 0.0, rec["fails"]
    assert rec["worst_grad_rel"] == 0.0 and rec["worst_param_excess"] <= 0
    assert rec["steps"] == 3 and len(rec["metrics_card"]) == 3
    assert rec["unsettled"] < rec["entries"]
    if kind == "vicreg":
        # its last bias has no gradient in exact arithmetic: unsettled
        assert rec["unsettled"] >= 3 * VIC["out_dim"]

    class Perturbed(type(a)):
        """Its steps run on a first weight moved by 1e-3."""

        def train_step(self, *args):
            with torch.no_grad():
                next(iter(train_steps.modules(self).values())) \
                    .Dense_0.weight[0, 0] += 1e-3
            return super().train_step(*args)

    b = train_steps.host_copy(a)
    b.__class__ = Perturbed
    bad = train_steps.hold(a, b, steps)
    assert not bad["ok"]
    assert "metric" in {f[0] for f in bad["fails"]}
