"""Event splat against the float64 per-event stencil reference: values at
borders, out-of-image and masked events, polarity, and the VJP w.r.t. the
event coordinates against central differences of the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eorb_slam_tpu.event import tensorize

H, W = 36, 52


def _events(case: str, n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1)
    valid = np.ones(n, bool)
    pol = rng.choice([-1.0, 1.0], n)
    if case == "borders":
        # on and just inside every edge and corner
        xy[: n // 2, 0] = rng.choice([0.0, 0.3, W - 1.0, W - 1.4], n // 2)
        xy[n // 2:, 1] = rng.choice([0.0, 0.2, H - 1.0, H - 1.3], n - n // 2)
    elif case == "outside":
        # partly off-image (stencil straddles the edge) and far away
        xy[:, 0] = rng.uniform(-4.0, W + 3.0, n)
        xy[:, 1] = rng.uniform(-4.0, H + 3.0, n)
        xy[:20] = [[-1e4, 5.0], [5.0, 1e4]] * 10
    elif case == "masked":
        valid = rng.uniform(size=n) < 0.5
    elif case == "half_pixel":
        # exactly on the truncation edge: |d| == stencil/2 is inside
        xy = np.floor(xy) + 0.5
    return xy.astype(np.float32), valid, pol.astype(np.float32)


@pytest.mark.parametrize("use_polarity", [False, True])
@pytest.mark.parametrize("case", ["interior", "borders", "outside", "masked",
                                  "half_pixel"])
def test_splat_matches_stencil_reference(case, use_polarity):
    xy, valid, pol = _events(case)
    out = np.asarray(tensorize.splat_gauss(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(pol), H, W,
        use_polarity=use_polarity))
    ref = tensorize.splat_gauss_reference(xy, valid, pol, H, W,
                                          use_polarity=use_polarity)
    assert out.shape == (H, W)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("sigma,stencil", [(1.0, 5), (1.5, 7), (0.8, 3)])
def test_splat_sigma_and_stencil(sigma, stencil):
    xy, valid, pol = _events("outside", seed=3)
    out = np.asarray(tensorize.splat_gauss(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(pol), H, W,
        sigma=sigma, stencil=stencil))
    ref = tensorize.splat_gauss_reference(xy, valid, pol, H, W, sigma,
                                          stencil)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_reference_single_event_mass():
    """One interior event at a pixel centre: a 5x5 window (|d| <= 2.5) of
    separable Gaussian weights."""
    ref = tensorize.splat_gauss_reference([[20.0, 10.0]], [True], [1.0], H, W)
    assert np.count_nonzero(ref) == 25
    g = np.exp(-np.arange(-2, 3) ** 2 / 2.0)
    np.testing.assert_allclose(ref[8:13, 18:23], np.outer(g, g))


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_splat_vjp_matches_finite_differences(sigma):
    xy, valid, pol = _events("outside", n=64, seed=5)
    # keep events off the truncation edge, where the derivative jumps
    frac = np.abs(np.mod(xy, 1.0) - 0.5)
    xy = np.where(frac < 0.05, xy + 0.2, xy).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(H, W))
    grad = np.asarray(jax.grad(lambda p: jnp.sum(tensorize.splat_gauss(
        p, jnp.asarray(valid), jnp.asarray(pol), H, W, sigma=sigma)
        * jnp.asarray(g, jnp.float32)))(jnp.asarray(xy)))

    def loss(e):
        return np.sum(g * tensorize.splat_gauss_reference(
            e, valid, pol, H, W, sigma))

    h = 1e-4
    fd = np.zeros_like(grad, np.float64)
    base = xy.astype(np.float64)
    for k in range(len(xy)):
        for a in range(2):
            ep, em = base.copy(), base.copy()
            ep[k, a] += h
            em[k, a] -= h
            fd[k, a] = (loss(ep) - loss(em)) / (2 * h)
    np.testing.assert_allclose(grad, fd, atol=1e-3 * np.abs(fd).max())
    # off-image events have zero gradient
    assert np.all(grad[:20] == 0.0)
