"""The port's on-device degradations against the JAX package's, on the CPU
in fp32: the DCT JPEG at one quality and at a quality per sample (values
and input gradients), the fixed and per-sample Gaussian blurs, the
antialiased linear resize, ``degrade_with_params`` (all 12 factor branches,
JAX's noise draws injected) and ``degrade_on_device``.

Tolerances: 1e-5 absolute on images in [0, 1] (fp32 sums in another
order); the JPEG's input gradient within 1e-4 of its largest entry; the
whole chain's input gradient within 5e-4 relative RMS. The rounding's
derivative, 3 (x - round(x))^2, reads the fractional part of DCT
coefficients over the quantiser, which reach ~1e3 at quality 95 where the
fp32 spacing is ~6e-5, so the summation order alone moves single gradient
entries by ~1e-4 of their size (measured 0.8e-4 to 1.0e-4 relative RMS at
64 and 96 px).
Inputs are seeded numpy draws in [0, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.ops import dct_jpeg as jjpeg
from instantrestore_tpu.ops import image_ops as jimg
from instantrestore_tpu_torch.ops import dct_jpeg as tjpeg
from instantrestore_tpu_torch.ops import image_ops as timg

ATOL = 1e-5
GRAD_REL = 1e-4
CHAIN_GRAD_REL_RMS = 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small ops then never wait on a thread team that
    other test workers crowd out."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _images(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def jax_value_grad(fn, x, w):
    """JAX's fn(x) and the gradient of sum(fn(x) * w) w.r.t. x, in one jit."""
    grad, out = jax.jit(jax.grad(lambda a, ww: ((fn(a) * ww).sum(), fn(a)), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), np.asarray(grad)


def port_value_grad(fn, x, w):
    """The port's fn(x) and the same gradient."""
    tx = _t(x).requires_grad_()
    out = fn(tx)
    (out * _t(w)).sum().backward()
    return out.detach(), tx.grad


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("quality", [10, 95])
def test_jpeg_one_quality(quality):
    x, w = _images(quality, 2, 32, 48, 3), _images(1, 2, 32, 48, 3)
    want, gwant = jax_value_grad(lambda a: jjpeg.jpeg_compress_dct(a, quality), x, w)
    got, grad = port_value_grad(lambda a: tjpeg.jpeg_compress_dct(a, quality), x, w)
    _close(got, want)
    _grad_close(grad, gwant)


def test_jpeg_quality_per_sample():
    x, w = _images(3, 3, 32, 32, 3), _images(4, 3, 32, 32, 3)
    q = np.array([5, 50, 97], np.int32)
    want, gwant = jax_value_grad(lambda a: jjpeg.jpeg_compress_dct_traced(a, jnp.asarray(q)), x, w)
    got, grad = port_value_grad(lambda a: tjpeg.jpeg_compress_dct_traced(a, torch.from_numpy(q)),
                                x, w)
    _close(got, want)
    _grad_close(grad, gwant)
    # a quality per sample is the one-quality JPEG of each sample
    for i, qi in enumerate(q):
        _close(got[i:i + 1], tjpeg.jpeg_compress_dct(_t(x[i:i + 1]), int(qi)))


@pytest.mark.parametrize("size", [(24, 40), (64, 64), (100, 36)])
def test_linear_resize_matches_jax(size):
    x = _images(5, 2, 64, 48, 3)
    _close(timg.resize(_t(x), size, "linear"),
           jax.image.resize(jnp.asarray(x), (2, *size, 3), "linear", antialias=True))


def test_gaussian_blur_fixed_and_per_sample():
    x = _images(6, 2, 48, 40, 3)
    _close(timg.gaussian_blur(_t(x), 2.5, 1.2, rotation=0.4, kernel_size=21),
           jimg.gaussian_blur(jnp.asarray(x), 2.5, 1.2, rotation=0.4, kernel_size=21))
    sx, sy, rot = (np.array(v, np.float32) for v in ([0.5, 3.0], [2.0, 1.0], [0.3, -1.1]))
    _close(timg.gaussian_blur_per_sample(_t(x), _t(sx), _t(sy), _t(rot)),
           jimg.gaussian_blur_per_sample(jnp.asarray(x), jnp.asarray(sx), jnp.asarray(sy),
                                         jnp.asarray(rot)))


def _cycle_params(b):
    rng = np.random.default_rng(7)
    return {
        "blur_sigma_x": rng.uniform(0.2, 3.0, b).astype(np.float32),
        "blur_sigma_y": rng.uniform(0.2, 3.0, b).astype(np.float32),
        "blur_rotation": rng.uniform(-np.pi, np.pi, b).astype(np.float32),
        "downsample_factor": np.array([1, 5, 12, 3][:b], np.int32),
        "noise_sigma": rng.uniform(0.0, 20.0, b).astype(np.float32),
        "jpeg_quality": np.array([30, 60, 95, 10][:b], np.int32),
    }


def jax_cycle_noise(rng, shapes):
    """The noise ``degrade_with_params`` draws for factor f:
    ``normal(fold_in(rng, f))`` at that branch's shape."""
    return [_t(jax.random.normal(jax.random.fold_in(rng, f), s, jnp.float32))
            for f, s in zip(jimg._CYCLE_FACTORS, shapes)]


def test_degrade_with_params_matches_jax():
    b, res = 4, 64
    x, w = _images(8, b, res, res, 3), _images(9, b, res, res, 3)
    params = _cycle_params(b)
    rng = jax.random.PRNGKey(11)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want, gwant = jax_value_grad(
        lambda a: jimg.degrade_with_params(a, jparams, rng, resolution=res), x, w)
    noise = jax_cycle_noise(rng, timg.cycle_noise_shapes(b, res, res))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got, grad = port_value_grad(
        lambda a: timg.degrade_with_params(a, tparams, noise=noise, resolution=res), x, w)
    _close(got, want)
    g = grad.numpy()
    assert np.sqrt(((g - gwant) ** 2).sum() / (gwant ** 2).sum()) <= CHAIN_GRAD_REL_RMS


@pytest.mark.parametrize("severity", [None, 1.0])
def test_degrade_on_device_matches_jax(severity):
    x = _images(10, 2, 128, 128, 3)
    rng = jax.random.PRNGKey(12)
    want = jax.jit(lambda a: jimg.degrade_on_device(a, rng, severity=severity, resolution=128))(
        jnp.asarray(x))
    s = 0.5 if severity is None else severity
    f = max(1, int(round(1 + s * 11)))
    side = max(16, (128 // f) // 16 * 16)
    noise = _t(jax.random.normal(rng, (2, side, side, 3), jnp.float32))
    _close(timg.degrade_on_device(_t(x), noise=noise, severity=severity, resolution=128), want)


def test_degradations_draw_from_a_generator():
    """Without injected noise the port draws from the caller's generator:
    the same seed gives the same bits, another seed another image."""
    x = _t(_images(13, 2, 64, 64, 3))
    params = {k: torch.from_numpy(v) for k, v in _cycle_params(2).items()}

    def run(seed):
        return timg.degrade_with_params(x, params, generator=torch.Generator().manual_seed(seed),
                                        resolution=64)

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="noise"):
        timg.degrade_with_params(x, params, resolution=64)
