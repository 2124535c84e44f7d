"""The cold serving paths end to end: references re-encoded in the call
(``restore_forward(cond_images=...)``, ``restore_forward_multistep``,
``ServingEngine.restore_cold``) and warm serving of a ``train_input`` model,
the port (on the CPU, kernels' plain versions) vs the JAX package, at tiny
widths in fp32.

torch cannot replay jax.random, so the tests redraw JAX's noise with its own
key-splitting helpers (``jax_draws``, checked against the noise recovered
from JAX's debug taps) and inject it into the port. Tolerance: 1e-3 max-abs
on output images (as the warm slice), 1e-3 relative plus absolute on taps,
1e-4 on cached K/V.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.inference import serving as jserving
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import scheduler as jsched
from instantrestore_tpu.models import vae as jvae
from instantrestore_tpu.models.unet import UNetConfig
from instantrestore_tpu.ops.image_ops import preprocess as jpreprocess
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import scheduler as tsched
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_serving import random_tree

UCFG = UNetConfig(sample_size=16, block_out_channels=(32, 64, 64, 64), attention_heads=(1, 2, 2, 2),
                  cross_attention_dim=16, norm_num_groups=8)
VCFG = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
RES, LAT, B, N = 128, 16, 2, 2
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def statics_pair(**kw):
    j = jrest.RestorerStatics(unet_cfg=UCFG, vae_cfg=VCFG, compute_dtype=jnp.float32, **kw)
    t = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG.__dict__),
                              vae_cfg=tvae.VAEConfig(**VCFG.__dict__),
                              compute_dtype=torch.float32, **kw)
    return j, t


J_STATICS, T_STATICS = statics_pair(use_adain=True, train_input=False)


def _normal(rng, shape):
    """jax.random.normal under a single key or a [B]-key batch, as the JAX
    restorer draws it (``_batched_normal`` / ``sample_latent``)."""
    if jvae.is_key_batch(rng):
        return jax.vmap(lambda k: jax.random.normal(k, shape[1:], F32))(rng)
    return jax.random.normal(rng, shape, F32)


def cond_draws(r_cond, b, n, sample_posterior=True):
    """The reference branch's noise as ``get_conditioning_kv`` draws it."""
    if jvae.is_key_batch(r_cond):
        ks = jax.vmap(lambda k: jax.random.split(k, n))(r_cond)
        r_cond = ks.reshape((b * n,) + ks.shape[2:])
    r_lat, r_noise = jrest._split_rng(r_cond, 2)
    shape = (b * n, LAT, LAT, 4)
    out = {"diffusion": jrest._batched_normal(r_noise, shape, F32)}
    if sample_posterior:
        out["latent"] = _normal(r_lat, shape)
    return out


def jax_draws(rng, b, n=None, sample_posterior=True):
    """Every standard-normal draw of JAX ``restore_forward(rng=...)`` under
    the port's ``noise`` names (cond_* only when ``n`` references)."""
    r_cond, r_lat, r_noise, _ = jrest._split_rng(rng, 4)
    shape = (b, LAT, LAT, 4)
    out = {"diffusion": jrest._batched_normal(r_noise, shape, F32)}
    if sample_posterior:
        out["latent"] = _normal(r_lat, shape)
    if n is not None:
        out.update({f"cond_{k}": v for k, v in cond_draws(r_cond, b, n, sample_posterior).items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def noise_from_taps(mean, logvar, z, zt, t):
    """The standard-normal draws behind JAX's sampled and noised latents."""
    abar = float(jsched.make_alphas_cumprod()[t])
    z, zt = np.asarray(z), np.asarray(zt)
    eps = (z / VCFG.scaling_factor - np.asarray(mean)) / np.exp(0.5 * np.asarray(logvar))
    return eps, (zt - np.sqrt(abar) * z) / np.sqrt(1.0 - abar)


def _pre(x):
    """uint8 [..., H, W, 3] -> JAX-preprocessed [-1, 1] of the same leading shape."""
    flat = x.reshape(-1, *x.shape[-3:])
    out = jpreprocess(jnp.asarray(flat, jnp.float32) / 255.0, RES)
    return out.reshape(*x.shape[:-3], RES, RES, 3)


@pytest.fixture(scope="module")
def models():
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(11)
    return dict(
        jax=jrest.serving_bundle(params, J_STATICS),
        torch=trest.serving_bundle(tparams, T_STATICS),
        images=rng.integers(0, 256, (B, RES, RES, 3), dtype=np.uint8),
        refs=rng.integers(0, 256, (B, N, RES, RES, 3), dtype=np.uint8),
    )


def test_ddim_step_matches_jax(rng):
    abar = jsched.make_alphas_cumprod()
    eps = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    x = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    t, prev = np.array([749, 499, 249]), np.array([499, 249, -1])
    ref = jsched.ddim_step(abar, jnp.asarray(eps), jnp.asarray(x), jnp.asarray(t), jnp.asarray(prev))
    out = tsched.ddim_step(tsched.make_alphas_cumprod(), torch.from_numpy(eps), torch.from_numpy(x),
                           torch.from_numpy(t), torch.from_numpy(prev))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_cold(models):
    """JAX cold restore_forward with masked references, decoded references
    and debug taps."""
    valid = jnp.asarray([N, 1])
    rng = jax.random.PRNGKey(5)
    fwd = jax.jit(functools.partial(jrest.restore_forward, statics=J_STATICS, timestep=249,
                                    decode_conditions=True, debug_taps=True))
    out = fwd(models["jax"], _pre(models["images"]), _pre(models["refs"]), valid, rng=rng)
    return out, jax_draws(rng, B, N)


def test_jax_draws_match_taps(models, jax_cold):
    """The redrawn noise is the noise JAX used (recovered from its taps)."""
    out, draws = jax_cold
    taps = out["taps"]
    eps, n = noise_from_taps(taps["vae_enc_mean"], taps["vae_enc_logvar"], taps["latent"],
                             taps["latent_noised"], 249)
    mean, logvar, _ = jvae.vae_encode(jrest.original_vae_view(models["jax"]),
                                      _pre(models["refs"]).reshape(B * N, RES, RES, 3), cfg=VCFG,
                                      compute_dtype=jnp.float32)
    ceps, cn = noise_from_taps(mean, logvar, taps["cond_latent"], taps["cond_latent_noised"], 1)
    for name, rec in (("latent", eps), ("diffusion", n), ("cond_latent", ceps),
                      ("cond_diffusion", cn)):
        np.testing.assert_allclose(draws[name].numpy(), rec, rtol=1e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_cold_restore_forward_matches_jax(models, jax_cold, fused):
    jout, draws = jax_cold
    images = torch.from_numpy(np.array(_pre(models["images"])))
    conds = torch.from_numpy(np.array(_pre(models["refs"])))
    tsa.reset_launch_counts()
    out = trest.restore_forward(models["torch"], images, conds, torch.tensor([N, 1]),
                                statics=T_STATICS, decode_conditions=True, noise=draws,
                                use_fused_attention=fused, debug_taps=True)
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)
    np.testing.assert_allclose(out["output_image"].numpy(), np.asarray(jout["output_image"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["output_image_conditions"].numpy(),
                               np.asarray(jout["output_image_conditions"]), rtol=0, atol=1e-3)
    jtaps, taps = jout["taps"], out["taps"]
    names = [k for k in taps if k in jtaps]
    assert {"cond_latent", "cond_latent_noised", "ref_kv.8.v", "unet.shared_attn_8",
            "decoded"} <= set(names)
    for name in names:
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(jtaps[name]), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_restore_forward_multistep_matches_jax(models):
    rng = jax.random.PRNGKey(8)
    fwd = jax.jit(functools.partial(jrest.restore_forward_multistep, statics=J_STATICS,
                                    timesteps=(749, 249)))
    jout = fwd(models["jax"], _pre(models["images"]), _pre(models["refs"]), rng=rng)
    r_cond, r_lat, r_noise = jax.random.split(rng, 3)
    draws = {"latent": _normal(r_lat, (B, LAT, LAT, 4)),
             "diffusion": jax.random.normal(r_noise, (B, LAT, LAT, 4), F32)}
    draws.update({f"cond_{k}": v for k, v in cond_draws(r_cond, B, N).items()})
    out = trest.restore_forward_multistep(
        models["torch"], torch.from_numpy(np.array(_pre(models["images"]))),
        torch.from_numpy(np.array(_pre(models["refs"]))), statics=T_STATICS, timesteps=(749, 249),
        noise={k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
        use_fused_attention=True)
    np.testing.assert_allclose(out["output_image"].numpy(), np.asarray(jout["output_image"]),
                               rtol=0, atol=1e-3)


def test_engine_restore_cold_matches_jax_engine(models):
    """uint8 inputs through both engines' restore_cold (preprocessing, the
    per-call capture of every reference, restore)."""
    rng = jax.random.PRNGKey(21)
    jeng = jserving.ServingEngine(models["jax"], J_STATICS, use_fused_attention=False)
    ref = jeng.restore_cold(jnp.asarray(models["images"]), jnp.asarray(models["refs"]), rng)
    draws = jax_draws(jserving._per_sample_keys(rng, B), B, N)
    engine = ServingEngine(models["torch"], T_STATICS, device="cpu")
    out = engine.restore_cold(torch.from_numpy(models["images"]), torch.from_numpy(models["refs"]),
                              noise=draws)
    assert out.shape == (B, RES, RES, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_train_input_engine_matches_jax_engine(models):
    """A train_input model is served warm from a plain (k, v) cache: the
    restore gathers each sample's identity rows and attends to the input's
    own K/V too (the bound kernel with its input segment)."""
    jst, tst = statics_pair(use_adain=True, train_input=True)
    ids = np.array([1, 0])
    jeng = jserving.ServingEngine(models["jax"], jst, use_fused_attention=False)
    assert not jeng.identity_cache
    onboard_rng, restore_rng = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    jeng.onboard(jnp.asarray(models["refs"]), onboard_rng)
    ref = jeng.restore(jnp.asarray(models["images"]), jnp.asarray(ids), restore_rng)

    keys = jax.random.split(onboard_rng, B)
    onboard = [cond_draws(k, 1, N) for k in keys]
    engine = ServingEngine(models["torch"], tst, device="cpu")
    engine.onboard(torch.from_numpy(models["refs"]), noise=engine_noise(onboard))
    for (k, v), (jk, jv) in zip(engine.kv_cache, jeng.kv_cache):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    draws = jax_draws(jserving._per_sample_keys(restore_rng, B), B)
    tsa.reset_launch_counts()
    out = engine.restore(torch.from_numpy(models["images"]), torch.from_numpy(ids), noise=draws)
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
    # replacing one identity's row leaves the other row as it was
    before = [k[0].clone() for k, _ in engine.kv_cache]
    engine.onboard_one(torch.from_numpy(models["refs"][0]), 1,
                       noise={k: v[0] for k, v in engine_noise(onboard).items()})
    for (k, _), k0 in zip(engine.kv_cache, before):
        torch.testing.assert_close(k[0], k0, rtol=0, atol=0)
        torch.testing.assert_close(k[1], k0, rtol=1e-5, atol=1e-5)


def engine_noise(draws):
    return {k: torch.stack([torch.from_numpy(np.array(d[k])) for d in draws])
            for k in ("latent", "diffusion")}
