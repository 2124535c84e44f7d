"""Off-size inputs and the serving engine's knobs: the port against the JAX
package on the CPU.

``preprocess`` resamples off-size images as ``jax.image.resize(method=
"cubic", antialias=True)`` does (fp32, max-abs 1e-5, downsampling and
upsampling in both orientations, float and uint8 inputs through both
packages' ``_maybe_preprocess``). A tiny-config ``ServingEngine`` restores a
40 x 56 uint8 batch as the JAX engine does (1e-3 max-abs, as
``test_torch_serving.test_restore_matches_jax``), under every combination of
``use_fused_attention`` and ``INSTANTRESTORE_IDENT_CACHE``, with the JAX
engine's ``identity_cache`` default and cache type in each; ``timestep`` and
``resolution`` reach the restore. JAX's noise is redrawn with its own key
helpers (``test_torch_cold``) and injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

from instantrestore_tpu.inference import serving as jserving
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.ops.image_ops import preprocess as jpreprocess
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference import serving as tserving
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.ops import image_ops as timg
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_cold import J_STATICS, RES, T_STATICS, cond_draws, engine_noise, jax_draws
from test_torch_serving import random_tree

# (height, width, resolution): downsampling and upsampling, the shorter side
# first and second, and a crop without a resize
OFF_SIZES = [(40, 56, 32), (56, 40, 32), (24, 20, 32), (20, 24, 32), (600, 512, 512)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("kind", ["float01", "float_pm1", "uint8"])
@pytest.mark.parametrize("h,w,res", OFF_SIZES)
def test_preprocess_matches_jax(rng, h, w, res, kind):
    """``preprocess`` on [0, 1] floats, and the engines' ``_maybe_preprocess``
    on [-1, 1] floats and on uint8, against the JAX package's."""
    if kind == "uint8":
        x = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    else:
        x = rng.random((2, h, w, 3)).astype(np.float32)
        if kind == "float_pm1":
            x = x * 2.0 - 1.0
    if kind == "float01":
        ref = jpreprocess(jnp.asarray(x), res)
        out = timg.preprocess(torch.from_numpy(x), res)
    else:
        ref = jserving._maybe_preprocess(jnp.asarray(x), res)
        out = tserving._maybe_preprocess(torch.from_numpy(x), res)
    assert out.shape == (2, res, res, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(40, 32), (56, 45), (20, 32), (600, 591)])
def test_cubic_weights_match_jax(n_in, n_out):
    """The per-axis weight matrix equals JAX's ``compute_weight_mat`` for
    Keys' cubic with antialiasing (the resize is these matrices applied in
    turn)."""
    ref = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_keys_cubic_kernel, True)
    out = timg.cubic_weights(n_in, n_out)
    assert out.shape == (n_in, n_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


N_IDENT, N_REFS, TIMESTEP = 2, 2, 499
IDS = np.array([1, 0])


@pytest.fixture(scope="module")
def knobs():
    """Tiny models, 150 x 136 uint8 references of two identities and a 40 x 56
    uint8 batch; the JAX engine (unfused, its attention in plain XLA) onboards
    them with and without its identity cache and restores at timestep 499."""
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(13)
    refs = rng.integers(0, 256, (N_IDENT, N_REFS, 150, 136, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (len(IDS), 40, 56, 3), dtype=np.uint8)
    bundle = jrest.serving_bundle(params, J_STATICS)
    onboard_rng, restore_rng = jax.random.PRNGKey(41), jax.random.PRNGKey(42)
    cache_types, out = {}, None
    for ident in (False, True):
        jeng = jserving.ServingEngine(bundle, J_STATICS, use_fused_attention=False,
                                      timestep=TIMESTEP, identity_cache=ident)
        jeng.onboard(jnp.asarray(refs), onboard_rng)
        cache_types[ident] = type(jeng.kv_cache[0]).__name__
        if not ident:
            out = np.asarray(jeng.restore(jnp.asarray(images), jnp.asarray(IDS), restore_rng))
    onboard = [cond_draws(k, 1, N_REFS) for k in jax.random.split(onboard_rng, N_IDENT)]
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    return dict(jax_bundle=bundle, jax_out=out, cache_types=cache_types, refs=refs,
                images=images, torch=trest.serving_bundle(tparams, T_STATICS),
                onboard_noise=engine_noise(onboard),
                restore_noise=jax_draws(jserving._per_sample_keys(restore_rng, len(IDS)),
                                        len(IDS)))


@pytest.mark.parametrize("env", [None, "0"])
@pytest.mark.parametrize("fused", [True, False])
def test_identity_cache_knob_matches_jax(knobs, monkeypatch, fused, env):
    """``identity_cache`` defaults as in the JAX engine (fused attention, a
    refs-only model and INSTANTRESTORE_IDENT_CACHE unset or "1"), the cache
    is of the JAX engine's kind for that flag (``IdentityKVCache`` layers or
    (k, v) pairs gathered per restore), and an off-size uint8 batch restores
    to the JAX engine's output either way."""
    if env is None:
        monkeypatch.delenv("INSTANTRESTORE_IDENT_CACHE", raising=False)
    else:
        monkeypatch.setenv("INSTANTRESTORE_IDENT_CACHE", env)
    want = jserving.ServingEngine(knobs["jax_bundle"], J_STATICS, use_fused_attention=fused,
                                  timestep=TIMESTEP).identity_cache
    assert want == (fused and env is None)
    engine = tserving.ServingEngine(knobs["torch"], T_STATICS, device="cpu",
                                    use_fused_attention=fused, timestep=TIMESTEP)
    assert engine.identity_cache == want
    engine.onboard(torch.from_numpy(knobs["refs"]), noise=knobs["onboard_noise"])
    assert type(engine.kv_cache[0]).__name__ == knobs["cache_types"][want]
    assert len(engine.kv_cache) == 9
    tsa.reset_launch_counts()
    out = engine.restore(torch.from_numpy(knobs["images"]), torch.from_numpy(IDS),
                         noise=knobs["restore_noise"])
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)
    assert out.shape == (len(IDS), RES, RES, 3)
    np.testing.assert_allclose(out.numpy(), knobs["jax_out"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("ident", [True, False])
def test_identity_cache_given_overrides_the_environment(knobs, monkeypatch, ident):
    """An explicit ``identity_cache`` wins over the environment and the
    attention path in both engines."""
    monkeypatch.setenv("INSTANTRESTORE_IDENT_CACHE", "1" if not ident else "0")
    jeng = jserving.ServingEngine(knobs["jax_bundle"], J_STATICS, use_fused_attention=not ident,
                                  identity_cache=ident)
    engine = tserving.ServingEngine(knobs["torch"], T_STATICS, device="cpu",
                                    use_fused_attention=not ident, identity_cache=ident)
    assert engine.identity_cache == jeng.identity_cache == ident


def test_timestep_and_resolution_reach_the_restore(knobs):
    """The defaults are the JAX engine's (timestep 249, the model's
    resolution); given values reach every restore: a 64 px engine at timestep
    499 gives restore_forward's output for the batch preprocessed to 64 px at
    that timestep."""
    jeng = jserving.ServingEngine(knobs["jax_bundle"], J_STATICS)
    default = tserving.ServingEngine(knobs["torch"], T_STATICS, device="cpu")
    assert (default.timestep, default.resolution) == (jeng.timestep, jeng.resolution) == (249, RES)
    jeng = jserving.ServingEngine(knobs["jax_bundle"], J_STATICS, timestep=TIMESTEP, resolution=64)
    engine = tserving.ServingEngine(knobs["torch"], T_STATICS, device="cpu", timestep=TIMESTEP,
                                    resolution=64)
    assert (engine.timestep, engine.resolution) == (jeng.timestep, jeng.resolution)
    lat = 64 // 8
    g = torch.Generator().manual_seed(3)
    onboard = {k: torch.randn((N_IDENT, N_REFS, lat, lat, 4), generator=g)
               for k in ("latent", "diffusion")}
    noise = {k: torch.randn((len(IDS), lat, lat, 4), generator=g) for k in ("latent", "diffusion")}
    engine.onboard(torch.from_numpy(knobs["refs"]), noise=onboard)
    images = torch.from_numpy(knobs["images"])
    out = engine.restore(images, torch.from_numpy(IDS), noise=noise)
    assert out.shape == (len(IDS), 64, 64, 3)
    ids = torch.from_numpy(IDS)
    ref = trest.restore_forward(
        engine.params, timg.preprocess(images.float() / 255.0, 64), statics=T_STATICS,
        timestep=TIMESTEP, precomputed_ref_kv=[tsa.IdentityRef(c, ids) for c in engine.kv_cache],
        noise=noise, use_fused_attention=True)["output_image"]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    other = trest.restore_forward(
        engine.params, timg.preprocess(images.float() / 255.0, 64), statics=T_STATICS,
        timestep=249, precomputed_ref_kv=[tsa.IdentityRef(c, ids) for c in engine.kv_cache],
        noise=noise, use_fused_attention=True)["output_image"]
    assert float((other - out).abs().max()) > 1e-3
