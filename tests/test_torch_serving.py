"""The warm-identity serving slice end to end: the port's ServingEngine
(onboard + restore, on the CPU with the kernels' plain versions) vs the JAX
package's get_conditioning_kv -> build_identity_kv_cache ->
restore_forward(precomputed_ref_kv=...), at tiny widths in fp32.

torch cannot replay jax.random, so the noise JAX drew is recovered from its
debug taps (latent = (mean + std * eps) * sf, noised = sqrt(abar) * latent +
sqrt(1 - abar) * n) and injected into the port. Tolerance: 1e-3 max-abs on
the output image (1e-3 relative + absolute on the intermediate taps), 1e-4 on
the cached reference K/V.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import scheduler as jsched
from instantrestore_tpu.models import vae as jvae
from instantrestore_tpu.models.unet import UNetConfig
from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu.ops.image_ops import preprocess as jpreprocess
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import shared_attention as tsa

UCFG = UNetConfig(sample_size=16, block_out_channels=(32, 64, 64, 64), attention_heads=(1, 2, 2, 2),
                  cross_attention_dim=16, norm_num_groups=8)
VCFG = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
J_STATICS = jrest.RestorerStatics(unet_cfg=UCFG, vae_cfg=VCFG, use_adain=True, train_input=False,
                                  compute_dtype=jnp.float32)
T_STATICS = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG.__dict__),
                                  vae_cfg=tvae.VAEConfig(**VCFG.__dict__), use_adain=True,
                                  train_input=False, compute_dtype=torch.float32)
RES, N_IDENT, N_REFS = 128, 3, 4
IDS = np.array([2, 0, 2, 1])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_tree(fn, *args, seed=0):
    """A JAX param tree shaped like ``fn(*args)``'s (traced, never run),
    filled with seeded numpy values (nonzero norm scales, biases and LoRA B;
    BatchNorm statistics and PReLU slopes in their ranges)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key, shape = getattr(path[-1], "key", None), s.shape
        if key == "kernel":
            v = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == "scale":
            v = 1 + 0.1 * rng.normal(size=shape)
        elif key in ("bias", "lora_B", "mean"):
            v = 0.1 * rng.normal(size=shape)
        elif key == "lora_A":
            v = rng.normal(size=shape) / shape[-1]
        elif key == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif key == "alpha" or str(key).startswith("prelu"):
            v = rng.uniform(0.1, 0.4, shape)
        else:
            v = rng.normal(size=shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(functools.partial(fn, *args)))


def _noise_from_taps(mean, logvar, z, zt, t):
    """The standard-normal draws behind JAX's sampled and noised latents."""
    abar = float(jsched.make_alphas_cumprod()[t])
    z, zt = np.asarray(z), np.asarray(zt)
    eps = (z / VCFG.scaling_factor - np.asarray(mean)) / np.exp(0.5 * np.asarray(logvar))
    n = (zt - np.sqrt(abar) * z) / np.sqrt(1.0 - abar)
    return {"latent": torch.from_numpy(eps), "diffusion": torch.from_numpy(n)}


@pytest.fixture(scope="module")
def slice_run():
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    bundle = jrest.serving_bundle(params, J_STATICS)
    rng = np.random.default_rng(7)
    refs = rng.integers(0, 256, (N_IDENT, N_REFS, RES, RES, 3), dtype=np.uint8)
    images = rng.integers(0, 256, (len(IDS), RES, RES, 3), dtype=np.uint8)
    abar = jsched.make_alphas_cumprod()

    # JAX: onboard each identity, then restore through the identity cache
    kv_rows, onboard_noise = [], []
    for i in range(N_IDENT):
        pre = jpreprocess(jnp.asarray(refs[i], jnp.float32) / 255.0, RES)
        kv, _, taps = jrest.get_conditioning_kv(
            bundle, pre[None], jnp.full((1,), N_REFS), jax.random.PRNGKey(10 + i),
            statics=J_STATICS, alphas_cumprod=abar, debug_taps=True)
        kv_rows.append(kv)
        mean, logvar, _ = jvae.vae_encode(jrest.original_vae_view(bundle), pre, cfg=VCFG,
                                          compute_dtype=jnp.float32)
        onboard_noise.append(_noise_from_taps(mean, logvar, taps["cond_latent"],
                                              taps["cond_latent_noised"], 1))
    kv = [(jnp.concatenate([r[l][0] for r in kv_rows]), jnp.concatenate([r[l][1] for r in kv_rows]))
          for l in range(len(kv_rows[0]))]
    cache = jsa.build_identity_kv_cache(kv, pack_pairs=False)
    out = jrest.restore_forward(
        bundle, jpreprocess(jnp.asarray(images, jnp.float32) / 255.0, RES),
        rng=jax.random.PRNGKey(99), statics=J_STATICS, timestep=249,
        precomputed_ref_kv=[jsa.IdentityRef(c, jnp.asarray(IDS)) for c in cache],
        debug_taps=True)
    taps = out["taps"]
    restore_noise = _noise_from_taps(taps["vae_enc_mean"], taps["vae_enc_logvar"],
                                     taps["latent"], taps["latent_noised"], 249)

    # the port: convert the unmerged JAX params, merge with its own serving_bundle
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    engine = ServingEngine(trest.serving_bundle(tparams, T_STATICS), T_STATICS, device="cpu")
    noise = {k: torch.stack([n[k] for n in onboard_noise]).reshape(N_IDENT, N_REFS, 16, 16, 4)
             for k in ("latent", "diffusion")}
    engine.onboard(torch.from_numpy(refs), noise=noise)
    return dict(jax_kv=kv, jax_out=np.asarray(out["output_image"]), jax_taps=taps, engine=engine,
                images=images, refs=refs, onboard_noise=noise, restore_noise=restore_noise)


def test_onboarded_cache_matches_jax(slice_run):
    engine, jax_kv = slice_run["engine"], slice_run["jax_kv"]
    assert len(engine.kv_cache) == 9
    for layer, (k, v) in zip(engine.kv_cache, jax_kv):
        np.testing.assert_allclose(layer.rk.numpy(), np.asarray(k), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(layer.rv.numpy(), np.asarray(v), rtol=1e-4, atol=1e-4)


def test_restore_matches_jax(slice_run):
    engine = slice_run["engine"]
    tsa.reset_launch_counts()
    out = engine.restore(torch.from_numpy(slice_run["images"]), torch.from_numpy(IDS),
                         noise=slice_run["restore_noise"])
    assert out.shape == (len(IDS), RES, RES, 3)
    np.testing.assert_allclose(out.numpy(), slice_run["jax_out"], rtol=0, atol=1e-3)
    # CPU tensors take the plain versions: no kernel launched
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)
    # float [-1, 1] input and the unfused attention path give the same image
    engine.use_fused_attention = False
    try:
        floats = torch.from_numpy(slice_run["images"]).float() / 127.5 - 1.0
        out2 = engine.restore(floats, IDS.tolist(), noise=slice_run["restore_noise"])
    finally:
        engine.use_fused_attention = True
    np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=0, atol=1e-4)


def test_restore_forward_taps_match_jax(slice_run):
    """Stage-by-stage taps of restore_forward under the JAX package's names."""
    engine, jtaps = slice_run["engine"], slice_run["jax_taps"]
    images = torch.from_numpy(slice_run["images"]).float() / 127.5 - 1.0
    out = trest.restore_forward(
        engine.params, images, statics=T_STATICS,
        precomputed_ref_kv=[tsa.IdentityRef(c, torch.from_numpy(IDS)) for c in engine.kv_cache],
        noise=slice_run["restore_noise"], use_fused_attention=True, debug_taps=True)
    taps = out["taps"]
    shared = [k for k in taps if k in jtaps]
    assert {"latent", "latent_noised", "unet_eps", "x0", "decoded", "unet.shared_attn_8",
            "unet.mid_block"} <= set(shared)
    for name in shared:
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(jtaps[name]), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_onboard_one_replaces_only_its_row(slice_run):
    engine = slice_run["engine"]
    before = [(c.rk.clone(), c.kmax.clone()) for c in engine.kv_cache]
    noise = {k: v[0] for k, v in slice_run["onboard_noise"].items()}
    new_refs = torch.from_numpy(slice_run["refs"][0])  # identity 0 again, into row 1
    try:
        engine.onboard_one(new_refs, 1, noise=noise)
        for (rk, kmax), c in zip(before, engine.kv_cache):
            torch.testing.assert_close(c.rk[[0, 2]], rk[[0, 2]], rtol=0, atol=0)
            torch.testing.assert_close(c.rk[1], rk[0], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(c.kmax[1], kmax[0], rtol=1e-5, atol=1e-5)
    finally:
        engine.onboard_one(torch.from_numpy(slice_run["refs"][1]), 1,
                           noise={k: v[1] for k, v in slice_run["onboard_noise"].items()})
    with pytest.raises(ValueError):
        engine.onboard_one(new_refs, N_IDENT, noise=noise)
    with pytest.raises(ValueError):
        engine.restore(torch.from_numpy(slice_run["images"]), [0, 1, 2, N_IDENT],
                       noise=slice_run["restore_noise"])


def test_engine_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServingEngine({}, T_STATICS)
