"""The cold serving path at a ``sample_size`` whose attention shapes are off
the CUDA tiles' 64 rows: the port's ``ServingEngine.restore_cold`` (on the
CPU, the kernels' plain versions) against the JAX package's, tiny widths at
head dim 64, fp32, at sample_size 24 (192 px): the UNet's attention runs over
576, 144, 36 and 9 tokens, the shared layers over segments of 576, 144 and
36, all with fused attention (JAX: Pallas in interpret mode, one block of
each length: JAX's tile knobs lift its shared kernels' 512-key blocks to
1024), under the default algorithms and under kv_outer + online.

At 24 the UNet's lowest skip is 3 x 3, where JAX's four-bin FreeU projection
and the port's FFT (diffusers' ``fourier_filter``) agree: the quirk of
``tests/test_torch_primitives.py::test_freeu_single_pixel_follows_diffusers``
is at a 1 x 1 skip only, so FreeU stays on. The noise JAX drew is redrawn
with its own key-splitting helpers and injected into the port. Tolerance:
1e-3 max-abs on the output image, as ``tests/test_torch_cold.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.inference import serving as jserving
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import vae as jvae
from instantrestore_tpu.models.unet import UNetConfig
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import shared_attention as tsa

from test_torch_attention_kernels import record_calls
from test_torch_serving import random_tree

SIZE, RES, B, N = 24, 192, 2, 2
F32 = jnp.float32
# head dim 64 at every level, so the plain versions take the d = 64 kernels'
# chunks; one layer a block (6 shared layers, 4 self-attentions) keeps JAX's
# compile short
UCFG = UNetConfig(sample_size=SIZE, block_out_channels=(64, 64, 64, 64),
                  attention_heads=(1, 1, 1, 1), cross_attention_dim=16, norm_num_groups=8,
                  layers_per_block=1)
N_SHARED = 6
VCFG = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
J_STATICS = jrest.RestorerStatics(unet_cfg=UCFG, vae_cfg=VCFG, use_adain=True, train_input=False,
                                  compute_dtype=jnp.float32)
T_STATICS = trest.RestorerStatics(unet_cfg=tunet.UNetConfig(**UCFG.__dict__),
                                  vae_cfg=tvae.VAEConfig(**VCFG.__dict__), use_adain=True,
                                  train_input=False, compute_dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tsa.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)


def _normal(rng, shape):
    if jvae.is_key_batch(rng):
        return jax.vmap(lambda k: jax.random.normal(k, shape[1:], F32))(rng)
    return jax.random.normal(rng, shape, F32)


def jax_draws(rng, b, n):
    """Every standard-normal draw of JAX ``restore_forward(rng=...)`` with n
    references, under the port's ``noise`` names (as
    ``tests/test_torch_cold.py::jax_draws``, on this file's latent grid)."""
    r_cond, r_lat, r_noise, _ = jrest._split_rng(rng, 4)
    out = {"diffusion": jrest._batched_normal(r_noise, (b, SIZE, SIZE, 4), F32),
           "latent": _normal(r_lat, (b, SIZE, SIZE, 4))}
    if jvae.is_key_batch(r_cond):
        ks = jax.vmap(lambda k: jax.random.split(k, n))(r_cond)
        r_cond = ks.reshape((b * n,) + ks.shape[2:])
    r_lat, r_noise = jrest._split_rng(r_cond, 2)
    shape = (b * n, SIZE, SIZE, 4)
    out["cond_diffusion"] = jrest._batched_normal(r_noise, shape, F32)
    out["cond_latent"] = _normal(r_lat, shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def models():
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(13)
    return dict(
        jax=jrest.serving_bundle(params, J_STATICS),
        torch=trest.serving_bundle(tparams, T_STATICS),
        images=rng.integers(0, 256, (B, RES, RES, 3), dtype=np.uint8),
        refs=rng.integers(0, 256, (B, N, RES, RES, 3), dtype=np.uint8),
    )


def _plain_calls(monkeypatch):
    return record_calls(monkeypatch, tsa, ["flash_attention_plain", "flash_online_plain",
                                           "shared_flash_bound_plain", "shared_online_plain"])


@pytest.mark.parametrize("algos", ["default", "kv_outer+online"])
def test_cold_restore_at_sample_size_24_matches_jax(models, monkeypatch, algos):
    """restore_cold of uint8 inputs, both packages fused: the output image to
    1e-3; the port ran the kernels' plain versions of the chosen algorithms
    (the shared layers, the UNet's and VAE's plain attention)."""
    # JAX's shared kernels default to blocks of 512 keys, which 576 is no
    # multiple of: its own tile knobs (read while it traces; the port reads
    # none) lift them to 1024, one block of each segment
    monkeypatch.setenv("INSTANTRESTORE_BLOCK_K", "1024")
    monkeypatch.setenv("INSTANTRESTORE_BLOCK_Q", "1024")
    if algos != "default":  # jax.jit reads the switches while it traces: set before the engine
        monkeypatch.setenv("INSTANTRESTORE_ATTN_ALGO", "kv_outer")
        monkeypatch.setenv("INSTANTRESTORE_FLASH_ALGO", "online")
    rng = jax.random.PRNGKey(17)
    jeng = jserving.ServingEngine(models["jax"], J_STATICS, use_fused_attention=True)
    ref = jeng.restore_cold(jnp.asarray(models["images"]), jnp.asarray(models["refs"]), rng)
    draws = jax_draws(jserving._per_sample_keys(rng, B), B, N)
    calls = _plain_calls(monkeypatch)
    engine = ServingEngine(models["torch"], T_STATICS, device="cpu")
    assert engine.resolution == RES
    out = engine.restore_cold(torch.from_numpy(models["images"]),
                              torch.from_numpy(models["refs"]), noise=draws)
    shared, flash = (("shared_flash_bound_plain", "flash_attention_plain") if algos == "default"
                     else ("shared_online_plain", "flash_online_plain"))
    assert set(calls) == {shared, flash} and calls.count(shared) == N_SHARED
    assert out.shape == (B, RES, RES, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_sample_size_24_attention_shapes_are_ragged(models, monkeypatch):
    """The fused attention of a cold restore at sample_size 24 runs at 576,
    144, 36 and 9 tokens (queries) and over segments of 576, 144 and 36
    keys, none of them but 576 a multiple of the tiles' 64 rows."""
    seen = []
    real = tsa.shared_flash_attention

    def spy(q, k_in, v_in, rk, rv, **kw):
        seen.append(("shared", q.shape[2], rk.shape[3]))
        return real(q, k_in, v_in, rk, rv, **kw)

    real_flash = tsa.flash_attention

    def flash_spy(q, k, v, **kw):
        seen.append(("flash", q.shape[2], k.shape[2]))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(tsa, "shared_flash_attention", spy)
    monkeypatch.setattr(tsa, "flash_attention", flash_spy)
    engine = ServingEngine(models["torch"], T_STATICS, device="cpu")
    engine.restore_cold(torch.from_numpy(models["images"][:1]),
                        torch.from_numpy(models["refs"][:1]),
                        generator=torch.Generator().manual_seed(0))
    assert {s for kind, s, _ in seen if kind == "shared"} == {576, 144, 36}
    assert {s for kind, s, _ in seen if kind == "flash"} >= {576, 144, 36, 9}
