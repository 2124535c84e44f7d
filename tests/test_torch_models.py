"""The port's VAE and UNet vs the JAX package's, at tiny widths in fp32.

The JAX side runs its unfused attention; the port runs both its fused path
(the kernels' plain versions, on the CPU) and its unfused path. Tolerance:
1e-4 relative plus 1e-4 absolute on activations of order one — a few
hundred chained fp32 ops whose sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.models import attention as jattn
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import unet as junet
from instantrestore_tpu.models import vae as jvae
from instantrestore_tpu.ops import shared_attention as jsa
from instantrestore_tpu_torch.convert import from_jax_tree
from instantrestore_tpu_torch.models import attention as tattn
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import shared_attention as tsa

TOL = dict(rtol=1e-4, atol=1e-4)
UCFG = junet.UNetConfig(sample_size=16, block_out_channels=(32, 64, 64, 64),
                        attention_heads=(1, 2, 2, 2), cross_attention_dim=16, norm_num_groups=8)
VCFG = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
T_UCFG = tunet.UNetConfig(**UCFG.__dict__)
T_VCFG = tvae.VAEConfig(**VCFG.__dict__)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_tree(fn, *args, seed=0):
    """A JAX param tree shaped like ``fn(*args)``'s, filled with seeded numpy
    values (nonzero norm scales, biases and LoRA B)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key, shape = getattr(path[-1], "key", None), s.shape
        if key == "kernel":
            v = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == "scale":
            v = 1 + 0.1 * rng.normal(size=shape)
        elif key in ("bias", "lora_B"):
            v = 0.1 * rng.normal(size=shape)
        elif key == "lora_A":
            v = rng.normal(size=shape) / shape[-1]
        else:
            v = rng.normal(size=shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(fn, *args))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.fixture(scope="module")
def unet_params():
    jp = random_tree(lambda k: junet.init_unet_params(k, UCFG), jax.random.PRNGKey(0))
    return jp, from_jax_tree(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(4, 16, 16, 4)).astype(np.float32),
            np.array([1, 249, 1, 999], np.int32),
            rng.normal(size=(4, 7, 16)).astype(np.float32))


@pytest.mark.parametrize("fused", [True, False])
def test_vae_encode_decode_match_jax(rng, fused):
    jp = random_tree(lambda k: jvae.init_vae_params(k, VCFG), jax.random.PRNGKey(0), seed=3)
    tp = from_jax_tree(jax.tree_util.tree_map(np.asarray, jp))
    x = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    mj, lj, aj = jvae.vae_encode(jp, jnp.asarray(x), cfg=VCFG, compute_dtype=jnp.float32)
    mt, lt, at = tvae.vae_encode(tp, torch.from_numpy(x), cfg=T_VCFG,
                                 compute_dtype=torch.float32, use_fused_attention=fused)
    _close(mt, mj)
    _close(lt, lj)
    for a, b in zip(at, aj):
        _close(a, b)
    z = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    _close(tvae.vae_decode(tp, torch.from_numpy(z), cfg=T_VCFG, compute_dtype=torch.float32,
                           use_fused_attention=fused),
           jvae.vae_decode(jp, jnp.asarray(z), cfg=VCFG, compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_capture(unet_params, unet_inputs):
    jp, _ = unet_params
    x, t, ctx = unet_inputs
    return junet.unet_apply(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), cfg=UCFG,
                            capture_kv=True, capture_taps=True, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def refs(jax_capture):
    """Captured K/V as references of 2 samples (or identities) x 2, masked
    to [2, 2, H, S, d] with the last reference of the second one invalid."""
    return jrest.mask_ref_kv(jax_capture[1]["kv"], jnp.asarray([2, 1]), 2, 2)


@pytest.mark.parametrize("fused", [True, False])
def test_unet_capture_matches_jax(unet_params, unet_inputs, jax_capture, fused):
    _, tp = unet_params
    x, t, ctx = unet_inputs
    ej, auxj = jax_capture
    et, auxt = tunet.unet_apply(tp, torch.from_numpy(x), torch.from_numpy(t).long(),
                                torch.from_numpy(ctx), cfg=T_UCFG, capture_kv=True,
                                capture_taps=True, use_fused_attention=fused,
                                compute_dtype=torch.float32)
    _close(et, ej)
    assert len(auxt["kv"]) == UCFG.num_shared_attn_layers == 9
    for (kt, vt), (kj, vj) in zip(auxt["kv"], auxj["kv"]):
        _close(kt, kj)
        _close(vt, vj)
    assert set(auxt["taps"]) == set(auxj["taps"])
    for name, tap in auxj["taps"].items():
        _close(auxt["taps"][name], tap)


@pytest.mark.parametrize("use_adain,train_input", [(True, False), (False, True)])
def test_unet_ref_kv_matches_jax(unet_params, unet_inputs, refs, use_adain, train_input):
    jp, tp = unet_params
    x, t, ctx = unet_inputs
    trefs = [(torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))) for k, v in refs]
    ej, auxj = junet.unet_apply(jp, jnp.asarray(x[:2]), jnp.asarray(t[:2]), jnp.asarray(ctx[:2]),
                                cfg=UCFG, ref_kv=refs, use_adain=use_adain,
                                train_input=train_input, capture_taps=True,
                                compute_dtype=jnp.float32)
    et, auxt = tunet.unet_apply(tp, torch.from_numpy(x[:2]), torch.from_numpy(t[:2]).long(),
                                torch.from_numpy(ctx[:2]), cfg=T_UCFG, ref_kv=trefs,
                                use_adain=use_adain, train_input=train_input, capture_taps=True,
                                use_fused_attention=True, compute_dtype=torch.float32)
    _close(et, ej)
    for i in range(9):
        _close(auxt["taps"][f"shared_attn_{i}"], auxj["taps"][f"shared_attn_{i}"])


def _jrefs(refs):
    return [(jnp.asarray(k), jnp.asarray(v)) for k, v in refs]


def _trefs(refs):
    return [(torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))) for k, v in refs]


@pytest.mark.parametrize("use_adain", [True, False])
@pytest.mark.parametrize("train_input", [True, False])
def test_attention_fused_per_call_matches_jax(rng, use_adain, train_input):
    """One shared self-attention layer, per-call references, fused: the
    port's kernel path (plain version here) vs the JAX package's Pallas path
    (interpret mode)."""
    c, heads, s, n = 32, 2, 64, 3
    p = {name: {"kernel": jnp.asarray(rng.uniform(-1, 1, (c, c)) / np.sqrt(c), jnp.float32)}
         for name in ("to_q", "to_k", "to_v")}
    p["to_out"] = {"kernel": jnp.asarray(rng.uniform(-1, 1, (c, c)) / np.sqrt(c), jnp.float32),
                   "bias": jnp.asarray(0.1 * rng.normal(size=c), jnp.float32)}
    hidden = rng.normal(size=(2, s, c)).astype(np.float32)
    rk = rng.normal(size=(2, n, heads, s, c // heads)).astype(np.float32)
    rv = rng.normal(size=(2, n, heads, s, c // heads)).astype(np.float32)
    rk[0, 2] = rv[0, 2] = 0.0
    jout, _ = jattn.attention(p, jnp.asarray(hidden), heads=heads,
                              ref_kv=(jnp.asarray(rk), jnp.asarray(rv)), use_adain=use_adain,
                              train_input=train_input, use_fused=True)
    tp = from_jax_tree(jax.tree_util.tree_map(np.asarray, p))
    tout, _ = tattn.attention(tp, torch.from_numpy(hidden), heads=heads,
                              ref_kv=(torch.from_numpy(rk), torch.from_numpy(rv)),
                              use_adain=use_adain, train_input=train_input, use_fused=True)
    _close(tout, jout)


@pytest.mark.parametrize("use_adain,train_input", [(True, False), (False, True)])
def test_unet_fused_per_call_matches_jax(unet_params, unet_inputs, refs, use_adain, train_input):
    """The whole UNet with per-call references on the fused path of both
    packages (JAX: Pallas in interpret mode; port: the kernels' plain
    versions)."""
    jp, tp = unet_params
    x, t, ctx = unet_inputs
    ej, _ = junet.unet_apply(jp, jnp.asarray(x[:2]), jnp.asarray(t[:2]), jnp.asarray(ctx[:2]),
                             cfg=UCFG, ref_kv=_jrefs(refs), use_adain=use_adain,
                             train_input=train_input, use_fused_attention=True,
                             compute_dtype=jnp.float32)
    tsa.reset_launch_counts()
    et, _ = tunet.unet_apply(tp, torch.from_numpy(x[:2]), torch.from_numpy(t[:2]).long(),
                             torch.from_numpy(ctx[:2]), cfg=T_UCFG, ref_kv=_trefs(refs),
                             use_adain=use_adain, train_input=train_input,
                             use_fused_attention=True, compute_dtype=torch.float32)
    _close(et, ej)
    assert not any(fn.launches for fn in tsa.KERNEL_WRAPPERS)


def test_unet_attn_probs_match_jax(unet_params, unet_inputs, refs):
    """save_attn_probs with probs_layers: fp32 probabilities of the chosen
    shared layers, None elsewhere, as the JAX package returns them."""
    jp, tp = unet_params
    x, t, ctx = unet_inputs
    layers = (0, 4, 8)
    _, auxj = junet.unet_apply(jp, jnp.asarray(x[:2]), jnp.asarray(t[:2]), jnp.asarray(ctx[:2]),
                               cfg=UCFG, ref_kv=_jrefs(refs), use_adain=True, train_input=False,
                               save_attn_probs=True, probs_layers=layers,
                               compute_dtype=jnp.float32)
    _, auxt = tunet.unet_apply(tp, torch.from_numpy(x[:2]), torch.from_numpy(t[:2]).long(),
                               torch.from_numpy(ctx[:2]), cfg=T_UCFG, ref_kv=_trefs(refs),
                               use_adain=True, train_input=False, save_attn_probs=True,
                               probs_layers=layers, use_fused_attention=True,
                               compute_dtype=torch.float32)
    assert len(auxt["attn_probs"]) == len(auxj["attn_probs"]) == 9
    for i, (pt, pj) in enumerate(zip(auxt["attn_probs"], auxj["attn_probs"])):
        assert (pt is None) == (pj is None) == (i not in layers)
        if pj is not None:
            assert pt.dtype == torch.float32
            _close(pt, pj, rtol=1e-4, atol=1e-6)


IDS = np.array([1, 1, 0, 1])


@pytest.fixture(scope="module")
def jax_identity_eps(unet_params, unet_inputs, refs):
    jp, _ = unet_params
    x, t, ctx = unet_inputs
    jcache = jsa.build_identity_kv_cache(refs, pack_pairs=False)
    eps, _ = junet.unet_apply(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), cfg=UCFG,
                              ref_kv=[jsa.IdentityRef(c, jnp.asarray(IDS)) for c in jcache],
                              use_adain=True, train_input=False, compute_dtype=jnp.float32)
    return eps


@pytest.mark.parametrize("fused", [True, False])
def test_unet_identity_cache_matches_jax(unet_params, unet_inputs, refs, jax_identity_eps, fused):
    """Identity-cached shared attention (ids repeat and skip a row) vs the
    JAX package's identity path on an unpaired cache."""
    _, tp = unet_params
    x, t, ctx = unet_inputs
    tcache = tsa.build_identity_kv_cache(
        [(torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))) for k, v in refs])
    et, _ = tunet.unet_apply(tp, torch.from_numpy(x), torch.from_numpy(t).long(),
                             torch.from_numpy(ctx), cfg=T_UCFG,
                             ref_kv=[tsa.IdentityRef(c, torch.from_numpy(IDS)) for c in tcache],
                             use_adain=True, train_input=False, use_fused_attention=fused,
                             compute_dtype=torch.float32)
    _close(et, jax_identity_eps)


def test_mask_ref_kv_matches_jax(rng):
    kv = [(rng.normal(size=(6, 2, 4, 8)).astype(np.float32),
           rng.normal(size=(6, 2, 4, 8)).astype(np.float32))]
    valid = np.array([3, 1])
    ref = jrest.mask_ref_kv([tuple(map(jnp.asarray, p)) for p in kv], jnp.asarray(valid), 2, 3)
    out = trest.mask_ref_kv([tuple(map(torch.from_numpy, p)) for p in kv],
                            torch.from_numpy(valid), 2, 3)
    for (kt, vt), (kj, vj) in zip(out, ref):
        _close(kt, kj, rtol=0, atol=0)
        _close(vt, vj, rtol=0, atol=0)
