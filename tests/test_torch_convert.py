"""The port's parameter converter vs the JAX package's trees.

Names and layouts: converting a JAX tree must give exactly the diffusers/
peft state dict the JAX package's own exporter writes
(``utils/torch_convert.tree_to_torch_state_dict``), and reading that dict
back must give the same tree. Forward: a converted VAE with LoRA on every
target encodes like the JAX one (fp32, 1e-5 relative / 1e-5 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models.unet import UNetConfig, init_unet_params
from instantrestore_tpu.models.vae import VAEConfig, init_vae_params, vae_encode
from instantrestore_tpu.utils.torch_convert import tree_to_torch_state_dict
from instantrestore_tpu_torch.convert import from_jax_tree, state_dict, tree_from_state_dict, tree_to
from instantrestore_tpu_torch.models import vae as tvae

UCFG = UNetConfig(sample_size=8, block_out_channels=(32, 64, 64, 64), attention_heads=(1, 2, 2, 2),
                  cross_attention_dim=16, norm_num_groups=8)
VCFG = VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)


def random_tree(fn, *args, seed=0):
    """A JAX param tree shaped like ``fn(*args)``'s, filled with seeded numpy
    values (eager JAX init compiles every random op; this takes a second).
    Norm scales and biases are nonzero and LoRA B is nonzero (peft starts it
    at zero), so a layout error cannot hide."""
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


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _check_names_and_layouts(jtree):
    tree = from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree))
    sd = state_dict(tree)
    ref = tree_to_torch_state_dict(jtree)
    assert set(sd) == set(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(value), err_msg=name)
    _assert_same_tree(tree_from_state_dict(sd), tree)
    return tree


def test_unet_tree_names_shapes_roundtrip():
    jtree = random_tree(lambda k: jlora.attach_lora(init_unet_params(k, UCFG), k, 4,
                                                    jlora.UNET_LORA_TARGETS),
                        jax.random.PRNGKey(0))
    tree = _check_names_and_layouts(jtree)
    attn = tree["up_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    assert attn["attn1"]["to_q"]["weight"].shape == (64, 64)
    assert attn["attn2"]["to_k"]["weight"].shape == (64, 16)
    assert attn["ff"]["net_0_proj"]["lora_A"].shape == (4, 64)
    assert attn["ff"]["net_0_proj"]["lora_B"].shape == (512, 4)
    conv = tree["down_blocks"][0]["resnets"][0]["conv1"]
    assert conv["weight"].shape == (32, 32, 3, 3)
    assert conv["lora_A"].shape == (4, 32, 3, 3) and conv["lora_B"].shape == (32, 4, 1, 1)


def test_vae_tree_roundtrip_and_forward(rng):
    jtree = random_tree(lambda k: jlora.attach_lora(init_vae_params(k, VCFG), k, 4,
                                                    jlora.VAE_LORA_TARGETS),
                        jax.random.PRNGKey(0), seed=1)
    tree = _check_names_and_layouts(jtree)
    x = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    mean_j, logvar_j, acts_j = vae_encode(jtree, jnp.asarray(x), cfg=VCFG, lora_scaling=0.5,
                                          compute_dtype=jnp.float32)
    mean_t, logvar_t, acts_t = tvae.vae_encode(
        tree_to(tree, "cpu"), torch.from_numpy(x), cfg=tvae.VAEConfig(**VCFG.__dict__),
        lora_scaling=0.5, compute_dtype=torch.float32)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j), rtol=1e-5, atol=1e-5)
    for a, b in zip(acts_t, acts_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
