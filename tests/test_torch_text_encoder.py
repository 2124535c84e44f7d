"""The port's CLIP tokenizer and text encoder vs the JAX package's, on the
CPU.

Tokenizer: the same synthetic byte-level vocab and merges
(``helpers.make_tokenizer_files``), ids equal on every prompt of
``tests/test_tokenizer_golden.py`` (exact). Text encoder: a 2-layer, 64-wide
tree from a numpy seed through both, fp32, max-abs 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_tokenizer_files
from instantrestore_tpu.models import text_encoder as jte
from instantrestore_tpu.models import tokenizer as jtok
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.models import text_encoder as tte
from instantrestore_tpu_torch.models import tokenizer as ttok

# tests/test_tokenizer_golden.py's prompts, then a non-ASCII one and one
# longer than 77 tokens
PROMPTS = [tte.PROMPT, "hello world", "the photo of it", "a  b   c", "MiXeD CaSe PHOTO",
           "punctuation, here; ok!", "numbers 123 and 8k", "it's the photographer's",
           "under_score and ümlaut", " ".join(["photo"] * 90)]
CFG = dict(vocab_size=600, hidden_size=64, num_layers=2, num_heads=1, intermediate_size=128,
           max_position_embeddings=77, eos_token_id=599)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    make_tokenizer_files(d)
    return str(d)


@pytest.mark.parametrize("text", PROMPTS)
def test_tokenizer_ids_match_jax(tok_dir, text):
    ours, theirs = ttok.load_tokenizer(tok_dir), jtok.load_tokenizer(tok_dir)
    assert ours(text) == theirs(text)
    assert ours(text, max_length=16, padding="none") == theirs(text, max_length=16, padding="none")
    assert ours.encode(text) == theirs.encode(text)


def test_tokenizer_byte_map_and_missing_files(tmp_path):
    assert ttok._bytes_to_unicode() == jtok._bytes_to_unicode()
    assert ttok.load_tokenizer(None) is None and ttok.load_tokenizer(str(tmp_path)) is None


@pytest.fixture(scope="module")
def encoder():
    """A seeded JAX tree (LayerNorm scales and biases nonzero) and its port copy."""
    cfg = jte.CLIPTextConfig(**CFG)
    rng = np.random.default_rng(0)

    def fill(path, s):
        key = getattr(path[-1], "key", None)
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 0.5}.get(key, 1 / np.sqrt(s.shape[0]))
        v = rng.normal(size=s.shape) * scale + (key == "scale")
        return jnp.asarray(v, jnp.float32)

    jtree = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(lambda k: jte.init_text_encoder_params(k, cfg), jax.random.PRNGKey(0)))
    return cfg, jtree, convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree))


def test_text_encoder_matches_jax(encoder, rng):
    cfg, jtree, tree = encoder
    ids = rng.integers(0, CFG["vocab_size"], (3, 77))
    ref = jte.text_encoder_apply(jtree, jnp.asarray(ids, jnp.int32), cfg=cfg)
    out = tte.text_encoder_apply(tree, torch.from_numpy(ids), cfg=tte.CLIPTextConfig(**CFG))
    assert out.shape == (3, 77, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    cap = tte.encode_prompt(tree, ids[0].tolist(), cfg=tte.CLIPTextConfig(**CFG))
    np.testing.assert_allclose(cap.numpy(), np.asarray(jte.encode_prompt(jtree, ids[0], cfg=cfg)),
                               rtol=0, atol=1e-5)


def test_infer_text_config_and_init_match_jax(encoder):
    cfg, jtree, tree = encoder
    assert tte.infer_text_config(tree).__dict__ == jte.infer_text_config(jtree).__dict__
    assert tte.infer_text_config(tree) == tte.CLIPTextConfig(**{**CFG, "num_heads": 1})
    init = tte.init_text_encoder_params(torch.Generator().manual_seed(0), tte.CLIPTextConfig(**CFG))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), convert.to_jax_tree(init))
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
    assert tte.CLIPTextConfig() == tte.CLIPTextConfig(**jte.CLIPTextConfig().__dict__)
