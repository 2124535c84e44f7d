"""The port's checkpoint loading vs the JAX package's, on the CPU.

The JAX package writes both reference ``.pt`` schemas (a FULL file built as
``tests/test_checkpoint_first_contact.py`` builds it, a LoRA-only file by
``export_lora_only_checkpoint``) and a base-weights folder is written with
the ``safetensors`` package, from tiny trees filled from a numpy seed. Each
file goes through JAX's ``import_reference_checkpoint`` and the port's; the
port's bundle, through ``convert.to_jax_tree``, equals JAX's leaf for leaf
(exact), and its ``caption_enc`` equals JAX's text encoder run in fp32 on the
same weights (max-abs 1e-5). The Predictor from a FULL file agrees with JAX's
within 1 uint8 level, with JAX's noise injected (as
``tests/test_torch_predictor.py``). Also: the three converter repairs, the
port's safetensors reader and writer against the package, the refusals, the
statics decoded from an embedded cfg, and the port's own checkpoint file.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from helpers import make_tokenizer_files
from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.inference import predictor as jpred
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import text_encoder as jte
from instantrestore_tpu.models import unet as junet
from instantrestore_tpu.training import checkpoints as jck
from instantrestore_tpu.utils import torch_convert as jtc
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.inference import predictor as tpred
from instantrestore_tpu_torch.training import checkpoints as tck
from instantrestore_tpu_torch.utils import safetensors as tst
from instantrestore_tpu_torch.utils import torch_convert as ttc

from test_torch_cold import J_STATICS, T_STATICS, jax_draws
from test_torch_serving import random_tree

RES = 128
CFG = {"model": {"use_adain": True, "train_input": False, "lora_rank_unet": 8,
                 "lora_rank_vae": 4}}
DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: their many small ops then
    never wait on a thread team that other test workers crowd out."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_text_tree(vocab_size: int, seed: int = 5):
    """A 2-layer text encoder as wide as the tiny UNet's cross-attention."""
    cfg = jte.CLIPTextConfig(vocab_size=vocab_size, hidden_size=16, num_layers=2, num_heads=1,
                             intermediate_size=32, eos_token_id=vocab_size - 1)
    return random_tree(lambda k: jte.init_text_encoder_params(k, cfg), jax.random.PRNGKey(0),
                       seed=seed)


def jax_restorer_tree(seed: int = 0):
    return random_tree(lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4,
                                                            lora_rank_vae=4),
                       jax.random.PRNGKey(0), seed=seed)


def torch_sd(np_sd, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")).to(dtype)
            for k, v in np_sd.items()}


def write_full_pt(path, params, text, dtype=torch.float32, cfg=CFG):
    """A FULL ``.pt`` of the reference trainer's schema, with the text
    encoder's ``position_ids`` buffer."""
    nets = {"unet": params["unet"], "vae": params["vae"],
            "original_unet": jrest.original_unet_view(params),
            "original_vae": jrest.original_vae_view(params), "text_encoder": text}
    sd = {}
    for name, tree in nets.items():
        sd.update(torch_sd(jtc.tree_to_torch_state_dict(tree, prefix=f"net.{name}."), dtype))
    sd["net.text_encoder.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save({"state_dict": sd, "cfg": cfg}, str(path))


def write_base_folder(root, params, text, dtype=torch.float32):
    """A diffusers-layout base folder from the bundle's frozen weights: the
    UNet in two shards, the VAE in its folder, the text encoder as one flat
    file, the tokenizer files. fp32 and fp16 through ``safetensors.numpy``,
    bf16 through ``safetensors.torch``."""
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import save_file as save_torch

    def save(sd, path):
        if dtype == torch.bfloat16:
            save_torch(torch_sd(sd, dtype), str(path))
        else:
            np_dtype = np.float32 if dtype == torch.float32 else np.float16
            save_np({k: np.ascontiguousarray(np.asarray(v, np_dtype)) for k, v in sd.items()},
                    str(path))

    unet = jtc.tree_to_torch_state_dict(jrest.original_unet_view(params))
    keys = sorted(unet)
    (root / "unet").mkdir(parents=True)
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        save({k: unet[k] for k in part}, root / "unet" / f"model-0000{i + 1}-of-00002.safetensors")
    (root / "vae").mkdir()
    save(jtc.tree_to_torch_state_dict(jrest.original_vae_view(params)),
         root / "vae" / "diffusion_pytorch_model.safetensors")
    save(jtc.tree_to_torch_state_dict(text), root / "text_encoder.safetensors")
    make_tokenizer_files(root / "tokenizer")
    return root


def assert_same_tree(port, ref, path="root"):
    """A port tree (through ``convert.to_jax_tree``) equals a JAX tree leaf
    for leaf: the same keys and list lengths, the same shapes and values."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            assert_same_tree(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same_tree(a, b, f"{path}.{i}")
    else:
        np.testing.assert_array_equal(port, np.asarray(ref, np.float32), err_msg=path)


def check_bundle(port_bundle, jax_bundle):
    """Every leaf but ``caption_enc`` equal; returns the port's ``caption_enc``."""
    port_bundle, jax_bundle = dict(port_bundle), dict(jax_bundle)
    cap = port_bundle.pop("caption_enc")
    jax_bundle.pop("caption_enc")
    assert_same_tree(convert.to_jax_tree(port_bundle), jax_bundle)
    return cap


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    vocab = make_tokenizer_files(root / "tokenizer")
    params, text = jax_restorer_tree(), jax_text_tree(len(vocab))
    return dict(root=root, tok=str(root / "tokenizer"), params=params, text=text)


def jax_caption(files, text_tree):
    """JAX's text encoder in fp32 on the same weights and token ids."""
    from instantrestore_tpu.models.tokenizer import load_tokenizer

    f32 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float32)), text_tree)
    cfg = jte.infer_text_config(f32)
    ids = load_tokenizer(files["tok"])(jrest.PROMPT, max_length=77)
    return np.asarray(jte.encode_prompt(f32, ids, cfg=cfg))


# ---------------------------------------------------------------------------
# the converter repairs
# ---------------------------------------------------------------------------


def test_sparse_overlay_keeps_its_list_indices():
    """An overlay touching only up_blocks.2 stays int-keyed and lands on
    block 2 of the base, as JAX's does."""
    a = torch.randn(4, 8, 3, 3)
    overlay = convert.tree_from_state_dict(
        {"up_blocks.2.resnets.1.conv1.lora_A.default.weight": a})
    assert overlay == {"up_blocks": {2: {"resnets": {1: {"conv1": {"lora_A": a}}}}}}
    base = {"up_blocks": [{"resnets": [{"conv1": {"weight": torch.full((8, 8, 3, 3), i * 2. + j)}}
                                       for j in range(2)]} for i in range(3)]}
    merged = ttc.apply_lora_only_checkpoint(base, overlay)
    assert [len(b["resnets"]) for b in merged["up_blocks"]] == [2, 2, 2]
    assert merged["up_blocks"][2]["resnets"][1]["conv1"]["lora_A"] is a
    assert "lora_A" not in merged["up_blocks"][0]["resnets"][0]["conv1"]
    assert merged["up_blocks"][2]["resnets"][1]["conv1"]["weight"][0, 0, 0, 0].item() == 5.0
    jbase = convert.to_jax_tree(base)
    ref = jtc.apply_lora_only_checkpoint(
        jbase, {"up_blocks.2.resnets.1.conv1.lora_A.default.weight": a.numpy()})
    assert_same_tree(convert.to_jax_tree(merged), ref)
    assert convert.tree_from_state_dict({"blocks.0.weight": a, "blocks.1.weight": a}) == {
        "blocks": [{"weight": a}, {"weight": a}]}


def test_buffers_are_not_parameters():
    w = torch.randn(3, 4)
    tree = convert.tree_from_state_dict({
        "text_model.embeddings.position_ids": torch.arange(77)[None],
        "norm.num_batches_tracked": torch.tensor(3),
        "norm.running_mean": torch.zeros(4),
        "proj.base_layer.weight": w,
    })
    assert set(tree) == {"proj"} and tree["proj"]["weight"] is w


def test_embeddings_have_one_name(files):
    """A text tree converted from JAX, written as a state dict and read back:
    ``embedding`` in the tree, ``...token_embedding.weight`` in the file."""
    tree = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, files["text"]))
    sd = convert.state_dict(tree)
    ref = jtc.tree_to_torch_state_dict(files["text"])
    assert set(sd) == set(ref)
    assert "text_model.embeddings.token_embedding.weight" in sd
    back = convert.tree_from_state_dict(sd)
    assert set(back["text_model"]["embeddings"]["position_embedding"]) == {"embedding"}
    assert_same_tree(convert.to_jax_tree(back), files["text"])


# ---------------------------------------------------------------------------
# safetensors without the package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"conv.weight": torch.randn(4, 3, 3, 3, generator=g).to(DTYPES[dtype]),
               "norm.bias": torch.randn(5, generator=g).to(DTYPES[dtype]),
               "text_model.embeddings.position_ids": torch.arange(77)[None],
               "empty": torch.zeros(0, 2, dtype=DTYPES[dtype])}
    save_file(tensors, str(tmp_path / "lib.safetensors"), metadata={"format": "pt"})
    tst.save_file(tensors, tmp_path / "port.safetensors")
    for name in ("lib", "port"):
        ours = tst.load_file(tmp_path / f"{name}.safetensors")
        theirs = load_file(str(tmp_path / f"{name}.safetensors"))
        assert set(ours) == set(theirs) == set(tensors)
        for k, v in tensors.items():
            assert ours[k].dtype == theirs[k].dtype == v.dtype and torch.equal(ours[k], v), k
    if dtype != "bf16":
        from safetensors.numpy import load_file as load_np

        for k, v in load_np(str(tmp_path / "port.safetensors")).items():
            np.testing.assert_array_equal(v, tensors[k].numpy())


# ---------------------------------------------------------------------------
# the two schemas, leaf for leaf against JAX's importer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_full_checkpoint_matches_jax(files, dtype):
    path = files["root"] / f"full_{dtype}.pt"
    write_full_pt(path, files["params"], files["text"], DTYPES[dtype])
    ref = jck.import_reference_checkpoint(str(path), tokenizer_dir=files["tok"])
    out = tck.import_reference_checkpoint(path, tokenizer_dir=files["tok"])
    assert out["meta"] == ref["meta"] == {"cfg": CFG}
    leaf = out["bundle"]["unet"]["conv_in"]["weight"]
    assert leaf.dtype == DTYPES[dtype] and leaf.device.type == "cpu"  # the file's dtype
    cap = check_bundle(out["bundle"], ref["bundle"])
    assert cap.dtype == torch.float32 and cap.shape == (1, 77, 16)
    np.testing.assert_allclose(cap.numpy(), jax_caption(files, ref["bundle"]["text_encoder"]),
                               rtol=0, atol=1e-5)
    if dtype == "fp32":
        np.testing.assert_allclose(cap.numpy(), np.asarray(ref["bundle"]["caption_enc"]),
                                   rtol=0, atol=1e-5)


def test_full_checkpoint_in_peft_names_from_the_port_writer(files):
    """The port's FULL writer (peft ``base_layer`` names) reads back through
    both importers to the same bundle."""
    def port(tree):
        return convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, tree))

    params = files["params"]
    nets = {"unet": port(params["unet"]), "vae": port(params["vae"]),
            "original_unet": port(jrest.original_unet_view(params)),
            "original_vae": port(jrest.original_vae_view(params)),
            "text_encoder": port(files["text"])}
    path = files["root"] / "full_peft.pt"
    ttc.export_full_checkpoint(nets, path, cfg=CFG)
    sd = torch.load(str(path), weights_only=True)["state_dict"]
    assert "net.unet.conv_out.base_layer.weight" in sd and "net.unet.conv_out.weight" not in sd
    assert "net.unet.conv_out.lora_A.default.weight" in sd
    assert "net.original_unet.conv_out.weight" in sd
    ref = jck.import_reference_checkpoint(str(path), tokenizer_dir=files["tok"])
    out = tck.import_reference_checkpoint(path, tokenizer_dir=files["tok"])
    check_bundle(out["bundle"], ref["bundle"])


@pytest.fixture(scope="module")
def lora_pt(files):
    path = files["root"] / "lora_only.pt"
    jtc.export_lora_only_checkpoint({"unet": files["params"]["unet"],
                                     "vae": files["params"]["vae"]}, str(path),
                                    rank_unet=4, rank_vae=4)
    return path


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lora_only_checkpoint_matches_jax(files, lora_pt, tmp_path, dtype):
    from safetensors.torch import load_file

    base = write_base_folder(tmp_path / "base", files["params"], files["text"], DTYPES[dtype])
    for f in sorted(base.rglob("*.safetensors")):  # the port's reader against the package's
        ours, theirs = tst.load_file(f), load_file(str(f))
        assert set(ours) == set(theirs)
        assert all(ours[k].dtype == DTYPES[dtype] and torch.equal(ours[k], theirs[k]) for k in ours)
    ref = jck.import_reference_checkpoint(str(lora_pt), base_weights_dir=str(base))
    out = tck.import_reference_checkpoint(lora_pt, base_weights_dir=str(base))
    assert out["meta"] == ref["meta"]
    assert out["meta"]["unet_lora_scaling"] == out["meta"]["vae_lora_scaling"] == 2.0
    assert out["bundle"]["vae"]["encoder"]["conv_in"]["weight"].dtype == DTYPES[dtype]
    cap = check_bundle(out["bundle"], ref["bundle"])
    # the capture branch keeps the base conv_in (held to JAX's above), not the trained one
    bundle = out["bundle"]
    assert not torch.equal(bundle["unet_orig_conv_in"]["weight"],
                           bundle["unet"]["conv_in"]["weight"])
    np.testing.assert_allclose(cap.numpy(), jax_caption(files, ref["bundle"]["text_encoder"]),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# statics, refusals, the port's own file
# ---------------------------------------------------------------------------


# the port's UNetConfig fields that the JAX package's lacks (SDXL's), at the
# values that build SD-Turbo's UNet
SD_TURBO_UNET_EXTRAS = {"transformer_layers_per_block": 1, "addition_embed_type": None,
                        "addition_time_embed_dim": 256, "projection_class_embeddings_input_dim": 0}


def assert_same_statics(port, ref):
    for field in dataclasses.fields(port):
        a = getattr(port, field.name)
        if field.name == "freeu":  # the JAX package's FreeU is its module constant
            assert dataclasses.asdict(a) == dataclasses.asdict(junet.DEFAULT_FREEU)
            continue
        b = getattr(ref, field.name)
        if field.name in ("unet_cfg", "vae_cfg"):
            extras = SD_TURBO_UNET_EXTRAS if field.name == "unet_cfg" else {}
            assert a.__dict__ == {**b.__dict__, **extras}, field.name
        elif field.name == "compute_dtype":
            assert str(a) == f"torch.{jnp.dtype(b).name}"
        else:
            assert a == b, field.name
    assert ref.train_reference_networks is False


def test_statics_from_the_embedded_cfg_match_jax(files, lora_pt):
    path = files["root"] / "full_fp32.pt"
    if not path.exists():
        write_full_pt(path, files["params"], files["text"])
    _, ref = jpred.load_predictor_params(str(path), None, tokenizer_dir=files["tok"])
    _, out = tpred.load_predictor_params(path, None, tokenizer_dir=files["tok"])
    assert out.use_adain and not out.train_input and out.unet_lora_scaling == 0.5
    assert_same_statics(out, ref)
    base = write_base_folder(files["root"] / "base_statics", files["params"], files["text"])
    _, ref = jpred.load_predictor_params(str(lora_pt), J_STATICS, base_weights_dir=str(base))
    _, out = tpred.load_predictor_params(lora_pt, T_STATICS, base_weights_dir=str(base))
    assert out.unet_lora_scaling == out.vae_lora_scaling == 2.0  # peft's alpha 8 over rank 4
    assert_same_statics(out, ref)


def test_refusals_match_jax_and_environment_is_honoured(files, lora_pt, monkeypatch):
    path = files["root"] / "full_fp32.pt"
    if not path.exists():
        write_full_pt(path, files["params"], files["text"])
    monkeypatch.delenv(tck.TOKENIZER_DIR_ENV, raising=False)
    monkeypatch.delenv(tck.BASE_WEIGHTS_ENV, raising=False)
    for pt in (path, lora_pt):
        with pytest.raises(FileNotFoundError) as ref:
            jck.import_reference_checkpoint(str(pt))
        with pytest.raises(FileNotFoundError) as out:
            tck.import_reference_checkpoint(str(pt))
        assert str(out.value) == str(ref.value)
        assert ("INSTANTRESTORE_TOKENIZER_DIR" if pt == path else
                "INSTANTRESTORE_BASE_WEIGHTS") in str(out.value)
    with pytest.raises(FileNotFoundError) as out:
        tck.load_base_weights(str(files["root"] / "nowhere"))
    with pytest.raises(FileNotFoundError) as ref:
        jck.load_base_weights(str(files["root"] / "nowhere"))
    assert str(out.value) == str(ref.value)

    want = tck.import_reference_checkpoint(path, tokenizer_dir=files["tok"])
    want = want["bundle"]["caption_enc"]
    monkeypatch.setenv(tck.TOKENIZER_DIR_ENV, files["tok"])
    got = tck.import_reference_checkpoint(path)["bundle"]["caption_enc"]
    assert torch.equal(got, want)
    base = write_base_folder(files["root"] / "base_env", files["params"], files["text"])
    monkeypatch.setenv(tck.BASE_WEIGHTS_ENV, str(base))
    monkeypatch.delenv(tck.TOKENIZER_DIR_ENV)
    out = tck.import_reference_checkpoint(lora_pt)
    ref = jck.import_reference_checkpoint(str(lora_pt))
    check_bundle(out["bundle"], ref["bundle"])


def test_a_file_needing_more_than_weights_only_raises(tmp_path, files):
    path = tmp_path / "pickled.pt"
    torch.save({"state_dict": {}, "cfg": argparse.Namespace(model={})}, str(path))
    with pytest.raises(ValueError, match="weights_only"):
        tck.import_reference_checkpoint(path)
    with pytest.raises(ValueError, match="orbax"):
        tpred.load_predictor_params(tmp_path, None)
    torch.save({"weights": {}}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="unrecognized checkpoint schema"):
        tck.import_reference_checkpoint(tmp_path / "other.pt")


def test_native_checkpoint_round_trip(files, tmp_path):
    """save_checkpoint -> load_checkpoint gives back the tree, step and cfg;
    the Predictor's loader decodes the statics from that cfg as JAX decodes
    the same dict."""
    tree = {k: convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, v))
            for k, v in files["params"].items()}
    cfg = tcfg.TrainConfig()
    cfg.model.use_adain, cfg.model.train_input, cfg.model.lora_rank_unet = True, False, 8
    path = tmp_path / "run" / "step7.pt"
    tck.save_checkpoint(path, tree, cfg=cfg, step=7)
    loaded = tck.load_checkpoint(path)
    assert loaded["step"] == 7 and loaded["cfg"] == tcfg.encode_config(cfg)
    assert_same_tree(convert.to_jax_tree(loaded["params"]), convert.to_jax_tree(tree))
    params, statics = tpred.load_predictor_params(path, None)
    assert set(params) == set(tree)
    ref = jrest.RestorerStatics.from_model_config(
        jcfg._decode_section(jcfg.ModelConfig, loaded["cfg"]["model"]))
    assert_same_statics(statics, ref)
    assert statics.use_adain and statics.unet_lora_scaling == 0.5
    _, given = tpred.load_predictor_params(path, T_STATICS)
    assert given is T_STATICS
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        tck.load_checkpoint(files["root"] / "lora_only.pt")


# ---------------------------------------------------------------------------
# the Predictor from a checkpoint
# ---------------------------------------------------------------------------


def test_predictor_from_full_checkpoint_matches_jax(files, rng):
    path = files["root"] / "full_fp32.pt"
    if not path.exists():
        write_full_pt(path, files["params"], files["text"])
    jp = jpred.Predictor(str(path), statics=J_STATICS, tokenizer_dir=files["tok"],
                         dtype=jnp.float32, resolution=RES, deterministic=True, seed=3)
    tp = tpred.Predictor(path, statics=T_STATICS, tokenizer_dir=files["tok"], dtype=torch.float32,
                         deterministic=True, seed=3, device="cpu")
    assert tp.resolution == RES and "text_encoder" not in tp.params
    assert set(tp.params) == set(jp.params)
    img = Image.fromarray(rng.integers(0, 256, (150, 170, 3), dtype=np.uint8))
    conds = [Image.fromarray(rng.integers(0, 256, (130, 140, 3), dtype=np.uint8))
             for _ in range(3)]
    ref, _ = jp.predict(img, conds)
    out, _ = tp.predict(img, conds, noise=jax_draws(jax.random.PRNGKey(3), 1, 4,
                                                    sample_posterior=False))
    assert out.size == ref.size == (RES, RES)
    np.testing.assert_allclose(np.asarray(out, np.int16), np.asarray(ref, np.int16), rtol=0, atol=1)
    with pytest.raises(ValueError, match="checkpoint_path or params"):
        tpred.Predictor(device="cpu")
