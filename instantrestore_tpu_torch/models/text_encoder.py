"""CLIP text encoder, the OpenCLIP ViT-H text tower of SD 2.1 / sd-turbo
(counterpart of ``instantrestore_tpu/models/text_encoder.py``).

The reference runs it once, on one fixed prompt, and keeps the embedding
(``caption_enc``) for every forward; so does the port: a checkpoint loader
calls ``encode_prompt`` once and the text tower is then dropped. The
attention is a 77-token matmul and softmax in stock torch.

Config (stabilityai/sd-turbo text_encoder): vocab 49408, hidden 1024, 23
layers, 16 heads, intermediate 4096, exact (erf) GELU, 77 positions, causal
mask, LayerNorm eps 1e-5; the output is the last hidden state after the
final LayerNorm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from instantrestore_tpu_torch.ops.primitives import dense, gelu, init_dense, init_norm, layer_norm

# the fixed restoration prompt the reference embeds once
PROMPT = "A high-quality photo of a person; professional, 8k"


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


def init_text_encoder_params(gen: torch.Generator, cfg: CLIPTextConfig = CLIPTextConfig(), *,
                             device=None) -> Dict[str, Any]:
    """Random-init parameter tree (fp32) in the port's layout."""
    d = cfg.hidden_size

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    layers = [{
        "layer_norm1": init_norm(d, device=device),
        "self_attn": {name: init_dense(gen, d, d, device=device)
                      for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "layer_norm2": init_norm(d, device=device),
        "mlp": {"fc1": init_dense(gen, d, cfg.intermediate_size, device=device),
                "fc2": init_dense(gen, cfg.intermediate_size, d, device=device)},
    } for _ in range(cfg.num_layers)]
    return {"text_model": {
        "embeddings": {
            "token_embedding": {"embedding": normal((cfg.vocab_size, d), 0.02)},
            "position_embedding": {"embedding": normal((cfg.max_position_embeddings, d), 0.01)},
        },
        "encoder": {"layers": layers},
        "final_layer_norm": init_norm(d, device=device),
    }}


def infer_text_config(params: Dict[str, Any]) -> CLIPTextConfig:
    """The config of a parameter tree, read off its shapes; heads follow
    CLIP's 64-wide head (1024 / 16 in the ViT-H tower)."""
    tm = params["text_model"]
    vocab_size, hidden = tm["embeddings"]["token_embedding"]["embedding"].shape
    layers = tm["encoder"]["layers"]
    return CLIPTextConfig(
        vocab_size=int(vocab_size),
        hidden_size=int(hidden),
        num_layers=len(layers),
        num_heads=max(1, int(hidden) // 64),
        intermediate_size=int(layers[0]["mlp"]["fc1"]["weight"].shape[0]),
        max_position_embeddings=int(tm["embeddings"]["position_embedding"]["embedding"].shape[0]),
        eos_token_id=int(vocab_size) - 1,
    )


def text_encoder_apply(params: Dict[str, Any], input_ids: torch.Tensor, *,
                       cfg: CLIPTextConfig = CLIPTextConfig(),
                       compute_dtype=torch.float32) -> torch.Tensor:
    """input_ids [B, S] -> last hidden state [B, S, D] after the final
    LayerNorm, what the reference keeps as ``caption_enc``. The embeddings
    are cast to ``compute_dtype`` before they are added."""
    tm = params["text_model"]
    b, s = input_ids.shape
    d, heads = cfg.hidden_size, cfg.num_heads
    hd = d // heads
    emb = tm["embeddings"]
    h = (emb["token_embedding"]["embedding"][input_ids].to(compute_dtype)
         + emb["position_embedding"]["embedding"][:s].to(compute_dtype)[None])
    causal = torch.full((s, s), float("-inf"), device=h.device).triu(1)

    def split(x):
        return x.reshape(b, s, heads, hd).transpose(1, 2)

    for layer in tm["encoder"]["layers"]:
        x = layer_norm(layer["layer_norm1"], h, eps=cfg.layer_norm_eps)
        ap = layer["self_attn"]
        q, k, v = (split(dense(ap[name], x)) for name in ("q_proj", "k_proj", "v_proj"))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5 + causal
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
        h = h + dense(ap["out_proj"], o)
        x = layer_norm(layer["layer_norm2"], h, eps=cfg.layer_norm_eps)
        h = h + dense(layer["mlp"]["fc2"], gelu(dense(layer["mlp"]["fc1"], x)))
    return layer_norm(tm["final_layer_norm"], h, eps=cfg.layer_norm_eps)


def encode_prompt(params: Dict[str, Any], input_ids, cfg: CLIPTextConfig = CLIPTextConfig()
                  ) -> torch.Tensor:
    """Token ids ([S] or [1, S], a list or a tensor) -> ``caption_enc``
    [1, S, D] in fp32, on the device of the parameters."""
    device = params["text_model"]["final_layer_norm"]["weight"].device
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=device)
    if ids.ndim == 1:
        ids = ids[None]
    return text_encoder_apply(params, ids, cfg=cfg).float()
