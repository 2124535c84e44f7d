"""The weight tree of the restoration model, as leaf specifications.

A tree is nested dicts and lists whose leaves are ``Leaf`` entries; the
dotted paths are the diffusers state-dict names (``weight`` ``[out, in]`` for
linears, OIHW for convolutions) and LoRA factors use peft's layouts (linear A
``[r, in]``, B ``[out, r]``; conv A ``[r, in, kh, kw]``, B ``[out, r, 1, 1]``).
``gpubench/weights.py`` fills such a tree from a seed; the plain reference
and the program under test both read the filled tree.

Plain Python: this module imports no torch and nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

# peft's LoRA targets of the reference implementation (face_replace)
UNET_LORA_TARGETS = (
    "to_k", "to_q", "to_v", "to_out.0", "conv", "conv1", "conv2",
    "conv_shortcut", "conv_out", "proj_in", "proj_out", "ff.net.2",
    "ff.net.0.proj",
)
VAE_LORA_TARGETS = (
    "conv1", "conv2", "conv_in", "conv_shortcut", "conv", "conv_out",
    "to_k", "to_q", "to_v", "to_out.0",
)
# tree keys whose diffusers module name differs
_MODULE_NAMES = {"net_0_proj": "net.0.proj", "net_2": "net.2", "to_out": "to_out.0"}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor: ``kind`` picks its distribution (``gpubench/weights.py``),
    ``fan_in`` its scale."""

    kind: str  # weight, bias, norm_weight, norm_bias, lora_A, lora_B, embedding
    shape: Tuple[int, ...]
    fan_in: int = 1
    rank: int = 0
    gain: float = 1.0  # a multiple of the kind's spread (weights and their LoRA B)


# every attention's query and key projections (the UNet's self- and
# cross-attentions, the VAE's mid attentions) at this multiple of the
# default spread: the logits then spread as a trained model's do (std about
# 3) instead of a near-uniform softmax, under which the references would
# barely move the output
QK_GAIN = 3.0


def _dense(cin: int, cout: int, bias: bool = True, gain: float = 1.0) -> Dict[str, Leaf]:
    p = {"weight": Leaf("weight", (cout, cin), cin, gain=gain)}
    if bias:
        p["bias"] = Leaf("bias", (cout,), cin)
    return p


def _conv(cin: int, cout: int, k: int = 3) -> Dict[str, Leaf]:
    fan = cin * k * k
    return {"weight": Leaf("weight", (cout, cin, k, k), fan), "bias": Leaf("bias", (cout,), fan)}


def _norm(c: int) -> Dict[str, Leaf]:
    return {"weight": Leaf("norm_weight", (c,)), "bias": Leaf("norm_bias", (c,))}


def _resnet(cin: int, cout: int, temb: int = 0) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": _norm(cin), "conv1": _conv(cin, cout)}
    if temb:
        p["time_emb_proj"] = _dense(temb, cout)
    p["norm2"] = _norm(cout)
    p["conv2"] = _conv(cout, cout)
    if cin != cout:
        p["conv_shortcut"] = _conv(cin, cout, 1)
    return p


def _attention(dim: int, ctx: int) -> Dict[str, Any]:
    return {"to_q": _dense(dim, dim, False, QK_GAIN), "to_k": _dense(ctx, dim, False, QK_GAIN),
            "to_v": _dense(ctx, dim, False), "to_out": _dense(dim, dim)}


def _transformer(ch: int, ctx: int) -> Dict[str, Any]:
    block = {"norm1": _norm(ch), "attn1": _attention(ch, ch), "norm2": _norm(ch),
             "attn2": _attention(ch, ctx), "norm3": _norm(ch),
             "ff": {"net_0_proj": _dense(ch, ch * 8), "net_2": _dense(ch * 4, ch)}}
    return {"norm": _norm(ch), "proj_in": _dense(ch, ch), "transformer_blocks": [block],
            "proj_out": _dense(ch, ch)}


def skip_channels(unet: Dict[str, Any]) -> List[List[int]]:
    """Widths of the skips each up block pops, in pop order."""
    chs, lpb = unet["block_out_channels"], unet["layers_per_block"]
    stack = [chs[0]]
    for i in range(len(chs)):
        stack += [chs[i]] * lpb
        if i != len(chs) - 1:
            stack.append(chs[i])
    per = lpb + 1
    return [[stack[-(i * per + j + 1)] for j in range(per)] for i in range(len(chs))]


def unet_layout(u: Dict[str, Any]) -> Dict[str, Any]:
    """SD2-style UNet2DConditionModel (``u``: its config.json keys)."""
    chs, lpb, ctx = u["block_out_channels"], u["layers_per_block"], u["cross_attention_dim"]
    temb = chs[0] * 4
    p: Dict[str, Any] = {
        "conv_in": _conv(u["in_channels"], chs[0]),
        "time_embedding": {"linear_1": _dense(chs[0], temb), "linear_2": _dense(temb, temb)},
        "conv_norm_out": _norm(chs[0]),
        "conv_out": _conv(chs[0], u["out_channels"]),
    }
    down, prev = [], chs[0]
    for i, btype in enumerate(u["down_block_types"]):
        block: Dict[str, Any] = {"resnets": [], "attentions": []}
        for j in range(lpb):
            block["resnets"].append(_resnet(prev if j == 0 else chs[i], chs[i], temb))
            if btype.startswith("CrossAttn"):
                block["attentions"].append(_transformer(chs[i], ctx))
        if not block["attentions"]:
            del block["attentions"]
        if i != len(chs) - 1:
            block["downsamplers"] = [{"conv": _conv(chs[i], chs[i])}]
        down.append(block)
        prev = chs[i]
    p["down_blocks"] = down
    p["mid_block"] = {"resnets": [_resnet(chs[-1], chs[-1], temb) for _ in range(2)],
                      "attentions": [_transformer(chs[-1], ctx)]}
    rev, skips, up = list(reversed(chs)), skip_channels(u), []
    for i, btype in enumerate(u["up_block_types"]):
        hidden = rev[i - 1] if i else chs[-1]
        block = {"resnets": [], "attentions": []}
        for j in range(lpb + 1):
            block["resnets"].append(_resnet(hidden + skips[i][j], rev[i], temb))
            hidden = rev[i]
            if btype.startswith("CrossAttn"):
                block["attentions"].append(_transformer(rev[i], ctx))
        if not block["attentions"]:
            del block["attentions"]
        if i != len(chs) - 1:
            block["upsamplers"] = [{"conv": _conv(rev[i], rev[i])}]
        up.append(block)
    p["up_blocks"] = up
    return p


def _vae_mid(ch: int) -> Dict[str, Any]:
    attn: Dict[str, Any] = {"group_norm": _norm(ch), "to_q": _dense(ch, ch, gain=QK_GAIN),
                            "to_k": _dense(ch, ch, gain=QK_GAIN), "to_v": _dense(ch, ch),
                            "to_out": _dense(ch, ch)}
    return {"resnets": [_resnet(ch, ch), _resnet(ch, ch)], "attentions": [attn]}


def vae_layout(v: Dict[str, Any]) -> Dict[str, Any]:
    """AutoencoderKL (``v``: its config.json keys)."""
    chs, lpb, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    enc: Dict[str, Any] = {"conv_in": _conv(v["in_channels"], chs[0]), "down_blocks": [],
                           "mid_block": _vae_mid(chs[-1]), "conv_norm_out": _norm(chs[-1]),
                           "conv_out": _conv(chs[-1], 2 * lat)}
    prev = chs[0]
    for i, ch in enumerate(chs):
        block: Dict[str, Any] = {"resnets": [_resnet(prev if j == 0 else ch, ch)
                                             for j in range(lpb)]}
        if i != len(chs) - 1:
            block["downsamplers"] = [{"conv": _conv(ch, ch)}]
        enc["down_blocks"].append(block)
        prev = ch
    rev = list(reversed(chs))
    dec: Dict[str, Any] = {"conv_in": _conv(lat, rev[0]), "mid_block": _vae_mid(rev[0]),
                           "up_blocks": [], "conv_norm_out": _norm(rev[-1]),
                           "conv_out": _conv(rev[-1], v["out_channels"])}
    prev = rev[0]
    for i, ch in enumerate(rev):
        block = {"resnets": [_resnet(prev if j == 0 else ch, ch) for j in range(lpb + 1)]}
        if i != len(rev) - 1:
            block["upsamplers"] = [{"conv": _conv(ch, ch)}]
        dec["up_blocks"].append(block)
        prev = ch
    return {"encoder": enc, "decoder": dec, "quant_conv": _conv(2 * lat, 2 * lat, 1),
            "post_quant_conv": _conv(lat, lat, 1)}


def _matches(name: str, targets: Sequence[str]) -> bool:
    return any(name == t or name.endswith("." + t) for t in targets)


def with_lora(tree: Any, rank: int, targets: Sequence[str], name: str = "") -> Any:
    """``tree`` with peft LoRA factors on every matrix or kernel whose dotted
    module name matches a target."""
    if isinstance(tree, list):
        return [with_lora(v, rank, targets, f"{name}.{i}" if name else str(i))
                for i, v in enumerate(tree)]
    if not isinstance(tree, dict):
        return tree
    w = tree.get("weight")
    if isinstance(w, Leaf) and len(w.shape) >= 2:
        if not _matches(name, targets):
            return tree
        out = dict(tree)
        out["lora_A"] = Leaf("lora_A", (rank, w.shape[1]) + w.shape[2:], w.fan_in, rank)
        out["lora_B"] = Leaf("lora_B", (w.shape[0], rank) + ((1, 1) if len(w.shape) == 4 else ()),
                             w.fan_in, rank, w.gain)
        return out
    return {k: with_lora(v, rank, targets,
                         f"{name}.{_MODULE_NAMES.get(k, k)}" if name else _MODULE_NAMES.get(k, k))
            for k, v in tree.items()}


def restorer_layout(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The unmerged bundle a LoRA checkpoint holds: the restoration UNet and
    VAE with their LoRA factors, the capture UNet's own (pretrained)
    ``conv_in`` and the prompt embedding ``caption_enc`` [1, tokens, ctx].
    The capture networks are the base weights without LoRA."""
    m = cfg["model"]
    unet = with_lora(unet_layout(cfg["unet"]), m["lora_rank_unet"], UNET_LORA_TARGETS)
    vae = with_lora(vae_layout(cfg["vae"]), m["lora_rank_vae"], VAE_LORA_TARGETS)
    conv_in = _conv(cfg["unet"]["in_channels"], cfg["unet"]["block_out_channels"][0])
    ctx = cfg["unet"]["cross_attention_dim"]
    return {"unet": unet, "unet_orig_conv_in": conv_in, "vae": vae,
            "caption_enc": Leaf("embedding", (1, m["prompt_tokens"], ctx))}


def leaves(tree: Any) -> List[Leaf]:
    """The tree's leaves in a fixed walk order."""
    if isinstance(tree, Leaf):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in items for leaf in leaves(v)]
