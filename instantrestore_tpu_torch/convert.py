"""Parameter trees: JAX-layout numpy trees <-> the port's PyTorch trees, and
the port's trees <-> flat diffusers-style state dicts.

The port keeps the JAX package's tree nesting (dicts and lists whose keys
are the diffusers module names, with ``net_0_proj``/``net_2``/``to_out``
standing for ``net.0.proj``/``net.2``/``to_out.0``) but stores each leaf in
PyTorch's layout:

  JAX dense ``kernel`` [in, out]         -> ``weight`` [out, in]
  JAX conv  ``kernel`` HWIO              -> ``weight`` OIHW
  JAX norm  ``scale``                    -> ``weight``
  LoRA dense ``lora_A`` [in, r]          -> [r, in];   ``lora_B`` [r, out] -> [out, r]
  LoRA conv  ``lora_A`` [kh, kw, in, r]  -> [r, in, kh, kw]
             ``lora_B`` [1, 1, r, out]   -> [out, r, 1, 1]

(the peft layouts of the reference checkpoints). ``state_dict`` flattens a
tree to the diffusers/peft key names a released ``.pt`` uses, and
``tree_from_state_dict`` reads such a dict back, so real checkpoints load
through the same mapping. The CLIP text encoder's token and position
embeddings are ``embedding`` leaves in the tree, as in the JAX tree, and
``...token_embedding.weight`` in a state dict.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_TORCH_NAMES = {"net_0_proj": "net.0.proj", "net_2": "net.2", "to_out": "to_out.0"}
_TREE_NAMES = {v: k for k, v in _TORCH_NAMES.items()}
_EMBEDDINGS = ("token_embedding", "position_embedding")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _convert_param_dict(node: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in node.items():
        a = np.asarray(val)
        if key == "kernel":
            out["weight"] = _tensor(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
        elif key == "scale":
            out["weight"] = _tensor(a)
        elif key in ("lora_A", "lora_B"):
            out[key] = _tensor(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
        else:
            out[key] = _tensor(a)
    return out


def from_jax_tree(tree: Any) -> Any:
    """JAX-layout param tree (numpy-convertible leaves) -> port tree of CPU
    tensors. Works on any subtree (a UNet, a VAE, a whole bundle, the loss
    networks); a None leaf (IR-SE-50's absent shortcut) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if "kernel" in tree or ("scale" in tree and "bias" in tree):
            return _convert_param_dict(tree)
        return {k: from_jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_tree(v) for v in tree]
    return _tensor(tree)


def to_jax_tree(tree: Any) -> Any:
    """Inverse of ``from_jax_tree``: a port tree (params, gradients laid out
    like them, updated params) -> the JAX layout as numpy arrays, so that it
    can be laid beside a JAX tree leaf by leaf. A 1-D ``weight`` is a norm's
    ``scale``; 2-D and 4-D ones are dense and conv kernels."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            if not isinstance(val, torch.Tensor):
                out[key] = to_jax_tree(val)
                continue
            a = val.detach().cpu().float().numpy()
            if key in ("weight", "lora_A", "lora_B") and a.ndim >= 2:
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            name = key if key != "weight" else ("scale" if a.ndim == 1 else "kernel")
            out[name] = np.ascontiguousarray(a)
        return out
    if isinstance(tree, (list, tuple)):
        return [to_jax_tree(v) for v in tree]
    return tree.detach().cpu().float().numpy()


def state_dict(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Port tree -> flat dict under diffusers/peft names
    (``down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight``,
    ``...to_q.lora_A.default.weight``)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path: str):
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, torch.Tensor):
                    name = (f"{k}.default.weight" if k in ("lora_A", "lora_B")
                            else "weight" if k == "embedding" else k)
                    out[f"{path}.{name}" if path else name] = v
                else:
                    t = _TORCH_NAMES.get(k, k)
                    walk(v, f"{path}.{t}" if path else t)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")

    walk(tree, prefix.rstrip("."))
    return out


def tree_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``state_dict`` (also accepts peft's ``base_layer``
    indirection and adapter-name-free LoRA keys). Only ``weight`` and
    ``bias`` entries are parameters: buffers (``position_ids``,
    ``num_batches_tracked``) are skipped, as the JAX converter skips them."""
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        parts = [p for p in key.split(".") if p != "base_layer"]
        if parts[-1] not in ("weight", "bias"):
            continue
        if len(parts) >= 3 and parts[-3] in ("lora_A", "lora_B"):
            parts = parts[:-3] + [parts[-3]]
        elif len(parts) >= 2 and parts[-2] in ("lora_A", "lora_B"):
            parts = parts[:-2] + [parts[-2]]
        path: List[str] = []
        i = 0
        while i < len(parts) - 1:
            joined3 = ".".join(parts[i : i + 3])
            joined2 = ".".join(parts[i : i + 2])
            if joined3 in _TREE_NAMES:
                path.append(_TREE_NAMES[joined3])
                i += 3
            elif joined2 in _TREE_NAMES:
                path.append(_TREE_NAMES[joined2])
                i += 2
            else:
                path.append(parts[i])
                i += 1
        node = tree
        for p in path:
            node = node.setdefault(int(p) if p.isdigit() else p, {})
        leaf = parts[-1]
        if leaf == "weight" and path and path[-1] in _EMBEDDINGS:
            leaf = "embedding"
        node[leaf] = value
    return _listify(tree)


def _listify(node):
    """Int-keyed dicts whose keys are 0..n-1 become lists; a sparse one (an
    overlay that touches only ``up_blocks.2``) stays a dict, so that its
    indices survive."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node) and set(node) == set(range(len(node))):
            return [_listify(node[k]) for k in sorted(node)]
        return {k: _listify(v) for k, v in node.items()}
    return node


def tree_to(tree: Any, device=None, dtype=None) -> Any:
    """Move every floating leaf of a tree to ``device``/``dtype``; 4-D conv
    weights go channels-last, the layout cuDNN prefers for NHWC activations.
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    t = tree.to(device=device, dtype=dtype if tree.is_floating_point() else None)
    if t.ndim == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t
