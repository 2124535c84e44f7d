"""A tiny configuration of the serving model for the CPU tests: the layer
pattern of ``configs/instantrestore-serve.json`` at toy widths."""

import copy
import json
from pathlib import Path

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "instantrestore-serve.json"


def tiny_config(n_refs: int = 2) -> dict:
    cfg = copy.deepcopy(json.loads(CONFIG.read_text()))
    cfg["unet"].update(sample_size=16, block_out_channels=[32, 64, 64, 64],
                       attention_head_dim=[1, 2, 2, 2], cross_attention_dim=16, norm_num_groups=8)
    cfg["vae"].update(block_out_channels=[8, 16, 16, 16], norm_num_groups=4)
    cfg["model"].update(resolution=128, n_refs=n_refs, lora_rank_unet=4, lora_rank_vae=4)
    return cfg
