"""Registration (NeRFRegTr) runtime (port of the parts of
dregnerf_tpu/runtime/reg_trainer.py that evaluation needs: the model
factory and the batch upload). The trainer, its losses and its AdamW step
are the next slice (ROADMAP.md queue 1 item 3)."""
from __future__ import annotations

from typing import Dict

import torch

from dregnerf_tpu_torch.models.regtr import NeRFRegTr

BATCH_KEYS = ("src_grid", "tgt_grid", "src_mask", "tgt_mask", "pose")


def make_reg_model(config, dtype: torch.dtype = torch.float32) -> NeRFRegTr:
    """NeRFRegTr at the config's embedding flags (every other field at its
    default: resnet50, 6 layers, 8 heads, ...), computing in `dtype`."""
    return NeRFRegTr(
        pos_emb_type=config.position_embedding_type,
        d_model=config.position_embedding_dim,
        pos_emb_scaling=config.position_embedding_scaling,
        num_downsample=config.num_downsample,
        dtype=dtype,
    )


def to_device(item: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's inputs of a dataset item (and its pose) on `device`."""
    return {k: torch.as_tensor(item[k], device=device) for k in BATCH_KEYS}
