"""Inference step (counterpart of segtpu/train/state.py ``make_predict_step``)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def make_predict_step(model: nn.Module, bf16: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> sigmoid(model(x))`` under ``torch.inference_mode()``.

    ``x``: NCHW float32 on the model's device; the result is NCHW float32
    probabilities. ``bf16`` runs the model under bfloat16 autocast (the
    submit CLI's ``--bf16``); the model's logits come back in fp32. On CUDA the
    input is handed to the model in ``channels_last`` memory, the layout the
    model is kept in."""
    model.eval()

    def predict_step(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if x.device.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
                logits = model(x)
            return torch.sigmoid(logits.float())

    return predict_step
