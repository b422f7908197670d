"""Accuracy metrics used across tests and benchmarks: MSE, cosine similarity
(the north-star accuracy metric) and relative L1. Each returns a 0-dim f32
tensor."""

from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.float() - b.float()) ** 2).mean()


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a = a.float().reshape(-1)
    b = b.float().reshape(-1)
    return (a * b).sum() / (torch.sqrt((a * a).sum()) * torch.sqrt((b * b).sum()) + eps)


def relative_l1(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a = a.float()
    b = b.float()
    return (a - b).abs().sum() / (b.abs().sum() + eps)
