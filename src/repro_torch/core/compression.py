"""Gradient compression for the serverless synchronization path: top-k
sparsification with error feedback (Stich et al., "Sparsified SGD with
memory"). Each worker uploads only the k largest-magnitude entries of its
corrected gradient and keeps the residual for the next step. Wire bytes per
worker drop from 4·|G| to ~8·k (value + index).

Port of the JAX package's ``core/compression.py`` on device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.comm import CommSpec
from repro_torch.serverless.worker import LocalWorkerPool


def topk_compress(flat: torch.Tensor, ratio: float) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """-> (indices int32, values f32) of the k = ratio*len largest-|.|."""
    k = max(int(flat.numel() * ratio), 1)
    idx = torch.topk(flat.abs(), k, sorted=False).indices
    return idx.to(torch.int32), flat[idx]


def topk_decompress(idx: torch.Tensor, vals: torch.Tensor,
                    size: int) -> torch.Tensor:
    out = torch.zeros(size, dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals
    return out


def compressed_bytes(size: int, ratio: float) -> float:
    k = max(int(size * ratio), 1)
    return 8.0 * k  # 4B value + 4B index


@dataclasses.dataclass
class ErrorFeedback:
    """Per-worker residual memory."""
    residual: torch.Tensor

    @classmethod
    def init(cls, size: int, device="cuda") -> "ErrorFeedback":
        return cls(torch.zeros(size, dtype=torch.float32, device=device))

    def compress(self, flat: torch.Tensor, ratio: float):
        corrected = flat + self.residual
        idx, vals = topk_compress(corrected, ratio)
        sent = topk_decompress(idx, vals, flat.numel())
        self.residual = corrected - sent
        return idx, vals


class CompressedWorkerPool(LocalWorkerPool):
    """A pool whose plan is a compressed central-store schedule (top-k
    sparse uploads with error feedback). ``ratio=1.0`` is the exact ps
    mean."""

    def __init__(self, grad_fn, n_workers: int, param_store, *,
                 ratio: float = 0.05):
        super().__init__(grad_fn, n_workers, param_store,
                         plan=CommSpec("ps", ratio=ratio))
        self.ratio = ratio
