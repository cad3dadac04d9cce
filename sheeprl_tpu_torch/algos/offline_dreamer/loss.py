"""Concept-bottleneck losses (port of ``sheeprl_tpu/algos/offline_dreamer/loss.py``).

The reference's concept targets are a placeholder (random binary targets), so
:func:`cbm_loss` takes them as an argument: the trainer draws them from its
generator, and the parity tests feed the JAX package's own draw.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import log_softmax


def concept_loss(concept_logits: torch.Tensor, target_probs: torch.Tensor, concept_bins: Sequence[int]) -> torch.Tensor:
    """Sum over the concepts of the softmax cross-entropy between each
    concept's bin logits and its target bin distribution (mean over rows)."""
    total = None
    start = 0
    for bins in concept_bins:
        log_probs = log_softmax(concept_logits[..., start : start + bins], dim=-1)
        term = (-torch.sum(target_probs[..., start : start + bins] * log_probs, dim=-1)).mean()
        total = term if total is None else total + term
        start += bins
    return total


def orthogonal_projection_loss(embed1: torch.Tensor, embed2: torch.Tensor) -> torch.Tensor:
    """Mean |cosine similarity| between two embedding sets along the feature axis."""
    e1 = embed1 / (torch.linalg.vector_norm(embed1, dim=-1, keepdim=True) + 1e-6)
    e2 = embed2 / (torch.linalg.vector_norm(embed2, dim=-1, keepdim=True) + 1e-6)
    return torch.abs(torch.sum(e1 * e2, dim=-1)).mean()


def cbm_loss(
    cem,
    concept_logits: torch.Tensor,
    concept_emb: torch.Tensor,
    residual: torch.Tensor,
    rand_concept_emb: torch.Tensor,
    rand_residual: torch.Tensor,
    targets: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The concept cross-entropy against ``targets`` (Bernoulli(0.5) draws of
    the logits' shape, in their dtype) plus the orthogonality of each concept
    embedding to the residual, for the real and for a random latent's pass.
    Returns (the whole term, the cross-entropy alone)."""
    c_loss = concept_loss(concept_logits, targets, cem.concept_bins)
    ortho = None
    for c in range(cem.n_concepts):
        sl = slice(c * cem.emb_size, (c + 1) * cem.emb_size)
        for emb, res in ((concept_emb, residual), (rand_concept_emb, rand_residual)):
            term = orthogonal_projection_loss(emb[..., sl], res)
            ortho = term if ortho is None else ortho + term
    return c_loss + ortho, c_loss
