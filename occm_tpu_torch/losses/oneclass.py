"""One-class losses (port of `occm_tpu.losses.oneclass` and
`occm_tpu.train.loop.group_one_class_loss`).

- compactness_loss: mean leave-one-out Euclidean distance over the first 6
  (bonafide) embeddings, in the closed form of the JAX package (the mean of
  the other five is (sum - x_i) / 5).
- descriptiveness_loss: mean cross-entropy over all logits, with an
  optional 0/1 sample mask.
- one_class_loss and group_one_class_loss: the weighted sum, per meta-batch
  of 12 for the compactness term.

Every distance has `torch.nn.functional.pairwise_distance` semantics: eps
is added to the difference before the norm.
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, p: float = 2.0,
                      eps: float = 1e-6) -> torch.Tensor:
    """L_p distance along the last axis with torch's eps-on-difference
    convention (`torch.nn.functional.pairwise_distance`): ||x - y + eps||_p."""
    diff = x - y + eps
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)


def compactness_loss(batch_embeddings: torch.Tensor, num_bona: int = 6
                     ) -> torch.Tensor:
    """Mean distance of each bonafide embedding to the mean of the others:
    batch_embeddings [..., B, D] with the first `num_bona` rows bonafide;
    leading axes are kept (one loss per meta-batch)."""
    bona = batch_embeddings[..., :num_bona, :]
    total = torch.sum(bona, dim=-2, keepdim=True)
    others_mean = (total - bona) / (num_bona - 1)
    return torch.mean(pairwise_distance(bona, others_mean), dim=-1)


def descriptiveness_loss(logits: torch.Tensor, labels: torch.Tensor,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross-entropy over the batch; with `weights` ([B] 0/1) the mean
    over the weight-1 samples."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]
    if weights is None:
        return torch.sum(nll) / logits.shape[0]
    w = weights.to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def one_class_loss(embeddings: torch.Tensor, logits: torch.Tensor,
                   labels: torch.Tensor, compactness_weight: float,
                   descriptiveness_weight: float):
    """Weighted one-class objective -> (loss, (c_loss, d_loss))."""
    c_loss = compactness_loss(embeddings)
    d_loss = descriptiveness_loss(logits, labels)
    loss = compactness_weight * c_loss + descriptiveness_weight * d_loss
    return loss, (c_loss, d_loss)


def group_one_class_loss(emb: torch.Tensor, logits: torch.Tensor,
                         labels: torch.Tensor, cw: float, dw: float,
                         meta_batch: int = 12,
                         weights: Optional[torch.Tensor] = None):
    """Per-meta-batch compactness + global descriptiveness over
    emb [G*12, D], logits [G*12, 2], labels [G*12] -> (loss, (c, d)).

    weights: optional [G*12] 0/1 utterance mask, constant within each
    meta-batch, so the weighted means equal the plain means over the
    groups it keeps."""
    g = emb.shape[0] // meta_batch
    c_per_group = compactness_loss(emb.reshape(g, meta_batch, -1))
    if weights is None:
        c_loss = torch.mean(c_per_group)
    else:
        w_g = weights.reshape(g, meta_batch)[:, 0].to(c_per_group.dtype)
        c_loss = torch.sum(c_per_group * w_g) / torch.clamp(torch.sum(w_g),
                                                            min=1.0)
    d_loss = descriptiveness_loss(logits, labels, weights)
    return cw * c_loss + dw * d_loss, (c_loss, d_loss)
