"""Next-token cross-entropy with vocab-padding masking and z-loss (the port
of ``repro/train/loss.py``)."""

from __future__ import annotations

import torch


def cross_entropy(
    logits: torch.Tensor,  # (B, S, Vp) f32, possibly vocab-padded
    labels: torch.Tensor,  # (B, S) integer, -1 = ignore
    vocab_size: int,
    z_loss_weight: float = 1e-4,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean masked token NLL plus ``z_loss_weight`` times the mean squared
    log-partition.  Logits of ids at or past ``vocab_size`` are set to
    -1e9 first; labels of -1 count in no mean.  Returns (total, metrics):
    ``nll``, ``z_loss``, ``tokens`` (the labels counted) and ``accuracy``
    (argmax equal to the label), each a 0-d f32 tensor; ``total`` carries
    the graph, the metrics do not."""
    vp = logits.shape[-1]
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) < vocab_size
        logits = torch.where(pad, logits, -1e9)

    lse = torch.logsumexp(logits, dim=-1)  # (B, S)
    label_ids = labels.clamp_min(0)
    label_logit = torch.gather(logits, -1, label_ids[..., None].long())[..., 0]
    nll = lse - label_logit

    mask = (labels >= 0).float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    z = (lse.square() * mask).sum() / denom
    total = loss + z_loss_weight * z

    with torch.no_grad():
        hits = (logits.argmax(dim=-1) == label_ids).float() * mask
        metrics = {
            "nll": loss.detach(),
            "z_loss": z.detach(),
            "tokens": mask.sum(),
            "accuracy": hits.sum() / denom,
        }
    return total, metrics
