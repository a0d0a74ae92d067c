"""GAN and VAE losses (reference ``losses.py:7-61``).

Counterpart of ``personalized_text_to_speech_tpu/train/losses.py``.  Every
loss casts its inputs to float32 and sums in float32, whatever type the
discriminators and the generator ran in, as the reference's ``.float()``
casts inside its autocast regions do.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching over every discriminator feature map, ×2
    (reference ``losses.py:7-15``); the real maps are constants."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(
    disc_real_outputs: Sequence[torch.Tensor],
    disc_generated_outputs: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LSGAN discriminator loss (1−D(y))² + D(ŷ)² (reference ``losses.py:18-31``)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(
    disc_outputs: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LSGAN generator loss (1−D(ŷ))² (reference ``losses.py:34-43``)."""
    gen_losses = [torch.mean((1.0 - dg.float()) ** 2) for dg in disc_outputs]
    return sum(gen_losses), gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """Masked Gaussian KL(q‖p) on the flowed latents (reference
    ``losses.py:46-61``).  All ``[B, T, C]``; ``z_mask`` ``[B, T, 1]``."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask)
    )
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
