"""The fused GAN train step: one generator forward, the discriminator update,
then the generator update through the updated discriminator.

Counterpart of ``personalized_text_to_speech_tpu/train/step.py``, the
``accum_steps == 1`` branch (``fused_step``, ``:258-380``), in the order of
the reference (``finetune_speaker_v2.py:180-232``):

0. the linear spectrogram of the batch, on the device, in float32;
1. **one** generator forward, its autograd graph kept (JAX's ``jax.vjp``);
2. targets: the log-mel of the spectrogram and the waveform, cut at the
   generator's slice;
3. the discriminator's loss on the detached generated audio, its backward
   and its AdamW update;
4. the generator's losses through the **updated** discriminator, whose
   parameters stop requiring gradients for this pass, so its backward
   reaches the generator alone; then the generator's update.

The MAS kernel runs once, inside the generator forward.  Each phase runs
inside a ``torch.profiler.record_function`` range named ``train/<phase>``,
so a profile splits the step's host and device time by phase (free when no
profiler runs).  With ``bf16_run``
the generator and discriminator forwards run under
``torch.autocast(bfloat16)``; the spectrograms and every loss stay float32.
Dropout follows the modules' mode, which the caller sets: the Trainer calls
``.train()``, the parity tests ``.eval()`` (JAX's ``deterministic=True``).
The masks come from torch's default generator of the device; the step's own
draws (slice starts, posterior and duration noise) come from the
``torch.Generator`` it is given, or are injected as :class:`Samples`.

Not ported: ``accum_steps > 1`` (``step.py:382-574``) and ``remat``
(ROADMAP).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from personalized_text_to_speech_tpu_torch.ops.masking import slice_segments
from personalized_text_to_speech_tpu_torch.ops.spectrogram import (
    MelConfig,
    linear_spectrogram,
    mel_spectrogram,
    spec_to_mel,
)
from personalized_text_to_speech_tpu_torch.train import losses
from personalized_text_to_speech_tpu_torch.train.state import TrainState, global_norm


class Batch(NamedTuple):
    """One padded training batch of static, bucketed shapes.  Only raw audio
    goes to the device; ``wav`` is padded to whole hops."""

    text: torch.Tensor  # [B, Tt] int64
    text_lengths: torch.Tensor  # [B] int32
    wav: torch.Tensor  # [B, Ts·hop] float32
    wav_lengths: torch.Tensor  # [B] samples, int32
    sid: torch.Tensor  # [B] int64

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device) -> "Batch":
        """A :class:`~..data.dataset.BucketBatcher` batch → device tensors."""
        def to(key, dtype):
            return torch.from_numpy(np.asarray(arrays[key])).to(device, dtype)

        return cls(to("text", torch.long), to("text_lengths", torch.int32),
                   to("wav", torch.float32), to("wav_lengths", torch.int32),
                   to("sid", torch.long))


class Samples(NamedTuple):
    """The step's random draws, in the shapes of JAX's ``_sample``
    (``step.py:171-194``)."""

    ids_slice: torch.Tensor  # [B] int32, slice start in frames
    post_noise: torch.Tensor  # [B, Ts, inter_channels]
    dp_noise: Optional[torch.Tensor]  # [B, Tt, 2], None without the SDP


def draw_samples(batch: Batch, hop: int, seg_frames: int, inter_channels: int,
                 use_sdp: bool, generator: Optional[torch.Generator]) -> Samples:
    """Slice starts ``⌊u·max(spec_len − seg + 1, 1)⌋`` and the noise, drawn
    from ``generator`` on the batch's device."""
    b, tt = batch.text.shape
    ts = batch.wav.shape[1] // hop
    dev = batch.wav.device
    spec_lengths = batch.wav_lengths // hop
    ids_max = torch.clamp(spec_lengths - seg_frames + 1, min=1)
    u = torch.rand(b, device=dev, generator=generator)
    ids_slice = (u * ids_max.float()).int()
    post = torch.randn(b, ts, inter_channels, device=dev, generator=generator)
    dp = (torch.randn(b, tt, 2, device=dev, generator=generator)
          if use_sdp else None)
    return Samples(ids_slice, post, dp)


def uses_bf16(hps) -> bool:
    """Whether the config runs the G and D forwards under bf16 autocast
    (``bf16_run``, or the reference's ``fp16_run``)."""
    return bool(hps.train.get("bf16_run", hps.train.get("fp16_run", False)))


def make_train_step(hps, debug_grads: bool = False):
    """Build ``step(g_state, d_state, batch, generator=None, samples=None)
    → metrics``, which updates both states in place.

    Metrics are device tensors (``loss/g/*``, ``loss/d/*``, ``loss/d_r/i``,
    ``loss/d_g/i``, ``grad_norm_g/d``, as ``step.py:359-376``); the caller
    reads them to the host when it logs.  ``debug_grads=True`` adds the
    gradients as ``{name: tensor}`` under ``_grads_g``/``_grads_d`` and the
    generator's detached outputs under ``_out``, for the parity tests.
    """
    mel_cfg = MelConfig.from_hparams(hps)
    hop = hps.data.hop_length
    seg_samples = hps.train.segment_size
    seg_frames = seg_samples // hop
    c_mel = hps.train.c_mel
    c_kl = hps.train.c_kl
    inter_ch = hps.model.inter_channels
    use_sdp = bool(hps.model.get("use_sdp", True))
    bf16 = uses_bf16(hps)

    def step(g_state: TrainState, d_state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None,
             samples: Optional[Samples] = None) -> Dict[str, torch.Tensor]:
        g, d = g_state.module, d_state.module
        if samples is None:
            samples = draw_samples(batch, hop, seg_frames, inter_ch, use_sdp,
                                   generator)
        ids = samples.ids_slice
        spec_lengths = (batch.wav_lengths // hop).int()

        def autocast():
            return torch.autocast(device_type=batch.wav.device.type,
                                  dtype=torch.bfloat16, enabled=bf16)

        # ---- 0. on-device features --------------------------------------
        with record_function("train/spectrogram"):
            spec = linear_spectrogram(batch.wav, mel_cfg)  # [B, Ts, F]

        # ---- 1. one generator forward, graph kept -----------------------
        with record_function("train/g_forward"), autocast():
            out = g(batch.text, batch.text_lengths, spec, spec_lengths,
                    batch.sid, slice_ids=ids, posterior_noise=samples.post_noise,
                    dp_noise=samples.dp_noise)
        y_hat = out["wav_hat"]  # [B, seg_samples]

        # ---- 2. targets ---------------------------------------------------
        with record_function("train/targets"), torch.no_grad():
            mel = spec_to_mel(spec, mel_cfg).transpose(1, 2)  # [B, mels, Ts]
            y_mel = slice_segments(mel, ids, seg_frames)
            y_seg = slice_segments(batch.wav, ids * hop, seg_samples)

        # ---- 3. discriminator update on the detached audio ----------------
        with record_function("train/d_forward"):
            with autocast():
                y_d_r, y_d_g, _, _ = d(y_seg, y_hat.detach())
            loss_disc, d_r_losses, d_g_losses = losses.discriminator_loss(
                y_d_r, y_d_g)
        with record_function("train/d_backward"):
            d_state.optimizer.zero_grad(set_to_none=True)
            loss_disc.backward()
        with record_function("train/d_update"):
            grads_d = {n: p.grad for n, p in d.named_parameters()}
            grad_norm_d = global_norm(list(grads_d.values()))
            d_state.apply_gradients()

        # ---- 4. generator losses through the UPDATED discriminator --------
        d.requires_grad_(False)
        try:
            with record_function("train/g_losses"):
                y_hat_mel = mel_spectrogram(y_hat, mel_cfg).transpose(1, 2)
                with autocast():
                    _, y_d_g, fmap_r, fmap_g = d(y_seg, y_hat)
                loss_dur = torch.sum(out["l_length"].float())
                loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * c_mel
                loss_kl = losses.kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                                         out["logs_p"], out["y_mask"]) * c_kl
                loss_fm = losses.feature_loss(fmap_r, fmap_g)
                loss_gen, gen_losses = losses.generator_loss(y_d_g)
                total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
            with record_function("train/g_backward"):
                g_state.optimizer.zero_grad(set_to_none=True)
                total.backward()
        finally:
            d.requires_grad_(True)
        with record_function("train/g_update"):
            grads_g = {n: p.grad for n, p in g.named_parameters()}
            grad_norm_g = global_norm(
                [v for v in grads_g.values() if v is not None])
            g_state.apply_gradients()

        metrics = {
            "loss/g/total": total,
            "loss/d/total": loss_disc,
            "grad_norm_g": grad_norm_g,
            "grad_norm_d": grad_norm_d,
            "loss/g/gen": loss_gen,
            "loss/g/fm": loss_fm,
            "loss/g/mel": loss_mel,
            "loss/g/dur": loss_dur,
            "loss/g/kl": loss_kl,
        }
        # per-discriminator breakdown (reference finetune_speaker_v2.py:246-248)
        for i, v in enumerate(gen_losses):
            metrics[f"loss/g/{i}"] = v
        for i, v in enumerate(d_r_losses):
            metrics[f"loss/d_r/{i}"] = v
        for i, v in enumerate(d_g_losses):
            metrics[f"loss/d_g/{i}"] = v
        metrics = {k: v.detach() for k, v in metrics.items()}
        if debug_grads:
            metrics["_grads_g"] = grads_g
            metrics["_grads_d"] = grads_d
            metrics["_out"] = {k: v.detach() for k, v in out.items()}
        return metrics

    return step
