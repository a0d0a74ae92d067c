"""The GAN train step: the generator forward, the discriminator update,
then the generator update through the updated discriminator; fused, or with
exact gradient accumulation, and with remat of the generator forward.

Counterpart of ``personalized_text_to_speech_tpu/train/step.py``
(``fused_step``, ``:258-380``; ``accum_step``, ``:382-574``), in the order
of the reference (``finetune_speaker_v2.py:180-232``).  The fused step
(``accum_steps == 1``):

0. the linear spectrogram of the batch, on the device, in float32;
1. **one** generator forward, its autograd graph kept (JAX's ``jax.vjp``);
2. targets: the log-mel of the spectrogram and the waveform, cut at the
   generator's slice;
3. the discriminator's loss on the detached generated audio, its backward
   and its AdamW update;
4. the generator's losses through the **updated** discriminator, whose
   parameters stop requiring gradients for this pass, so its backward
   reaches the generator alone; then the generator's update.

``accum_steps = k`` splits the batch into k microbatches (the draws are
made once on the whole batch, as JAX's ``_sample``, then split) and runs
two phases.  Phase 1, per microbatch: the spectrogram, a generator forward
under ``no_grad``, the D loss × 1/k, its backward accumulated into D's
``.grad``; then one D update.  Phase 2, per microbatch: the generator
forward again with its graph, the G losses through the updated (frozen) D,
weighted so the microbatches sum to the whole batch's losses (adv, fm and
mel × 1/k; the duration loss, which the model divides by its own batch's
Σx_mask, × Σx_mask_micro / Σx_mask_full; KL × Σy_mask_micro /
Σy_mask_full), their backward accumulated into G's ``.grad``; then one G
update.  The metrics are the sums.  With dropout off, k microbatches give
the fused step's losses and gradients up to the order of float sums.  With
dropout on, each microbatch's two forwards draw the same masks: the device's
default-generator state is saved before its phase-1 forward and restored
before its phase-2 forward, so the ŷ that trained D is the ŷ that trains G.
MAS runs in every forward: 2k times a step, at ``[B/k, T_y, T_x]``.

The spectral-norm discriminator (``use_spectral_norm``) runs one power
iteration per D call inside the D update (:func:`~..models.layers.power_iteration`;
real then fake, so twice per apply) and none in the G pass, which reads the
updated estimate frozen.  In phase 1 every microbatch starts from the
pre-step ``u``/``v`` and micro 0's result is kept (``step.py:474-481``), so
the estimate advances twice per step, as in the fused step.

``remat`` wraps the generator forward whose graph the step keeps
(``torch.utils.checkpoint``, non-reentrant): ``"full"`` saves only its
inputs and recomputes it in the backward; ``"dots"`` saves the outputs of
convolutions and matrix products and recomputes the rest (selective
checkpointing), JAX's ``dots_with_no_batch_dims_saveable``.  The step's own
draws are made outside the checkpointed function; the dropout masks come
from the default generator, whose state the checkpoint saves and replays.
The recompute runs the forward again, MAS included: a rematerialised step
launches MAS twice per forward with a graph (measured in ``chip_smoke.py``
phase 14).

Each phase runs inside a ``torch.profiler.record_function`` range named
``train/<phase>``, so a profile splits the step's host and device time by
phase (free when no profiler runs).  With ``bf16_run`` the generator and
discriminator forwards run under ``torch.autocast(bfloat16)``; the
spectrograms, the power iteration and every loss stay float32.  Dropout
follows the modules' mode, which the caller sets: the Trainer calls
``.train()``, the parity tests ``.eval()`` (JAX's ``deterministic=True``).
The step's own draws (slice starts, posterior and duration noise) come from
the ``torch.Generator`` it is given, or are injected as :class:`Samples`.

Data parallelism: the step runs on this process's rows of a global batch
across the data axis of its mesh (:class:`~..parallel.Mesh`: W data ranks,
equal batch sizes; W = 1 without a group) and computes the global batch's
losses and gradients, as the JAX package's GSPMD step does (not DDP's mean
of per-rank means).  Each data rank is weighted as one microbatch of the
global batch, the weighting of ``accum_steps``: the batch-mean terms (D
loss, adversarial, feature and mel) × 1/W, the duration loss ×
Σx_mask_rank / Σx_mask_global and KL × Σy_mask_rank / Σy_mask_global, the
global sums from one all-reduce of [Σx, Σy] over the data group a step (in
the accumulated step after phase 1, with its 1/k).  Each update sums the
gradients over the data group (:func:`~..parallel.allreduce_grads`) before
the norm and AdamW, so every rank takes the same update, and the metrics
are summed over it, so every rank holds the global values.  The power
iteration sees the same weights on every rank, so ``u``/``v`` stay equal
without a broadcast.  With W = 1 every weight is exactly 1 (1/1, x/x) and
every collective is skipped, so there is one step: on one process it is
the plain step bit for bit.  The collectives are explicit, not
``DistributedDataParallel``: D runs twice a step (the second time frozen),
the accumulated step runs 2k backwards before one update, and remat
re-enters the G forward, which DDP's hooks do not expect.

Tensor parallelism (a mesh ``model`` axis above 1): the modules hold the
slices of :func:`~..parallel.tp.shard_module`, whose layers gather their
outputs, so the ranks of a model group compute the same losses on the same
rows (the caller gives them the same rows and draws).  Each update then
sums the gradients over the data group, gives the model group its model
index 0's gradient of each replicated parameter
(:func:`~..parallel.tp.sync_replicated_grads`), takes the norm with the
slices' squares summed over the model group, and AdamW updates the slices.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from personalized_text_to_speech_tpu_torch import parallel
from personalized_text_to_speech_tpu_torch.models.layers import power_iteration
from personalized_text_to_speech_tpu_torch.parallel import tp
from personalized_text_to_speech_tpu_torch.ops.masking import slice_segments
from personalized_text_to_speech_tpu_torch.ops.spectrogram import (
    MelConfig,
    linear_spectrogram,
    mel_spectrogram,
    spec_to_mel,
)
from personalized_text_to_speech_tpu_torch.train import losses
from personalized_text_to_speech_tpu_torch.train.state import TrainState, global_norm

REMAT_POLICIES = ("none", "dots", "full")
# remat "dots": the ops whose outputs the checkpoint keeps
_SAVE_DOTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
     torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
     torch.ops.aten.baddbmm.default])


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


def _split(t: Optional[torch.Tensor], k: int) -> List[Optional[torch.Tensor]]:
    return [None] * k if t is None else list(t.chunk(k))


def _default_generator(device: torch.device) -> torch.Generator:
    """The generator dropout draws from on ``device``."""
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def _spectral_buffers(d: torch.nn.Module) -> List[torch.Tensor]:
    return [b for n, b in d.named_buffers()
            if n.endswith(("weight_u", "weight_v"))]


def _assign(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    with torch.no_grad():
        for a, b in zip(dst, src):
            a.copy_(b)


def make_train_step(hps, debug_grads: bool = False, accum_steps: int = 1,
                    remat: str = "none",
                    mesh: Optional[parallel.Mesh] = None):
    """Build ``step(g_state, d_state, batch, generator=None, samples=None)
    → metrics``, which updates both states in place.

    Metrics are device tensors (``loss/g/*``, ``loss/d/*``, ``loss/d_r/i``,
    ``loss/d_g/i``, ``grad_norm_g/d``, as ``step.py:359-376``); the caller
    reads them to the host when it logs.  ``debug_grads=True`` adds the
    gradients as ``{name: tensor}`` under ``_grads_g``/``_grads_d`` and the
    generator's detached outputs of the pass that trains G under ``_out``
    (the microbatches' joined along the batch); with ``accum_steps > 1`` also
    phase 1's under ``_out_d``.  ``accum_steps`` and ``remat``: the
    module docstring; the batch size must be divisible by ``accum_steps``.
    The step runs on ``mesh`` (default: the data mesh of the group of
    :mod:`..parallel` that exists when it is built; none: one process),
    and ``batch`` is this rank's rows.
    """
    k = int(accum_steps)
    if k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {k}")
    if remat not in REMAT_POLICIES:
        raise ValueError(
            f"remat must be one of {sorted(REMAT_POLICIES)}, got {remat!r}")
    mel_cfg = MelConfig.from_hparams(hps)
    hop = hps.data.hop_length
    seg_samples = hps.train.segment_size
    seg_frames = seg_samples // hop
    c_mel = hps.train.c_mel
    c_kl = hps.train.c_kl
    inter_ch = hps.model.inter_channels
    use_sdp = bool(hps.model.get("use_sdp", True))
    bf16 = uses_bf16(hps)
    if mesh is None:
        mesh = parallel.create_mesh(None)
    # the weight of a microbatch's batch-mean terms in the global batch (1 in
    # the fused step on one data rank: the products are then exact)
    inv_k = 1.0 / (k * mesh.data)

    def data_sum_(tensors):
        if mesh.data > 1:
            parallel.allreduce_(tensors, mesh.data_group)

    def autocast(device):
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                              enabled=bf16)

    def g_forward(g, batch: Batch, spec, samples: Samples):
        """The generator forward (MAS inside), checkpointed as ``remat``
        says when a graph is being recorded.  Tensors go positionally, so
        the checkpoint saves and replays their device's generator."""
        def run(text, text_lengths, spec, spec_lengths, sid, ids, post, dp):
            return g(text, text_lengths, spec, spec_lengths, sid,
                     slice_ids=ids, posterior_noise=post, dp_noise=dp)

        args = (batch.text, batch.text_lengths, spec,
                (batch.wav_lengths // hop).int(), batch.sid, *samples)
        with record_function("train/g_forward"), autocast(spec.device):
            if remat == "none" or not torch.is_grad_enabled():
                return run(*args)
            if remat == "dots":
                return checkpoint(run, *args, use_reentrant=False,
                                  context_fn=_SAVE_DOTS)
            return checkpoint(run, *args, use_reentrant=False)

    def wav_target(batch: Batch, ids):
        return slice_segments(batch.wav, ids * hop, seg_samples)

    def mel_target(spec, ids):
        with torch.no_grad():
            mel = spec_to_mel(spec, mel_cfg).transpose(1, 2)  # [B, mels, Ts]
            return slice_segments(mel, ids, seg_frames)

    def d_losses(d, y_seg, y_hat):
        """The D loss on (real, detached generated), the power iteration
        on."""
        with record_function("train/d_forward"):
            with autocast(y_seg.device), power_iteration(d):
                y_d_r, y_d_g, _, _ = d(y_seg, y_hat.detach())
            return losses.discriminator_loss(y_d_r, y_d_g)

    def g_losses(d, out, y_seg, y_mel, dur_scale, kl_scale):
        """The G losses through ``d`` (frozen by the caller), weighted as a
        microbatch of the global batch (module docstring)."""
        with record_function("train/g_losses"):
            y_hat = out["wav_hat"]
            y_hat_mel = mel_spectrogram(y_hat, mel_cfg).transpose(1, 2)
            with autocast(y_hat.device):
                _, y_d_g, fmap_r, fmap_g = d(y_seg, y_hat)
            loss_dur = torch.sum(out["l_length"].float()) * dur_scale
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * (c_mel * inv_k)
            loss_kl = losses.kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                                     out["logs_p"], out["y_mask"])
            loss_kl = loss_kl * c_kl * kl_scale
            loss_fm = losses.feature_loss(fmap_r, fmap_g) * inv_k
            loss_gen, gen_losses = losses.generator_loss(y_d_g)
            loss_gen = loss_gen * inv_k
            total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
        return {"loss/g/total": total, "loss/g/gen": loss_gen,
                "loss/g/fm": loss_fm, "loss/g/mel": loss_mel,
                "loss/g/dur": loss_dur, "loss/g/kl": loss_kl,
                **{f"loss/g/{i}": v * inv_k for i, v in enumerate(gen_losses)}}

    def mask_sums(x_sum, y_sum):
        """[Σx_mask, Σy_mask] of the global batch (one all-reduce)."""
        sums = torch.stack([x_sum, y_sum])
        with record_function("train/normaliser_allreduce"):
            data_sum_([sums])
        return sums[0], sums[1]

    def update(state: TrainState, name: str):
        with record_function(f"train/{name}_allreduce"):
            if mesh.data > 1:
                parallel.allreduce_grads(state.module, mesh.data_group)
            tp.sync_replicated_grads(state.module, mesh)
        with record_function(f"train/{name}_update"):
            grads = {n: p.grad for n, p in state.module.named_parameters()}
            present = [n for n, v in grads.items() if v is not None]
            sharded = tp.sharded_names(state.module)
            norm = global_norm([grads[n] for n in present],
                               sharded=[n in sharded for n in present],
                               group=mesh.model_group)
            state.apply_gradients()
        return grads, norm

    def finish(g_metrics, d_loss, d_r, d_g, grad_norm_g, grad_norm_d):
        metrics = {
            "loss/g/total": g_metrics["loss/g/total"],
            "loss/d/total": d_loss,
            "grad_norm_g": grad_norm_g,
            "grad_norm_d": grad_norm_d,
            **{n: v for n, v in g_metrics.items() if n != "loss/g/total"},
        }
        # per-discriminator breakdown (reference finetune_speaker_v2.py:246-248)
        metrics.update({f"loss/d_r/{i}": v for i, v in enumerate(d_r)})
        metrics.update({f"loss/d_g/{i}": v for i, v in enumerate(d_g)})
        metrics = {n: v.detach() for n, v in metrics.items()}
        # the loss terms are this rank's shares: their sums are the global
        # batch's (the gradient norms are global already)
        names = [n for n in metrics if n.startswith("loss/")]
        flat = torch.stack([metrics[n].float() for n in names])
        with record_function("train/metrics_allreduce"):
            data_sum_([flat])
        metrics.update(zip(names, flat.unbind()))
        return metrics

    def fused_step(g_state: TrainState, d_state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   samples: Optional[Samples] = None) -> Dict[str, torch.Tensor]:
        g, d = g_state.module, d_state.module
        if samples is None:
            samples = draw_samples(batch, hop, seg_frames, inter_ch, use_sdp,
                                   generator)
        ids = samples.ids_slice

        # ---- 0. on-device features --------------------------------------
        with record_function("train/spectrogram"):
            spec = linear_spectrogram(batch.wav, mel_cfg)  # [B, Ts, F]

        # ---- 1. one generator forward, graph kept -----------------------
        out = g_forward(g, batch, spec, samples)

        # ---- 2. targets ---------------------------------------------------
        with record_function("train/targets"):
            y_mel = mel_target(spec, ids)
            y_seg = wav_target(batch, ids)

        # ---- 3. discriminator update on the detached audio ----------------
        loss_disc, d_r, d_g = d_losses(d, y_seg, out["wav_hat"])
        # this rank's share of the global batch (all 1 on one process)
        loss_disc = loss_disc * inv_k
        d_r = [v * inv_k for v in d_r]
        d_g = [v * inv_k for v in d_g]
        x_rank = out["x_mask"].float().sum()
        y_rank = out["y_mask"].float().sum()
        x_sum, y_sum = mask_sums(x_rank, y_rank)
        dur_scale, kl_scale = x_rank / x_sum, y_rank / y_sum
        with record_function("train/d_backward"):
            d_state.optimizer.zero_grad(set_to_none=True)
            loss_disc.backward()
        grads_d, grad_norm_d = update(d_state, "d")

        # ---- 4. generator losses through the UPDATED discriminator --------
        d.requires_grad_(False)
        try:
            g_metrics = g_losses(d, out, y_seg, y_mel, dur_scale, kl_scale)
            with record_function("train/g_backward"):
                g_state.optimizer.zero_grad(set_to_none=True)
                g_metrics["loss/g/total"].backward()
        finally:
            d.requires_grad_(True)
        grads_g, grad_norm_g = update(g_state, "g")

        metrics = finish(g_metrics, loss_disc, d_r, d_g, grad_norm_g,
                         grad_norm_d)
        if debug_grads:
            metrics["_grads_g"] = grads_g
            metrics["_grads_d"] = grads_d
            metrics["_out"] = {n: v.detach() for n, v in out.items()}
        return metrics

    def accum_step(g_state: TrainState, d_state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   samples: Optional[Samples] = None) -> Dict[str, torch.Tensor]:
        g, d = g_state.module, d_state.module
        b = batch.wav.shape[0]
        if b % k:
            raise ValueError(f"batch size {b} not divisible by accum_steps {k}")
        if samples is None:
            samples = draw_samples(batch, hop, seg_frames, inter_ch, use_sdp,
                                   generator)
        micro = [Batch(*p) for p in zip(*(t.chunk(k) for t in batch))]
        micro_samples = [Samples(*p)
                         for p in zip(*(_split(t, k) for t in samples))]
        masks = _default_generator(batch.wav.device)
        spectral = _spectral_buffers(d)
        uv_before = [t.clone() for t in spectral]

        # ---- phase 1: D gradients on detached audio, current D ------------
        mask_states, specs, outs_d = [], [], []
        d_loss = d_r = d_g = 0.0
        x_sum = y_sum = 0.0
        d_state.optimizer.zero_grad(set_to_none=True)
        for i, (mb, ms) in enumerate(zip(micro, micro_samples)):
            mask_states.append(masks.get_state())
            with record_function("train/spectrogram"):
                spec = linear_spectrogram(mb.wav, mel_cfg)
            specs.append(spec)
            with torch.no_grad():
                out = g_forward(g, mb, spec, ms)
            x_sum = x_sum + out["x_mask"].float().sum()
            y_sum = y_sum + out["y_mask"].float().sum()
            if debug_grads:
                outs_d.append({n: v.detach() for n, v in out.items()})
            _assign(spectral, uv_before)
            loss, r, gl = d_losses(d, wav_target(mb, ms.ids_slice),
                                   out["wav_hat"])
            del out
            if i == 0:
                uv_after = [t.clone() for t in spectral]
            with record_function("train/d_backward"):
                (loss * inv_k).backward()
            d_loss = d_loss + loss.detach() * inv_k
            d_r = d_r + torch.stack(r).detach() * inv_k
            d_g = d_g + torch.stack(gl).detach() * inv_k
        masks_after = masks.get_state()
        x_sum, y_sum = mask_sums(x_sum, y_sum)
        grads_d, grad_norm_d = update(d_state, "d")
        _assign(spectral, uv_after)

        # ---- phase 2: G gradients through the UPDATED discriminator -------
        g_metrics, outs = {}, []
        g_state.optimizer.zero_grad(set_to_none=True)
        d.requires_grad_(False)
        try:
            for mb, ms, spec, state in zip(micro, micro_samples, specs,
                                           mask_states):
                masks.set_state(state)
                out = g_forward(g, mb, spec, ms)
                with record_function("train/targets"):
                    y_mel = mel_target(spec, ms.ids_slice)
                    y_seg = wav_target(mb, ms.ids_slice)
                part = g_losses(
                    d, out, y_seg, y_mel,
                    dur_scale=out["x_mask"].float().sum() / x_sum,
                    kl_scale=out["y_mask"].float().sum() / y_sum)
                with record_function("train/g_backward"):
                    part["loss/g/total"].backward()
                for n, v in part.items():
                    g_metrics[n] = g_metrics.get(n, 0.0) + v.detach()
                if debug_grads:
                    outs.append({n: v.detach() for n, v in out.items()})
                del out, part
        finally:
            d.requires_grad_(True)
            masks.set_state(masks_after)
        grads_g, grad_norm_g = update(g_state, "g")

        metrics = finish(g_metrics, d_loss, d_r.unbind(), d_g.unbind(),
                         grad_norm_g, grad_norm_d)
        if debug_grads:
            metrics["_grads_g"] = grads_g
            metrics["_grads_d"] = grads_d
            for key, parts in (("_out", outs), ("_out_d", outs_d)):
                metrics[key] = {n: torch.cat([o[n] for o in parts])
                                for n in parts[0]}
        return metrics

    return fused_step if k == 1 else accum_step
