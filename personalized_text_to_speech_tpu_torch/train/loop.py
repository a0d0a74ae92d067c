"""The fine-tuning loop: data, both networks, the fused step, logging and
checkpoints.

Counterpart of ``personalized_text_to_speech_tpu/train/loop.py`` (reference
``finetune_speaker_v2.py:46-310``) on one device per process: a filelist of wav files →
bucketed batches (a background thread decodes the next ones) → the fused GAN
step of :mod:`.step` → scalars at ``log_interval`` → at step 0 and every
``eval_interval``, :meth:`Trainer.evaluate` (one validation utterance
synthesized: its audio, mel and alignment under ``<model_dir>/eval``, and
the ground truth's at step 0) and a full train-state checkpoint → an
emergency checkpoint on failure, and reference-layout
``G_latest.pth``/``D_latest.pth`` at the end.
The run directory records the commit it was started from (``githash``) and
warns when a later run there comes from another.
Pretrained reference ``G_*.pth``/``D_*.pth`` warm-start the networks.

Runs on the card unless the caller asks for the CPU (``device="cpu"``);
without a card the default raises.  Metrics stay on the device and are read
to the host only at ``log_interval``, as ``loop.py:299-300`` does.

The config's ``model.use_spectral_norm`` builds the spectral-norm
discriminator, whose ``weight_u``/``weight_v`` ride in its state dict
(checkpoints, ``resume``, the exported ``D_latest.pth`` and a pretrained
``D_*.pth`` alike); ``train.accum_steps`` and ``train.remat`` go to the step
(:mod:`.step`), as JAX ``loop.py:203-219``.

Data parallelism (JAX ``loop.py:64-101,285-293``): when the caller has
joined a process group (:func:`~..utils.runtime.init_distributed`), the
Trainer lays ``tpu.mesh`` over it (:func:`~..parallel.create_mesh`: data ×
model is the world size), takes the card ``LOCAL_RANK``, iterates its data
index's shard of the batches (``steps_per_epoch`` is the per-rank count),
broadcasts rank 0's weights after the init and the pretrained load, and
its step's losses and gradients are the global batch's (:mod:`.step`).
The step's draws and the dropout masks come from generators seeded ``seed
+ SEED_OFFSET·data_index`` (data index 0 draws what one process draws; the
ranks of a model group draw alike).  Only rank 0 writes ``config.json``,
``train.log``, TensorBoard, ``eval/``, the checkpoints and the exported
``.pth``; a barrier follows each ``save`` and ``evaluate``.  A rank whose
step raises re-raises (rank 0 first writes its emergency checkpoint, with
no barrier, unless the modules are sharded); its peers then fail in their
next collective, at the latest at the group's timeout.

Tensor parallelism (JAX ``loop.py:161-204``): with a ``model`` axis above 1
and ``tpu.sp`` false, G and D are sharded over the model group after the
broadcast (:func:`~..parallel.tp.shard_module`; the sharded share of G is
logged) and AdamW holds the slices' moments.  ``save``, ``resume`` and
``export_reference_checkpoint`` write and read the full state (every rank
gathers, rank 0 writes, every rank reads and keeps its slices), so a
checkpoint is one file whatever the tp size, and a run resumes at another.
:meth:`Trainer.evaluate` gathers G's full weights on every rank and rank 0
runs an unsharded copy: a sharded forward on rank 0 alone would wait for
its peers.  The emergency checkpoint of a failed step needs every rank's
slices, which a failing group may not give, so under tensor parallelism it
is not written (the last regular checkpoint stands).  ``tpu.sp`` with a
``model`` axis above 1 (JAX's sequence parallelism) raises
``NotImplementedError``: ROADMAP.md, Queue 1, item 9.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from personalized_text_to_speech_tpu_torch import parallel
from personalized_text_to_speech_tpu_torch.config import HParams, save_hparams
from personalized_text_to_speech_tpu_torch.data.dataset import (
    BucketBatcher,
    DatasetConfig,
    TextAudioSpeakerDataset,
)
from personalized_text_to_speech_tpu_torch.infer.engine import _next_bucket
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.ops.spectrogram import (
    MelConfig,
    linear_spectrogram,
    spec_to_mel,
)
from personalized_text_to_speech_tpu_torch.parallel import tp
from personalized_text_to_speech_tpu_torch.train.state import create_train_state
from personalized_text_to_speech_tpu_torch.train.step import (
    Batch,
    _default_generator,
    make_train_step,
    uses_bf16,
)
from personalized_text_to_speech_tpu_torch.utils import checkpoint as ckpt
from personalized_text_to_speech_tpu_torch.utils import logging_utils
from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc
from personalized_text_to_speech_tpu_torch.utils.profiling import check_git_hash

# data index r of a data-parallel run seeds its draws and dropout masks
# with seed + SEED_OFFSET·r
SEED_OFFSET = 1000

_SP_TODO = ("tpu.sp (sequence parallelism over the mesh's `model` axis, JAX "
            "parallel/sp.py) is not ported yet: ROADMAP.md, Queue 1, item 9. "
            "Set tpu.sp to false for tensor parallelism over that axis")


class Trainer:
    def __init__(
        self,
        hps: HParams,
        model_dir: str,
        pretrained_g: Optional[str] = None,
        pretrained_d: Optional[str] = None,
        drop_speaker_embed: bool = False,
        device: str = "cuda",
        use_mesh: bool = True,
    ):
        self.rank, self.world = parallel.rank(), parallel.world_size()
        self.is_primary = self.rank == 0
        if use_mesh:
            axes = dict(hps.tpu.mesh.items())
            if hps.tpu.get("sp", False) and axes.get("model", 1) != 1:
                raise NotImplementedError(_SP_TODO)
            self.mesh = parallel.create_mesh(axes)  # raises if unmet
        elif self.world > 1:
            raise ValueError(
                f"use_mesh=False trains on one process; this group has "
                f"{self.world}")
        else:
            self.mesh = parallel.create_mesh(None)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device is available; pass device='cpu' to "
                "train on the CPU"
            )
        if self.device.type == "cuda" and self.device.index is None \
                and torch.distributed.is_initialized():
            self.device = torch.device(
                "cuda", parallel.local_rank() % torch.cuda.device_count())
        self.hps = hps
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        if self.is_primary:
            save_hparams(hps, os.path.join(model_dir, "config.json"))
            self.logger = logging_utils.get_logger(model_dir)
            check_git_hash(model_dir)
            self.writer = logging_utils.SummaryWriter(model_dir)
            self.writer_eval = logging_utils.SummaryWriter(
                os.path.join(model_dir, "eval"))
        else:
            self.logger = logging_utils.get_logger(model_dir, filename=None)
            self.writer = self.writer_eval = None
        self.mel_cfg = MelConfig.from_hparams(hps)

        # data ---------------------------------------------------------
        ds_cfg = DatasetConfig.from_hparams(hps)
        self.train_set = TextAudioSpeakerDataset(
            hps.data.training_files, ds_cfg, hps.symbols, seed=hps.train.seed,
        )
        self.eval_set = (
            TextAudioSpeakerDataset(hps.data.validation_files, ds_cfg,
                                    hps.symbols, seed=hps.train.seed)
            if os.path.exists(hps.data.validation_files) else None
        )
        self.batcher = BucketBatcher(self.train_set, hps.train.batch_size,
                                     shard_index=self.mesh.data_index,
                                     shard_count=self.mesh.data,
                                     seed=hps.train.seed)
        self.steps_per_epoch = max(len(self.batcher), 1)

        # networks, drawn from the seed on the host -------------------------
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(hps.train.seed)
            g = SynthesizerTrn.from_hparams(hps)
            d = MultiPeriodDiscriminator(
                use_spectral_norm=hps.model.get("use_spectral_norm", False))
        for path, net, drop in ((pretrained_g, g, drop_speaker_embed),
                                (pretrained_d, d, False)):
            if path:
                state, _ = tc.load_torch_checkpoint(path)
                tc.load_partial_state_dict(net, state, drop_speaker_embed=drop)
                self.logger.info("loaded pretrained %s from %s",
                                 type(net).__name__, path)
        g.to(self.device)
        d.to(self.device)
        parallel.broadcast_module(g)
        parallel.broadcast_module(d)
        if self.mesh.model > 1:
            sharded, total = tp.count_sharded(g, self.mesh.model)
            self.logger.info(
                "tensor parallelism x%d over 'model': %.1f%% of G params "
                "sharded (%d / %d)", self.mesh.model,
                100.0 * sharded / max(total, 1), sharded, total)
            tp.shard_module(g, self.mesh)
            tp.shard_module(d, self.mesh)
        self.g_state = create_train_state(g, hps, self.steps_per_epoch)
        self.d_state = create_train_state(d, hps, self.steps_per_epoch)
        self.step_fn = make_train_step(
            hps, accum_steps=int(hps.train.get("accum_steps", 1)),
            remat=str(hps.train.get("remat", "none")), mesh=self.mesh)
        self._eval_g = None  # evaluate()'s unsharded copy of G, on rank 0
        # the step's draws, and the device's default generator, which the
        # dropout masks come from
        offset = SEED_OFFSET * self.mesh.data_index
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(hps.train.seed + 17 + offset)
        _default_generator(self.device).manual_seed(hps.train.seed + offset)
        self.global_step = 0
        self.epoch = 1

    # ------------------------------------------------------------------
    def resume(self) -> bool:
        step = ckpt.restore_train_state(self._ckpt_dir(), self.g_state,
                                        self.d_state)
        if step is None:
            return False
        self.global_step = step
        self.epoch = step // self.steps_per_epoch + 1
        parallel.broadcast_over_data(self.g_state.module, self.mesh)
        parallel.broadcast_over_data(self.d_state.module, self.mesh)
        self.logger.info("resumed at step %d (epoch %d)", step, self.epoch)
        return True

    def save(self) -> None:
        """The full train state (gathered by every rank under tensor
        parallelism) written by rank 0, then a barrier."""
        self._save_local()
        parallel.barrier()

    def _save_local(self) -> None:
        if self.is_primary or self.mesh.model > 1:
            ckpt.save_train_state(self._ckpt_dir(), self.global_step,
                                  self.g_state, self.d_state,
                                  preserved=int(self.hps.get("preserved", 4)),
                                  write=self.is_primary)

    def _save_emergency(self) -> None:
        """The checkpoint of a failed run, without collectives: sharded
        modules would need their peers' slices, so there is none under
        tensor parallelism."""
        if self.mesh.model > 1:
            self.logger.warning("tensor parallelism: no emergency checkpoint "
                                "(it needs every rank's slices); the last "
                                "checkpoint stands")
            return
        self._save_local()

    def _ckpt_dir(self) -> str:
        return os.path.join(self.model_dir, "checkpoints")

    def export_reference_checkpoint(self) -> None:
        """Write reference-layout ``G_latest.pth``/``D_latest.pth``, which
        ``TTSEngine(checkpoint_path=…)`` and a later fine-tune's
        ``--pretrained_g/--pretrained_d`` load (reference
        ``finetune_speaker_v2.py:102-115``), whole whatever the tp size
        (every rank gathers); rank 0 writes them, then a barrier."""
        for name, state in (("G", self.g_state), ("D", self.d_state)):
            weights = tp.full_state_dict(state.module)
            if self.is_primary:
                tc.save_torch_checkpoint(
                    weights,
                    os.path.join(self.model_dir, f"{name}_latest.pth"),
                    iteration=self.epoch,
                    learning_rate=self.hps.train.learning_rate,
                )
        parallel.barrier()

    # ------------------------------------------------------------------
    def train_step(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One fused step on a batch of :class:`BucketBatcher`; logs at
        ``log_interval``, evaluates and checkpoints at step 0 and every
        ``eval_interval``."""
        hps = self.hps
        t0 = time.perf_counter()
        metrics = self.step_fn(self.g_state, self.d_state,
                               Batch.from_numpy(batch_np, self.device),
                               generator=self.generator)
        if self.global_step % hps.train.log_interval == 0 and self.is_primary:
            names = list(metrics)
            values = torch.stack([metrics[k].float() for k in names]).tolist()
            scalars = dict(zip(names, values))
            self.logger.info(
                "epoch %d step %d loss_g=%.3f loss_d=%.3f (%.2fs/step)",
                self.epoch, self.global_step, scalars["loss/g/total"],
                scalars["loss/d/total"], time.perf_counter() - t0,
            )
            scalars["learning_rate"] = self.g_state.scheduler.get_last_lr()[0]
            self.writer.summarize(self.global_step, scalars)
        # the reference evaluates and saves at step 0 too (the gt/mel and
        # gt/audio references land in that first eval)
        if self.global_step % hps.train.eval_interval == 0:
            self.evaluate()
            self.save()
        self.global_step += 1
        return metrics

    def _autocast(self):
        """The G forward's precision region, as in the train step."""
        return torch.autocast(device_type=self.device.type,
                              dtype=torch.bfloat16, enabled=uses_bf16(self.hps))

    def _noise(self, injected, seed: int, shape) -> torch.Tensor:
        """The numpy array ``injected[:, :shape[1]]`` on the device, or a
        float32 normal of ``shape`` from a generator of its own seeded
        ``seed``: the training draws (``self.generator``, torch's default
        generator) never move."""
        if injected is not None:
            return torch.from_numpy(np.array(injected[:, : shape[1]],
                                              dtype=np.float32)).to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device)

    def evaluate(
        self, dp_noise=None, prior_noise=None,
    ) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
        """Synthesize one validation utterance to ``<model_dir>/eval``
        (reference ``finetune_speaker_v2.py:313-368``) by the engine's
        bucketed two-stage path: item 0 of the validation set (else of the
        training set) padded to its text bucket → ``infer_encode`` → one
        scalar sync picks the frame bucket → ``infer_decode`` on it and the
        mel of the generated wav, on the Trainer's device, under the train
        step's autocast; the alignment image is built on the host from the
        ceiled durations.  At step 0 the ground truth's mel and audio (padded
        to its frame bucket for the mel) are written too.

        G runs in ``eval()`` under ``torch.no_grad()`` and is put back in
        ``train()``.  The draws come from generators of their own seeded 0
        (durations) and 1 (prior), as the JAX package's ``PRNGKey(0)`` and
        ``PRNGKey(1)``, so the training draws and weights are bit for bit
        as without the call; ``dp_noise`` ``[1, ≥t_bucket, 2]`` and
        ``prior_noise`` ``[1, ≥f_bucket, inter_channels]`` replace them
        (their first bucket's worth is used).  Returns the ``images`` and
        ``audios`` summarized, or ``None`` with no utterance to take.

        In a data-parallel run rank 0 evaluates and the others return
        ``None``; a barrier follows.  Under tensor parallelism every rank
        first gathers G's full weights and rank 0 evaluates an unsharded
        copy of G built from them (module docstring)."""
        model = self.g_state.module
        if tp.is_sharded(model):
            weights = tp.full_state_dict(model)
            if self.is_primary:
                if self._eval_g is None:
                    self._eval_g = SynthesizerTrn.from_hparams(self.hps)
                self._eval_g.load_state_dict(weights, strict=True)
                self._eval_g.to(self.device).train(model.training)
                model = self._eval_g
            del weights
        out = (self._evaluate(model, dp_noise, prior_noise)
               if self.is_primary else None)
        parallel.barrier()
        return out

    def _evaluate(self, model, dp_noise, prior_noise):
        source = self.eval_set or self.train_set
        if len(source) == 0:
            return None
        hps = self.hps
        hop = hps.data.hop_length
        text_buckets = list(hps.tpu.text_buckets)
        frame_buckets = list(hps.tpu.frame_buckets)
        item = source[0]
        ids = np.asarray(item["text"], dtype=np.int64)
        t_bucket = _next_bucket(len(ids), text_buckets)
        n_ids = min(len(ids), t_bucket)
        x = torch.zeros((1, t_bucket), dtype=torch.long)
        x[0, :n_ids] = torch.from_numpy(ids[:n_ids])
        x = x.to(self.device)
        x_lengths = torch.tensor([n_ids], dtype=torch.int32, device=self.device)
        sid = torch.tensor([int(item["sid"])], dtype=torch.long,
                           device=self.device)

        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                with self._autocast():
                    w_ceil, m_p, logs_p, x_mask = model.infer_encode(
                        x, x_lengths, sid,
                        dp_noise=self._noise(dp_noise, 0, (1, t_bucket, 2)))
                n_frames = int(w_ceil.sum(dim=-1).max())  # the one scalar sync
                f_bucket = _next_bucket(max(n_frames, 1), frame_buckets)
                with self._autocast():
                    wav, y_lengths = model.infer_decode(
                        w_ceil, m_p, logs_p, x_mask, sid, max_len=f_bucket,
                        prior_noise=self._noise(
                            prior_noise, 1, (1, f_bucket, m_p.shape[-1])))
                wav = wav.float()
                mel = spec_to_mel(linear_spectrogram(wav, self.mel_cfg),
                                  self.mel_cfg)
                gt_mel = None
                if self.global_step == 0:
                    gt = np.asarray(item["wav"], dtype=np.float32)
                    pad = _next_bucket(max(len(gt) // hop, 1), frame_buckets) * hop
                    gt_p = torch.zeros((1, pad), dtype=torch.float32)
                    gt_p[0, : min(len(gt), pad)] = torch.from_numpy(gt[:pad])
                    gt_mel = spec_to_mel(
                        linear_spectrogram(gt_p.to(self.device), self.mel_cfg),
                        self.mel_cfg)
        finally:
            model.train(was_training)

        y_len = int(y_lengths[0])
        # the alignment from the durations on the host, not the [T_spec,
        # T_text] canvas from the card
        durs = w_ceil[0, :n_ids].float().cpu().numpy()
        attn = np.zeros((min(int(durs.sum()), f_bucket), len(durs)), np.float32)
        pos = 0
        for j, d in enumerate(durs.astype(np.int64)):
            end = min(pos + int(d), attn.shape[0])
            attn[pos:end, j] = 1.0
            pos = end
        images = {
            "gen/mel": logging_utils.plot_spectrogram_to_numpy(
                mel[0, :y_len].cpu().numpy().T),
            "gen/attn": logging_utils.plot_alignment_to_numpy(attn.T),
        }
        audios = {"gen/audio": wav[0, : y_len * hop].cpu().numpy()}
        if gt_mel is not None:
            gt_frames = min(len(gt), pad) // hop
            images["gt/mel"] = logging_utils.plot_spectrogram_to_numpy(
                gt_mel[0, :gt_frames].cpu().numpy().T)
            audios["gt/audio"] = gt
        self.writer_eval.summarize(self.global_step, images=images,
                                   audios=audios,
                                   audio_sampling_rate=hps.data.sampling_rate)
        return images, audios

    def train_epoch(self) -> None:
        self.g_state.module.train()
        self.d_state.module.train()
        self.batcher.set_epoch(self.epoch)
        for batch_np in self.batcher.iter_prefetch():
            self.train_step(batch_np)

    def fit(self, max_epochs: int) -> None:
        try:
            while self.epoch <= min(max_epochs, self.hps.train.epochs):
                self.train_epoch()
                self.logger.info("====> Epoch: %d", self.epoch)
                self.epoch += 1
        except KeyboardInterrupt:
            self.logger.warning("interrupted - saving a checkpoint before exit")
            self._save_emergency()
            raise
        except Exception:
            # the reference loses all progress on a failure; here the full
            # train state is kept, so --cont resumes where the run died.  No
            # barrier: the peers may be waiting in a collective of the step
            self.logger.exception("training step failed - saving an "
                                  "emergency checkpoint")
            self._save_emergency()
            raise
        self.save()
        self.export_reference_checkpoint()
