"""The fine-tuning loop: data, both networks, the fused step, logging and
checkpoints.

Counterpart of ``personalized_text_to_speech_tpu/train/loop.py`` (reference
``finetune_speaker_v2.py:46-310``) on one device: a filelist of wav files →
bucketed batches (a background thread decodes the next ones) → the fused GAN
step of :mod:`.step` → scalars at ``log_interval`` → full train-state
checkpoints at step 0 and every ``eval_interval``, an emergency checkpoint on
failure, and reference-layout ``G_latest.pth``/``D_latest.pth`` at the end.
The run directory records the commit it was started from (``githash``) and
warns when a later run there comes from another.
Pretrained reference ``G_*.pth``/``D_*.pth`` warm-start the networks.

Runs on the card unless the caller asks for the CPU (``device="cpu"``);
without a card the default raises.  Metrics stay on the device and are read
to the host only at ``log_interval``, as ``loop.py:299-300`` does.

Not ported here: the mesh (data, tensor and sequence parallelism become DDP
later), the spectral-norm discriminator, and ``evaluate()`` with its plots and
audio (ROADMAP).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from personalized_text_to_speech_tpu_torch.config import HParams, save_hparams
from personalized_text_to_speech_tpu_torch.data.dataset import (
    BucketBatcher,
    DatasetConfig,
    TextAudioSpeakerDataset,
)
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.train.state import create_train_state
from personalized_text_to_speech_tpu_torch.train.step import Batch, make_train_step
from personalized_text_to_speech_tpu_torch.utils import checkpoint as ckpt
from personalized_text_to_speech_tpu_torch.utils import logging_utils
from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc
from personalized_text_to_speech_tpu_torch.utils.profiling import check_git_hash


class Trainer:
    def __init__(
        self,
        hps: HParams,
        model_dir: str,
        pretrained_g: Optional[str] = None,
        pretrained_d: Optional[str] = None,
        drop_speaker_embed: bool = False,
        device: str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device is available; pass device='cpu' to "
                "train on the CPU"
            )
        if hps.model.get("use_spectral_norm", False):
            raise NotImplementedError(
                "the spectral-norm discriminator is not ported yet"
            )
        self.hps = hps
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        save_hparams(hps, os.path.join(model_dir, "config.json"))
        self.logger = logging_utils.get_logger(model_dir)
        check_git_hash(model_dir)
        self.writer = logging_utils.SummaryWriter(model_dir)

        # data ---------------------------------------------------------
        self.train_set = TextAudioSpeakerDataset(
            hps.data.training_files, DatasetConfig.from_hparams(hps),
            hps.symbols, seed=hps.train.seed,
        )
        self.batcher = BucketBatcher(self.train_set, hps.train.batch_size,
                                     seed=hps.train.seed)
        self.steps_per_epoch = max(len(self.batcher), 1)

        # networks, drawn from the seed on the host -------------------------
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(hps.train.seed)
            g = SynthesizerTrn.from_hparams(hps)
            d = MultiPeriodDiscriminator()
        for path, net, drop in ((pretrained_g, g, drop_speaker_embed),
                                (pretrained_d, d, False)):
            if path:
                state, _ = tc.load_torch_checkpoint(path)
                tc.load_partial_state_dict(net, state, drop_speaker_embed=drop)
                self.logger.info("loaded pretrained %s from %s",
                                 type(net).__name__, path)
        self.g_state = create_train_state(g.to(self.device), hps,
                                          self.steps_per_epoch)
        self.d_state = create_train_state(d.to(self.device), hps,
                                          self.steps_per_epoch)
        self.step_fn = make_train_step(hps)
        # the step's draws; dropout masks come from torch's default generator
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(hps.train.seed + 17)
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
        self.logger.info("resumed at step %d (epoch %d)", step, self.epoch)
        return True

    def save(self) -> None:
        ckpt.save_train_state(self._ckpt_dir(), self.global_step, self.g_state,
                              self.d_state,
                              preserved=int(self.hps.get("preserved", 4)))

    def _ckpt_dir(self) -> str:
        return os.path.join(self.model_dir, "checkpoints")

    def export_reference_checkpoint(self) -> None:
        """Write reference-layout ``G_latest.pth``/``D_latest.pth``, which
        ``TTSEngine(checkpoint_path=…)`` and a later fine-tune's
        ``--pretrained_g/--pretrained_d`` load (reference
        ``finetune_speaker_v2.py:102-115``)."""
        for name, state in (("G", self.g_state), ("D", self.d_state)):
            tc.save_torch_checkpoint(
                state.module.state_dict(),
                os.path.join(self.model_dir, f"{name}_latest.pth"),
                iteration=self.epoch,
                learning_rate=self.hps.train.learning_rate,
            )

    # ------------------------------------------------------------------
    def train_step(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One fused step on a batch of :class:`BucketBatcher`; logs at
        ``log_interval``, checkpoints at step 0 and every ``eval_interval``."""
        hps = self.hps
        t0 = time.perf_counter()
        metrics = self.step_fn(self.g_state, self.d_state,
                               Batch.from_numpy(batch_np, self.device),
                               generator=self.generator)
        if self.global_step % hps.train.log_interval == 0:
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
        # the reference saves at step 0 too
        if self.global_step % hps.train.eval_interval == 0:
            self.save()
        self.global_step += 1
        return metrics

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
            self.save()
            raise
        except Exception:
            # the reference loses all progress on a failure; here the full
            # train state is kept, so --cont resumes where the run died
            self.logger.exception("training step failed - saving an "
                                  "emergency checkpoint")
            self.save()
            raise
        self.save()
        self.export_reference_checkpoint()
