"""Run logging: a file + console logger per model directory, a summary
writer, and the spectrogram and alignment images of ``Trainer.evaluate``.

The port's own copy of ``personalized_text_to_speech_tpu/utils/logging_utils.py``
(reference ``utils.py:196-283,390-402``): scalars, images and audio to
TensorBoard event files through ``tensorboardX`` where it is installed, the
plots drawn by matplotlib (Agg) where it is installed.

One deliberate divergence, for machines with neither package (the card's
machine has neither): where matplotlib is missing, the plot functions return
the array itself as an 8-bit HWC image (min–max scaled, origin at the
bottom, as the plot shows it); where tensorboardX is missing, the writer
appends the scalars to ``scalars.jsonl`` as the JAX writer does, and also
saves each audio as ``<tag>_<step>.wav`` (the JAX writer's own fallback
name) and each image as ``<tag>_<step>.npy`` in its directory, where the
JAX writer drops both.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import numpy as np

_MATPLOTLIB_READY = False


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or ``None`` without it."""
    global _MATPLOTLIB_READY
    try:
        import matplotlib
    except ImportError:
        return None
    if not _MATPLOTLIB_READY:
        matplotlib.use("Agg")
        logging.getLogger("matplotlib").setLevel(logging.WARNING)
        _MATPLOTLIB_READY = True
    import matplotlib.pylab as plt

    return plt


def _array_image(a: np.ndarray) -> np.ndarray:
    """``[H, W]`` → ``[H, W, 3]`` uint8, min–max scaled, row 0 at the bottom."""
    a = np.asarray(a, dtype=np.float64)[::-1]
    lo, hi = (float(a.min()), float(a.max())) if a.size else (0.0, 0.0)
    scaled = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    grey = np.round(scaled * 255.0).astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=-1)


def _figure_image(plt, fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return data


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """[n_mels, T] → HWC uint8 image (reference ``utils.py:230-253``)."""
    plt = _pyplot()
    if plt is None:
        return _array_image(spectrogram)
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    return _figure_image(plt, fig)


def plot_alignment_to_numpy(alignment: np.ndarray, info: Optional[str] = None) -> np.ndarray:
    """[T_spec, T_text] hard path → HWC uint8 image (reference ``utils.py:256-282``)."""
    plt = _pyplot()
    if plt is None:
        return _array_image(np.asarray(alignment).T)
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment.T, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep" + (f"\n\n{info}" if info else "")
    plt.xlabel(xlabel)
    plt.ylabel("Encoder timestep")
    plt.tight_layout()
    return _figure_image(plt, fig)


class SummaryWriter:
    """tensorboardX if importable, else ``scalars.jsonl`` plus a ``.wav``
    per audio and a ``.npy`` per image."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = None
        try:
            from tensorboardX import SummaryWriter as TBWriter
        except ImportError:
            self._tb = None
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                               encoding="utf-8")
        else:
            self._tb = TBWriter(log_dir=log_dir)

    def _file(self, tag: str, step: int, ext: str) -> str:
        return os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.{ext}")

    def _save_wav(self, tag: str, step: int, audio, sampling_rate: int) -> None:
        from personalized_text_to_speech_tpu_torch.data.audio import save_wav

        save_wav(self._file(tag, step, "wav"), np.asarray(audio).reshape(-1),
                 sampling_rate)

    def summarize(
        self,
        global_step: int,
        scalars: Optional[Dict[str, float]] = None,
        images: Optional[Dict[str, np.ndarray]] = None,
        audios: Optional[Dict[str, np.ndarray]] = None,
        audio_sampling_rate: int = 22050,
    ) -> None:
        scalars = scalars or {}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step)
            for k, v in (images or {}).items():
                self._tb.add_image(k, v, global_step, dataformats="HWC")
            for k, v in (audios or {}).items():
                try:
                    self._tb.add_audio(k, np.asarray(v).reshape(-1, 1),
                                       global_step,
                                       sample_rate=audio_sampling_rate)
                except Exception:
                    # tensorboardX's audio encoder needs soundfile: a plain
                    # wav next to the event files instead
                    self._save_wav(k, global_step, v, audio_sampling_rate)
            return
        self._jsonl.write(json.dumps(
            {"step": global_step, **{k: float(v) for k, v in scalars.items()}}
        ) + "\n")
        self._jsonl.flush()
        for k, v in (images or {}).items():
            np.save(self._file(k, global_step, "npy"), np.asarray(v))
        for k, v in (audios or {}).items():
            self._save_wav(k, global_step, v, audio_sampling_rate)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def get_logger(model_dir: str,
               filename: Optional[str] = "train.log") -> logging.Logger:
    """File + console logger per run directory (reference ``utils.py:390-402``);
    console only with ``filename=None`` (the ranks of a data-parallel run
    other than rank 0).  The lines name the directory's basename, as the
    reference's do; the logger is keyed by the whole path, so two run
    directories of one name in a process keep their own ``train.log``."""
    path = os.path.abspath(model_dir)
    logger = logging.getLogger(path)
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s\t" + os.path.basename(path).replace("%", "%%")
            + "\t%(levelname)s\t%(message)s")
        if filename is not None:
            os.makedirs(model_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(model_dir, filename),
                                     encoding="utf-8")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger
