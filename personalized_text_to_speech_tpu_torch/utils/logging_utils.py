"""Run logging: a file + console logger per model directory and a scalar
summary writer.

The port's own copy of ``get_logger`` and ``SummaryWriter`` from
``personalized_text_to_speech_tpu/utils/logging_utils.py`` (reference
``utils.py:196-228,390-402``): TensorBoard event files through
``tensorboardX`` where it is installed, else one JSON line of scalars per
call in ``scalars.jsonl``.  Scalars only: the spectrogram and alignment
plots and the audio come with ``evaluate()`` (ROADMAP).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict


class SummaryWriter:
    """Scalars to TensorBoard (``tensorboardX``) or to ``scalars.jsonl``."""

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

    def summarize(self, global_step: int, scalars: Dict[str, float]) -> None:
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step)
        else:
            self._jsonl.write(json.dumps(
                {"step": global_step, **{k: float(v) for k, v in scalars.items()}}
            ) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    """File + console logger per run directory (reference ``utils.py:390-402``)."""
    logger = logging.getLogger(os.path.basename(os.path.abspath(model_dir)))
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        os.makedirs(model_dir, exist_ok=True)
        fmt = logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
        fh = logging.FileHandler(os.path.join(model_dir, filename), encoding="utf-8")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger
