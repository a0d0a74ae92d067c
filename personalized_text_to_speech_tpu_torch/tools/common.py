"""What the measurement tools share: the ``--device`` and ``--tiny`` flags,
the model they build, the set-up before anything is timed, and the JSON line
each result is printed as.

Every line carries ``device`` (:func:`~..utils.profiling.device_info`),
``dtype`` and ``tf32``.  A line taken on the CPU holds ``None`` in every rate
and every share of a peak: those are device figures, and a CPU run has none.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Iterable

from personalized_text_to_speech_tpu_torch.utils import profiling, runtime


def add_device_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--tiny", action="store_true",
                        help="toy geometry (config.tiny_model_config) for CPU "
                             "runs of the tool's logic; its numbers measure "
                             "nothing of the full model")


def model_config(tiny: bool):
    """The full width of ``configs/finetune_speaker.json`` (hidden 192, 6
    layers, upsampling [8,8,2,2], 999 speakers), or the toy geometry."""
    from personalized_text_to_speech_tpu_torch.config import (
        default_model_config,
        tiny_model_config,
    )

    return tiny_model_config() if tiny else default_model_config(n_speakers=999)


def setup(device) -> Dict[str, Any]:
    """Refuse a missing card, pay the first round trip, and return the
    device's description for the lines."""
    runtime.require_card(device)
    runtime.warmup_transfers(device)
    return profiling.device_info(device)


def _blank(row: Dict[str, Any], rates: Iterable[str]) -> None:
    for k, v in row.items():
        if k in rates:
            row[k] = None
        elif isinstance(v, dict):
            _blank(v, rates)


def emit(row: Dict[str, Any], info: Dict[str, Any], dtype: str,
         rates: Iterable[str] = ()) -> Dict[str, Any]:
    """Stamp ``row`` with the device, dtype and TF32 state, blank its
    ``rates`` (at any depth) when it was taken on the CPU, print it as one
    JSON line, and return it."""
    if info["platform"] != "gpu":
        _blank(row, set(rates))
    row.update(device=info, dtype=dtype, tf32=info["tf32"])
    print(json.dumps(row, ensure_ascii=False), flush=True)
    return row
