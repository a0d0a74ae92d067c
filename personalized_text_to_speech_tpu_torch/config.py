"""Config system: JSON → attribute-dict hyperparameters.

The port's own copy of ``personalized_text_to_speech_tpu/config.py``: it reads
the same JSON files (``configs/finetune_speaker.json`` and the rest, with the
``train/data/model/symbols/speakers`` schema of the reference
``utils.py:296-434``) into the same :class:`HParams` tree.

The optional ``tpu`` section keeps its name, because the JSON files share it
with the JAX package.  The port reads its bucket lists, its mesh and ``sp``:

``tpu.text_buckets``   — text-length buckets the serving engine pads to.
``tpu.frame_buckets``  — spectrogram-frame buckets of the decode stage.
``tpu.mesh``           — the data × model layout the ``Trainer`` lays over
                         its process group (``parallel.create_mesh``); a
                         ``model`` axis above 1 is tensor parallelism
                         (``parallel/tp.py``).
``tpu.sp``             — sequence parallelism over that axis: not ported;
                         ``true`` with a ``model`` axis above 1 raises.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Iterator


class HParams:
    """Recursive attribute dict over a JSON config (reference ``utils.py:405-434``)."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    # mapping-style access -------------------------------------------------
    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def __len__(self) -> int:
        return len(self.__dict__)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> Any:
        return setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __iter__(self) -> Iterator[str]:
        return iter(self.__dict__)

    def __repr__(self) -> str:
        return f"HParams({self.__dict__!r})"

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, HParams) else copy.deepcopy(v)
        return out

    def replace(self, **kwargs: Any) -> "HParams":
        new = HParams(**self.to_dict())
        for k, v in kwargs.items():
            new[k] = HParams(**v) if isinstance(v, dict) else v
        return new


# Defaults for the ``tpu`` section (the name the shared JSON files use);
# merged into any loaded config.  The port reads the bucket lists and mesh.
TPU_DEFAULTS: Dict[str, Any] = {
    "compute_dtype": "bfloat16",
    "mesh": {"data": -1},  # -1: use all devices on the data axis
    "text_buckets": [32, 64, 128, 192, 256, 384],
    "frame_buckets": [128, 256, 384, 512, 768, 1024, 1536, 2048],
    "max_frames_per_token": 20,
}


def _merge_defaults(cfg: Dict[str, Any]) -> Dict[str, Any]:
    tpu = dict(TPU_DEFAULTS)
    tpu.update(cfg.get("tpu", {}))
    cfg = dict(cfg)
    cfg["tpu"] = tpu
    return cfg


def load_hparams(config_path: str) -> HParams:
    """Load a JSON config file into an HParams tree (reference ``utils.py:361-367``)."""
    with open(config_path, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    return HParams(**_merge_defaults(cfg))


def load_hparams_from_dict(cfg: Dict[str, Any]) -> HParams:
    return HParams(**_merge_defaults(cfg))


def save_hparams(hps: HParams, config_path: str) -> None:
    cfg = hps.to_dict()
    os.makedirs(os.path.dirname(os.path.abspath(config_path)), exist_ok=True)
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2, ensure_ascii=False)


def default_model_config(n_speakers: int = 999, symbols=None) -> HParams:
    """Built-in trilingual VITS config matching the reference hyperparameters
    (reference ``configs/finetune_speaker.json:2-53``: hidden 192, filter 768,
    2 heads, 6 layers, gin 256, upsample [8,8,2,2], sr 22050, hop 256)."""
    from personalized_text_to_speech_tpu_torch.text.symbols import SYMBOLS

    cfg = {
        "train": {
            "log_interval": 200,
            "eval_interval": 1000,
            "seed": 1234,
            "epochs": 10000,
            "learning_rate": 2e-4,
            "betas": [0.8, 0.99],
            "eps": 1e-9,
            "batch_size": 16,
            "bf16_run": True,
            "lr_decay": 0.999875,
            "segment_size": 8192,
            "init_lr_ratio": 1,
            "warmup_epochs": 0,
            "c_mel": 45,
            "c_kl": 1.0,
        },
        "data": {
            "training_files": "final_annotation_train.txt",
            "validation_files": "final_annotation_val.txt",
            "text_cleaners": ["cjke_cleaners2"],
            "max_wav_value": 32768.0,
            "sampling_rate": 22050,
            "filter_length": 1024,
            "hop_length": 256,
            "win_length": 1024,
            "n_mel_channels": 80,
            "mel_fmin": 0.0,
            "mel_fmax": None,
            "add_blank": True,
            "n_speakers": n_speakers,
            "cleaned_text": True,
        },
        "model": {
            "inter_channels": 192,
            "hidden_channels": 192,
            "filter_channels": 768,
            "n_heads": 2,
            "n_layers": 6,
            "kernel_size": 3,
            "p_dropout": 0.1,
            "resblock": "1",
            "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
            "upsample_rates": [8, 8, 2, 2],
            "upsample_initial_channel": 512,
            "upsample_kernel_sizes": [16, 16, 4, 4],
            "n_layers_q": 3,
            "use_spectral_norm": False,
            "gin_channels": 256,
        },
        "symbols": list(symbols) if symbols is not None else list(SYMBOLS),
        "speakers": {},
    }
    return load_hparams_from_dict(cfg)


def tiny_model_config(n_speakers: int = 4, symbols=None) -> HParams:
    """Toy geometry (hidden 8, ×64 upsampling, 8 kHz) for CPU-host smoke
    runs, behavioral benches, and the unit-test engines — same shape of
    config as :func:`default_model_config`, ~1000× fewer FLOPs."""
    from personalized_text_to_speech_tpu_torch.text.symbols import SYMBOLS

    cfg = {
        "train": {"segment_size": 2048, "learning_rate": 2e-4,
                  "betas": [0.8, 0.99], "eps": 1e-9, "batch_size": 2,
                  "seed": 1, "epochs": 1, "lr_decay": 1.0,
                  "log_interval": 1, "eval_interval": 10,
                  "c_mel": 45, "c_kl": 1.0},
        "data": {
            "sampling_rate": 8000,
            "filter_length": 256,
            "hop_length": 64,
            "win_length": 256,
            "n_mel_channels": 20,
            "mel_fmin": 0.0,
            "mel_fmax": None,
            "add_blank": True,
            "n_speakers": n_speakers,
            "text_cleaners": ["cjke_cleaners2"],
            "cleaned_text": True,
            "max_wav_value": 32768.0,
            "training_files": "",
            "validation_files": "",
        },
        "model": {
            "inter_channels": 8,
            "hidden_channels": 8,
            "filter_channels": 16,
            "n_heads": 2,
            "n_layers": 1,
            "kernel_size": 3,
            "p_dropout": 0.1,
            "resblock": "2",
            "resblock_kernel_sizes": [3],
            "resblock_dilation_sizes": [[1, 3]],
            "upsample_rates": [8, 8],
            "upsample_initial_channel": 16,
            "upsample_kernel_sizes": [16, 16],
            "use_spectral_norm": False,
            "gin_channels": 6,
        },
        "symbols": list(symbols) if symbols is not None else list(SYMBOLS),
        "speakers": {"alice": 0, "bob": 1},
        "tpu": {"text_buckets": [16, 32, 64],
                "frame_buckets": [32, 64, 128]},
    }
    return load_hparams_from_dict(cfg)
