"""Batch-resample a directory of wavs to one sampling rate (reference
``scripts/resample.py``, torchaudio-free):

    python -m personalized_text_to_speech_tpu_torch.tools.resample \
        --in_dir raw --out_dir resampled --sr 22050

The port's copy of ``tools/resample.py``, with its flags: each ``.wav``
read, averaged to mono and resampled polyphase by the port's
``data/audio.py``; without ``--out_dir`` the files are overwritten in place.
Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.resample")
    parser.add_argument("--in_dir", default="./sampled_audio4ft")
    parser.add_argument("--out_dir", default=None,
                        help="default: overwrite in place")
    parser.add_argument("--sr", type=int, default=22050)
    args = parser.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.data.audio import (
        load_wav,
        resample,
        save_wav,
        to_mono,
    )

    out_dir = args.out_dir or args.in_dir
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.in_dir)):
        if not name.lower().endswith(".wav"):
            continue
        wav, sr = load_wav(os.path.join(args.in_dir, name))
        save_wav(os.path.join(out_dir, name), resample(to_mono(wav), sr, args.sr),
                 args.sr)
        n += 1
    print(f"resampled {n} files to {args.sr} Hz in {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
