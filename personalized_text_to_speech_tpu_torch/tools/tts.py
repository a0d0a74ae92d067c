"""CLI synthesis of the port, with the flags of ``tools/tts.py`` (reference
``cmd_inference.py:63-75``):

    python -m personalized_text_to_speech_tpu_torch.tools.tts \\
        -m G_latest.pth -c finetune_speaker.json -o output/ -l English \\
        -t "Hello world" -s speaker_name

-m model (a reference-format ``.pth``), -c config, -o output dir,
-l language, -t text, -s speaker, -on output name, -ns noise_scale
(default .667), -nsw noise_scale_w (default .6, the reference CLI's),
-ls length_scale.  Extras: ``--random-init`` (random weights, no
checkpoint), ``--long-form`` (sentence-split batching), ``--cleaned-text``
(IPA input), ``--dtype``, ``--seed``.  Runs on the card; ``--device cpu``
asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.tts",
        description="VITS inference on the card")
    parser.add_argument("-m", "--model_path", type=str, default=None,
                        help="checkpoint (.pth, reference format)")
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("-o", "--output_path", type=str, default="output/vits")
    parser.add_argument("-l", "--language", type=str, default="English",
                        help="English / Chinese / Japanese / Korean / Mix")
    parser.add_argument("-t", "--text", type=str, required=True)
    parser.add_argument("-s", "--spk", type=str, default=None,
                        help="speaker name (or numeric id)")
    parser.add_argument("-on", "--output_name", type=str, default="output")
    parser.add_argument("-ns", "--noise_scale", type=float, default=0.667)
    parser.add_argument("-nsw", "--noise_scale_w", type=float, default=0.6)
    parser.add_argument("-ls", "--length_scale", type=float, default=1.0)
    parser.add_argument("--random-init", action="store_true",
                        help="run with random weights (no checkpoint needed)")
    parser.add_argument("--long-form", action="store_true")
    parser.add_argument("--cleaned-text", action="store_true",
                        help="input is already IPA symbols; skip G2P")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.model_path is None and not args.random_init:
        parser.error("need -m/--model_path (or --random-init)")

    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.data.audio import save_wav
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine

    eng = TTSEngine(
        load_hparams(args.config_path),
        checkpoint_path=None if args.random_init else args.model_path,
        device=args.device,
        dtype=args.dtype,
        seed=args.seed,
    )
    speaker = args.spk if args.spk is not None else 0
    lang = None if args.language == "Mix" else args.language
    knobs = dict(noise_scale=args.noise_scale, noise_scale_w=args.noise_scale_w)
    if args.cleaned_text:
        ids = eng.text_to_ids(args.text, is_symbol=True)
        wav = eng.synthesize_ids([ids], [eng.speaker_id(speaker)],
                                 length_scale=args.length_scale, **knobs)[0]
        sr = eng.sampling_rate
    elif args.long_form:
        sr, wav = eng.long_form(args.text, speaker=speaker, language=lang,
                                speed=1.0 / args.length_scale, **knobs)
    else:
        sr, wav = eng.tts(args.text, speaker=speaker, language=lang,
                          speed=1.0 / args.length_scale, **knobs)

    os.makedirs(args.output_path, exist_ok=True)
    out_file = os.path.join(args.output_path, args.output_name + ".wav")
    save_wav(out_file, wav, sr)
    print(f"wrote {out_file}: {len(wav) / sr:.2f}s @ {sr}Hz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
