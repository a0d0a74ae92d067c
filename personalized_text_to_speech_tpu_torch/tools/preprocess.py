"""Dataset preprocessing: merge annotations, build the speaker map, rewrite
the training config, clean text (reference ``preprocess_v2.py``):

    python -m personalized_text_to_speech_tpu_torch.tools.preprocess \
        --languages CJE --base_config configs/finetune_speaker.json

The port's copy of ``tools/preprocess.py``, with its flags.  Reads
``short_character_anno.txt`` / ``long_character_anno.txt`` from the working
directory (lines ``path|speaker_name|[LANG]text[LANG]``), optionally
balances with an auxiliary corpus (``sampled_audio4ft.txt``) by duplication
(reference ``preprocess_v2.py:38-57``), assigns speaker IDs, and writes
``final_annotation_{train,val}.txt`` with IPA text cleaned by the port's own
G2P and the rewritten config.  Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def read_annos(path):
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [line for line in f.readlines() if line.strip()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.preprocess")
    parser.add_argument("--add_auxiliary_data", type=bool, default=False,
                        help="balance with extra pretraining-corpus data")
    parser.add_argument("--languages", default="CJE", choices=["CJE", "CJ", "C"])
    parser.add_argument("--base_config", default="./configs/finetune_speaker.json")
    parser.add_argument("--out_config",
                        default="./configs/modified_finetune_speaker.json")
    parser.add_argument("--train_out", default="./final_annotation_train.txt")
    parser.add_argument("--val_out", default="./final_annotation_val.txt")
    parser.add_argument("--max_text_len", type=int, default=150)
    args = parser.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.config import (
        default_model_config,
        load_hparams,
        save_hparams,
    )
    from personalized_text_to_speech_tpu_torch.text import _clean_text

    langs = {"CJE": ["[ZH]", "[JA]", "[EN]"], "CJ": ["[ZH]", "[JA]"],
             "C": ["[ZH]"]}[args.languages]

    new_annos = read_annos("short_character_anno.txt") + read_annos(
        "./long_character_anno.txt"
    )
    if not new_annos:
        raise SystemExit(
            "No annotation files found (short_character_anno.txt / "
            "long_character_anno.txt). Run transcription first."
        )

    speakers = []
    for line in new_annos:
        path, speaker, _ = line.split("|")
        if speaker not in speakers:
            speakers.append(speaker)

    old_annos = []
    if args.add_auxiliary_data:
        old_annos = [
            line
            for line in read_annos("./sampled_audio4ft.txt")
            if any(lang in line for lang in langs)
        ]
        for line in old_annos:
            _, speaker, _ = line.split("|")
            if speaker not in speakers:
                speakers.append(speaker)

    # config rewrite (reference preprocess_v2.py:61-79)
    if os.path.exists(args.base_config):
        hps = load_hparams(args.base_config)
    else:
        hps = default_model_config()
    speaker2id = {s: i for i, s in enumerate(speakers)}
    hps.data.n_speakers = len(speakers)
    hps["speakers"] = speaker2id
    hps.train.log_interval = 10
    hps.train.eval_interval = 100
    hps.train.batch_size = 16
    hps.data.training_files = os.path.abspath(args.train_out)
    hps.data.validation_files = os.path.abspath(args.val_out)
    save_hparams(hps, args.out_config)

    cleaners = list(hps.data.text_cleaners)

    def clean_lines(lines):
        out = []
        for line in lines:
            path, speaker, txt = line.split("|")
            txt = txt.strip("\n")
            if len(txt) > args.max_text_len:
                continue
            cleaned = _clean_text(txt, cleaners)
            out.append(f"{path}|{speaker2id[speaker]}|{cleaned}\n")
        return out

    cleaned_new = clean_lines(new_annos)
    cleaned_old = clean_lines(old_annos)
    if args.add_auxiliary_data and cleaned_new:
        dup = max(len(cleaned_old) // len(cleaned_new), 1)
        final_train = cleaned_old + dup * cleaned_new
    else:
        final_train = cleaned_new

    with open(args.train_out, "w", encoding="utf-8") as f:
        f.writelines(final_train)
    with open(args.val_out, "w", encoding="utf-8") as f:
        f.writelines(cleaned_new)
    print(
        f"finished: {len(final_train)} train / {len(cleaned_new)} val lines, "
        f"{len(speakers)} speakers → {args.out_config}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
