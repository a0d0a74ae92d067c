"""Write a synthetic-speech fine-tuning corpus with the port's formant
synthesizer (:mod:`~personalized_text_to_speech_tpu_torch.data.formant`):

    python -m personalized_text_to_speech_tpu_torch.tools.make_dataset \
        --out_dir corpus --anno_out short_character_anno.txt \
        --speakers klatt_m,klatt_f --languages E

The port's copy of ``tools/make_dataset.py``, with its flags and its 60
sentences: it stands in for the reference workflow's "record/upload your
voice" step (reference ``README.md:50-70``) and writes one wav per speaker
and sentence plus annotations in the reference format
(``path|speaker|[LANG]text[LANG]``), ready for ``tools.preprocess`` → the
port's trainer → ``tools.eval_set``.  Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

EN_SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells seashells by the seashore.",
    "A watched pot never boils.",
    "Better late than never, but never late is better.",
    "The early bird catches the worm.",
    "Practice makes perfect every single day.",
    "All that glitters is not gold.",
    "Actions speak louder than words.",
    "The pen is mightier than the sword.",
    "When in Rome, do as the Romans do.",
    "Birds of a feather flock together.",
    "A picture is worth a thousand words.",
    "Beauty is in the eye of the beholder.",
    "Every cloud has a silver lining.",
    "Honesty is the best policy.",
    "Knowledge is power and time is money.",
    "Rome was not built in a day.",
    "The grass is always greener on the other side.",
    "Two heads are better than one.",
    "You cannot judge a book by its cover.",
    "Morning sunlight streamed through the tall windows.",
    "The train arrives at seven thirty each evening.",
    "Please remember to water the plants this weekend.",
    "Their garden is full of roses and tulips.",
    "We walked along the river until the sun went down.",
    "He packed his bag and left for the airport.",
    "The museum opens at nine and closes at five.",
    "Fresh bread smells wonderful in the morning.",
    "A gentle breeze carried the scent of pine trees.",
    "The children played happily in the park all afternoon.",
    "Winter brings snow and long quiet nights.",
    "The orchestra played a beautiful symphony.",
    "Reading books expands the mind and the heart.",
    "The lighthouse guided ships safely to the harbor.",
    "Autumn leaves turned red and gold in October.",
    "Science explains the wonders of the natural world.",
    "The baker kneaded the dough with practiced hands.",
    "Mountains rose sharply beyond the green valley.",
    "A cup of tea solves almost everything.",
    "The library was silent except for turning pages.",
]

ZH_SENTENCES = [
    "今天天气很好，我们去公园散步吧。",
    "我喜欢喝热茶，也喜欢吃点心。",
    "他每天早上六点起床跑步。",
    "这本书非常有意思，值得一读。",
    "春天来了，花园里开满了鲜花。",
    "火车马上就要进站了，请大家注意安全。",
    "妈妈做的饭菜是世界上最好吃的。",
    "学习外语需要耐心和练习。",
    "晚上的城市灯火通明，非常漂亮。",
    "周末我们一起去爬山好不好。",
]

JA_SENTENCES = [
    "きょうはとてもいいてんきですね。",
    "わたしはまいにちにほんごをべんきょうします。",
    "あめがふっていますから、かさをもっていきましょう。",
    "このほんはとてもおもしろいです。",
    "でんしゃはしちじにしゅっぱつします。",
    "やまのうえからうみがみえます。",
    "ともだちといっしょにえいがをみました。",
    "はるになるとさくらがさきます。",
    "おちゃをのみながらはなしをしましょう。",
    "せんせいはとてもしんせつなひとです。",
]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.make_dataset")
    parser.add_argument("--out_dir", default="./custom_character_voice")
    parser.add_argument("--anno_out", default="./short_character_anno.txt")
    parser.add_argument("--speakers", default="klatt_m,klatt_f",
                        help="comma-separated formant speaker names")
    parser.add_argument("--languages", default="E", choices=["E", "CJE"],
                        help="E: English only; CJE: trilingual")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from scipy.io import wavfile

    from personalized_text_to_speech_tpu_torch.data import formant

    os.makedirs(args.out_dir, exist_ok=True)
    speakers = args.speakers.split(",")
    sents = [("English", s) for s in EN_SENTENCES]
    if args.languages == "CJE":
        sents += [("Chinese", s) for s in ZH_SENTENCES]
        sents += [("Japanese", s) for s in JA_SENTENCES]
    mark = {"English": "[EN]", "Chinese": "[ZH]", "Japanese": "[JA]"}

    lines = []
    idx = 0
    for spk in speakers:
        spk_dir = os.path.join(args.out_dir, spk)
        os.makedirs(spk_dir, exist_ok=True)
        for lang, sent in sents:
            wav, _ = formant.synthesize_text(
                sent, language=lang, speaker=spk, seed=args.seed + idx
            )
            path = os.path.join(spk_dir, f"utt_{idx:04d}.wav")
            wavfile.write(path, formant.SR, (wav * 32767.0).astype(np.int16))
            lines.append(f"{path}|{spk}|{mark[lang]}{sent}{mark[lang]}\n")
            idx += 1
    with open(args.anno_out, "w", encoding="utf-8") as f:
        f.writelines(lines)
    print(f"wrote {idx} utterances for {len(speakers)} speakers "
          f"to {args.out_dir}; annotations in {args.anno_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
