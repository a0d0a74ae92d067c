"""Voice-conversion quality gate over parallel (same-text) recordings.

    python -m personalized_text_to_speech_tpu_torch.tools.eval_vc \
        --model OUT/G_latest.pth --config c.json \
        --annotations final_annotation_train.txt --src 0 --tgt 1

The port's copy of ``tools/eval_vc.py``: its flags, plus ``--device``
(default ``cuda``; without a card it raises ``SystemExit``).  The reference
implements voice conversion in the model (``models.py:386-397``) but never
scores it; for every text recorded by both the source and the target
speaker, the source recording is converted to the target's voice on the
device (the port's ``TTSEngine.voice_conversion``: posterior encode → flow
round trip → decode with the target embedding) and scored against the
target's real recording with the objective metrics (reference
``eval_pair.py:42-98``), in PCM16 on both sides.  The *unconverted* source
against the target is scored beside it, as the baseline the conversion must
beat.  The JSON line also holds the seconds spent in conversion (on the
device, the fetch included) and in the metrics (on the host).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from typing import Any, Dict, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.eval_vc",
        description="Evaluate voice conversion on parallel data")
    ap.add_argument("--model", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--annotations", nargs="+", required=True,
                    help="annotation files (path|sid|text) to mine for "
                    "same-text cross-speaker pairs")
    ap.add_argument("--src", type=int, required=True, help="source speaker id")
    ap.add_argument("--tgt", type=int, required=True, help="target speaker id")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--out_dir", default="")
    ap.add_argument("--out_json", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.config import load_hparams
    from personalized_text_to_speech_tpu_torch.data.audio import load_wav_mono
    from personalized_text_to_speech_tpu_torch.eval import evaluate_pair
    from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
    from personalized_text_to_speech_tpu_torch.utils.runtime import require_card

    require_card(args.device)
    hps = load_hparams(args.config)
    engine = TTSEngine(hps, checkpoint_path=args.model, device=args.device)
    sr = engine.sampling_rate

    by_text = defaultdict(dict)
    for ann in args.annotations:
        with open(ann, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                wav_path, sid, text = line.split("|", 2)
                by_text[text][int(sid)] = wav_path
    pairs = [
        (v[args.src], v[args.tgt])
        for v in by_text.values()
        if args.src in v and args.tgt in v
    ]
    if args.limit:
        pairs = pairs[: args.limit]
    if not pairs:
        sys.exit("no same-text cross-speaker pairs found")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    conv_rows, base_rows = [], []
    conversion_s = metrics_s = 0.0
    for src_path, tgt_path in pairs:
        src = load_wav_mono(src_path, sr)
        tgt = load_wav_mono(tgt_path, sr)
        t0 = time.perf_counter()
        _, conv = engine.voice_conversion(src, args.src, args.tgt)
        conversion_s += time.perf_counter() - t0
        # score in the PCM16 representation on both sides (see eval_set.py)
        pcm = (np.clip(conv, -1, 1) * 32767.0).astype(np.int16)
        conv = pcm.astype(np.float32) / 32768.0
        if args.out_dir:
            from scipy.io import wavfile

            wavfile.write(
                os.path.join(args.out_dir, os.path.basename(src_path)),
                sr, pcm,
            )
        t0 = time.perf_counter()
        m_conv = {k: float(v) for k, v in evaluate_pair(tgt, conv, sr).items()}
        m_base = {k: float(v) for k, v in evaluate_pair(tgt, src, sr).items()}
        metrics_s += time.perf_counter() - t0
        conv_rows.append(m_conv)
        base_rows.append(m_base)
        print(
            f"{os.path.basename(src_path)}→{os.path.basename(tgt_path)} "
            + " ".join(f"{k}={v:.2f}" for k, v in m_conv.items())
        )

    def agg(rows):
        out = {}
        for k in rows[0]:
            vals = np.asarray([r[k] for r in rows], dtype=np.float64)
            vals = vals[np.isfinite(vals)]
            out[k] = float(np.median(vals)) if len(vals) else float("nan")
        return out

    result = {
        "n_pairs": len(conv_rows),
        "src": args.src,
        "tgt": args.tgt,
        "converted_vs_target_median": agg(conv_rows),
        "unconverted_vs_target_median": agg(base_rows),
        "seconds": {"conversion": conversion_s, "metrics": metrics_s},
        "device": str(engine.device),
    }
    print(json.dumps(result))
    if args.out_json:
        with open(args.out_json, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
