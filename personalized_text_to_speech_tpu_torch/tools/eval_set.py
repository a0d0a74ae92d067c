"""Quality gate over a whole annotation set: synthesize every line with a
trained checkpoint on the card and score it against its ground truth.

    python -m personalized_text_to_speech_tpu_torch.tools.eval_set \
        --model OUT/G_latest.pth --config OUT/config.json \
        --annotations final_annotation_val.txt --out_json eval_set.json

The port's copy of ``tools/eval_set.py``: its flags, plus ``--device``
(default ``cuda``; without a card it raises ``SystemExit``).  For every
``path|speaker_id|cleaned_text`` line of a ``final_annotation_*.txt`` file
the port's ``TTSEngine.synthesize_ids`` renders the text in batches of
``--batch``; each waveform goes through PCM16 and back, as the ground truth
did when it was written, and is scored against it with the objective
metrics (MCD / LSD / F0 / MRSTFT, reference ``eval_pair.py:100-121``).
Prints a row per utterance, the mean/median aggregate, and one JSON line,
which also holds the seconds spent in synthesis (on the device, the fetch
included) and in the metrics (on the host).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np


def read_annotations(path):
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            wav_path, sid, text = line.split("|", 2)
            rows.append((wav_path, int(sid), text))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.eval_set",
        description="Evaluate a checkpoint over an annotation set")
    ap.add_argument("--model", required=True, help=".pth checkpoint")
    ap.add_argument("--config", required=True)
    ap.add_argument("--annotations", required=True,
                    help="final_annotation_*.txt (path|sid|cleaned_text)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--limit", type=int, default=0, help="0 = all")
    ap.add_argument("--noise_scale", type=float, default=0.667)
    ap.add_argument("--noise_scale_w", type=float, default=0.8)
    ap.add_argument("--out_dir", default="", help="dump synthesized wavs here")
    ap.add_argument("--out_json", default="", help="write aggregate JSON here")
    ap.add_argument("--no_dtw", action="store_true")
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

    rows = read_annotations(args.annotations)
    if args.limit:
        rows = rows[: args.limit]
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    per_utt = []
    synthesis_s = metrics_s = 0.0
    for start in range(0, len(rows), args.batch):
        chunk = rows[start : start + args.batch]
        id_seqs = [engine.text_to_ids(t, is_symbol=True) for _, _, t in chunk]
        sids = [s for _, s, _ in chunk]
        t0 = time.perf_counter()
        wavs = engine.synthesize_ids(
            id_seqs, sids,
            noise_scale=args.noise_scale, noise_scale_w=args.noise_scale_w,
        )
        synthesis_s += time.perf_counter() - t0
        for (wav_path, sid, _), syn in zip(chunk, wavs):
            # score the int16-roundtripped waveform: the ground truth is a
            # PCM16 file and the reference's eval_pair CLI reads files, so
            # metrics must see both sides in the same representation (pYIN
            # octave decisions on strongly-harmonic audio can flip between
            # near-tie tracks under sub-quantization perturbations)
            pcm = (np.clip(syn, -1, 1) * 32767.0).astype(np.int16)
            syn = pcm.astype(np.float32) / 32768.0
            if args.out_dir:
                from scipy.io import wavfile

                wavfile.write(
                    os.path.join(args.out_dir, os.path.basename(wav_path)),
                    sr, pcm,
                )
            ref = load_wav_mono(wav_path, sr)
            t0 = time.perf_counter()
            m = evaluate_pair(ref, syn, sr, use_dtw=not args.no_dtw)
            metrics_s += time.perf_counter() - t0
            m = {k: float(v) for k, v in m.items()}
            per_utt.append({"path": wav_path, "sid": sid, **m})
            print(
                f"{os.path.basename(wav_path)} sid={sid} "
                + " ".join(f"{k}={v:.3f}" for k, v in m.items())
            )

    keys = [k for k in per_utt[0] if k not in ("path", "sid")]
    agg = {}
    for k in keys:
        vals = np.asarray([u[k] for u in per_utt], dtype=np.float64)
        vals = vals[np.isfinite(vals)]
        agg[f"{k}_mean"] = float(vals.mean()) if len(vals) else float("nan")
        agg[f"{k}_median"] = float(np.median(vals)) if len(vals) else float("nan")

    print("=== Aggregate over", len(per_utt), "utterances ===")
    for k in keys:
        print(f"{k}: mean={agg[f'{k}_mean']:.4f} median={agg[f'{k}_median']:.4f}")
    result = {"n_utterances": len(per_utt), **agg,
              "seconds": {"synthesis": synthesis_s, "metrics": metrics_s},
              "device": str(engine.device)}
    print(json.dumps(result))
    if args.out_json:
        with open(args.out_json, "w", encoding="utf-8") as f:
            json.dump({"aggregate": result, "per_utterance": per_utt}, f, indent=1)
    return result


if __name__ == "__main__":
    main()
