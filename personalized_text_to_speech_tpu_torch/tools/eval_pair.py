"""Objective evaluation of a (reference, synthesized) wav pair (reference
``eval_pair.py`` CLI: MCD / LSD / F0 / MRSTFT, librosa-free):

    python -m personalized_text_to_speech_tpu_torch.tools.eval_pair \
        --ref_wav ref.wav --syn_wav syn.wav

The port's copy of ``tools/eval_pair.py``: its flags, plus ``--device``
(default ``cuda``), which stands where the JAX tool checks that its TPU is
reachable: without a card the default raises ``SystemExit``.  The metrics
themselves are numpy/scipy on the host (:mod:`..eval.metrics`).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.eval_pair",
        description="Evaluate a single ref/syn wav pair")
    ap.add_argument("--ref_wav", required=True)
    ap.add_argument("--syn_wav", required=True)
    ap.add_argument("--sr", type=int, default=22050)
    ap.add_argument("--no_dtw", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from personalized_text_to_speech_tpu_torch.data.audio import load_wav_mono
    from personalized_text_to_speech_tpu_torch.eval import evaluate_pair
    from personalized_text_to_speech_tpu_torch.utils.runtime import require_card

    require_card(args.device)
    ref = load_wav_mono(args.ref_wav, args.sr)
    syn = load_wav_mono(args.syn_wav, args.sr)
    metrics = evaluate_pair(ref, syn, args.sr, use_dtw=not args.no_dtw)

    print("=== Metrics ===")
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
