"""Compact the speaker-embedding table after fine-tuning (reference
``scripts/rearrange_speaker.py``): shrink ``emb_g`` to the speakers in the
config and renumber them 0..n-1.

    python -m personalized_text_to_speech_tpu_torch.tools.rearrange_speaker \
        --model_dir OUT/G_latest.pth --config_dir OUT/config.json \
        --out_model G_compact.pth --out_config finetune_speaker_compact.json

The port's copy of ``tools/rearrange_speaker.py``, with its flags, on
reference-layout ``.pth`` files through the port's ``utils/torch_compat.py``.
The JAX tool also takes Orbax checkpoints; the port has no Orbax format, so
that branch has no counterpart here.  Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m personalized_text_to_speech_tpu_torch.tools.rearrange_speaker")
    parser.add_argument("--model_dir", type=str, default="./G_latest.pth")
    parser.add_argument("--config_dir", type=str, default="./finetune_speaker.json")
    parser.add_argument("--out_model", type=str, default="./G_compact.pth")
    parser.add_argument("--out_config", type=str, default="./finetune_speaker_compact.json")
    parser.add_argument("--out_moegoe", type=str, default="./moegoe_config.json",
                        help="MoeGoe-format config copy (speakers as an "
                             "id-ordered name list, reference "
                             "rearrange_speaker.py:31-34); '' disables")
    args = parser.parse_args(argv)

    import torch

    from personalized_text_to_speech_tpu_torch.config import load_hparams, save_hparams
    from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc

    hps = load_hparams(args.config_dir)
    speakers = dict(hps.speakers.items())

    state, meta = tc.load_torch_checkpoint(args.model_dir)
    emb = state["emb_g.weight"]
    new_emb = torch.zeros((len(speakers), emb.shape[1]), dtype=emb.dtype)
    new_map = {}
    for new_id, (name, old_id) in enumerate(sorted(speakers.items(), key=lambda kv: kv[1])):
        new_emb[new_id] = emb[int(old_id)]
        new_map[name] = new_id
    state["emb_g.weight"] = new_emb
    tc.save_torch_checkpoint(state, args.out_model,
                             iteration=meta.get("iteration", 0),
                             learning_rate=meta.get("learning_rate", 2e-4))

    hps["speakers"] = new_map
    hps.data.n_speakers = len(new_map)
    save_hparams(hps, args.out_config)
    if args.out_moegoe:
        # MoeGoe ecosystem expects `speakers` as an id-ordered name list
        with open(args.out_config, encoding="utf-8") as f:
            cfg = json.load(f)
        cfg["speakers"] = [
            name for name, _ in sorted(new_map.items(), key=lambda kv: kv[1])
        ]
        with open(args.out_moegoe, "w", encoding="utf-8") as f:
            json.dump(cfg, f, indent=2, ensure_ascii=False)
    print(f"compacted {emb.shape[0]} → {len(new_map)} speakers: "
          f"{args.out_model}, {args.out_config}"
          + (f", {args.out_moegoe}" if args.out_moegoe else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
