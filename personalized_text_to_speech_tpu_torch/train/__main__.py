"""Fine-tuning CLI of the port, with the flags of ``tools/train.py``
(reference ``finetune_speaker_v2.py``, ``utils.py:307-320``):

    python -m personalized_text_to_speech_tpu_torch.train \\
        -c configs/modified_finetune_speaker.json -m OUT_MODEL -n 100 \\
        --train_with_pretrained_model \\
        --pretrained_g pretrained_models/G_0.pth \\
        --pretrained_d pretrained_models/D_0.pth

``-c`` config, ``-m`` model directory, ``-n`` max epochs, ``--cont`` resume
from the newest checkpoint, ``--preserved`` how many checkpoints to keep.
``--smoke`` trains a small model for a few steps on a synthetic dataset
written into the model directory (the same set as ``tools/train.py --smoke``).
Runs on the card; ``--device cpu`` asks for the CPU.  The config's
``model.use_spectral_norm``, ``train.accum_steps`` and ``train.remat`` act
as in the JAX package's run (:class:`~.loop.Trainer`).

Data and tensor parallelism, one process per device: under ``torchrun``
(which sets ``WORLD_SIZE``), or with ``--distributed``, each process joins
the group through ``env://``; ``--coordinator host:port --num_processes N
--process_id R`` joins it at that address instead.  The config's
``tpu.mesh`` lays the processes out as data × model (``{"data": -1}``: data
parallelism alone; ``{"data": -1, "model": 2}``: G and D sharded over pairs
of ranks), so the world size, ``N`` and ``--num_processes``, is the product
of the two axes.  ``tpu.sp`` (sequence parallelism) is not ported yet
(ROADMAP.md, Queue 1, item 9).  The backend is NCCL on the card and gloo
on the CPU.  On a machine with N cards:

    torchrun --nproc_per_node N -m personalized_text_to_speech_tpu_torch.train \\
        -c configs/modified_finetune_speaker.json -m OUT_MODEL

and on the CPU ``python -m torch.distributed.run --nproc_per_node 2 -m
personalized_text_to_speech_tpu_torch.train ... --device cpu``.
``--no-mesh`` ignores ``tpu.mesh`` and trains on one process.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "y", "1")


def make_smoke_dataset(directory: str, hps) -> None:
    """Write 8 synthetic clips and their filelist (rank 0 of a
    data-parallel run; the others wait); point ``hps`` at it."""
    from personalized_text_to_speech_tpu_torch import parallel
    from personalized_text_to_speech_tpu_torch.data.audio import save_wav

    filelist = os.path.join(directory, "smoke_filelist.txt")
    hps.data.training_files = filelist
    hps.data.validation_files = filelist
    if not parallel.is_primary():
        parallel.barrier()
        return
    os.makedirs(directory, exist_ok=True)
    sr = hps.data.sampling_rate
    rng = np.random.default_rng(0)
    texts = ["ni→xɑʊ↓↑.", "heloʊ wəɹɫd.", "tɛst sɛntəns hiɹ.", "moɹ deɪtə pliz."]
    lines = []
    for i in range(8):
        dur = rng.uniform(0.8, 1.6)
        t = np.linspace(0, dur, int(sr * dur))
        f0 = rng.uniform(120, 260)
        wav = (0.4 * np.sin(2 * np.pi * f0 * t)
               * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        path = os.path.join(directory, f"smoke_{i}.wav")
        save_wav(path, wav, sr)
        lines.append(f"{path}|{i % 2}|{texts[i % len(texts)]}")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    parallel.barrier()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m personalized_text_to_speech_tpu_torch.train")
    parser.add_argument("-c", "--config", type=str,
                        default="./configs/modified_finetune_speaker.json")
    parser.add_argument("-m", "--model", type=str, default="pretrained_models")
    parser.add_argument("-n", "--max_epochs", type=int, default=50)
    parser.add_argument("--cont", type=str2bool, default=False,
                        help="continue from the newest checkpoint")
    parser.add_argument("--drop_speaker_embed", type=str2bool, default=False)
    parser.add_argument("--train_with_pretrained_model", type=str2bool,
                        default=False)
    parser.add_argument("--pretrained_g", type=str,
                        default="./pretrained_models/G_0.pth")
    parser.add_argument("--pretrained_d", type=str,
                        default="./pretrained_models/D_0.pth")
    parser.add_argument("--preserved", type=int, default=4)
    parser.add_argument("--smoke", action="store_true",
                        help="short synthetic-data end-to-end run")
    parser.add_argument("--smoke-epochs", type=int, default=1,
                        help="epochs for --smoke")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--no-mesh", action="store_true",
                        help="ignore tpu.mesh and train on one process")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rendezvous address host:port of a "
                        "data-parallel run")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="the world size: tpu.mesh's data x model")
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group through env:// "
                        "(implied under torchrun)")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from personalized_text_to_speech_tpu_torch.utils import runtime

    distributed = (args.distributed or args.coordinator is not None
                   or "WORLD_SIZE" in os.environ)
    if distributed:
        runtime.init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes, process_id=args.process_id,
            backend="gloo" if args.device == "cpu" else "nccl")
    try:
        return _train(args)
    finally:
        # also on a failure: this rank's peers then fail in their next
        # collective instead of waiting for the timeout
        if distributed:
            dist.destroy_process_group()


def _train(args) -> int:
    from personalized_text_to_speech_tpu_torch.config import (
        default_model_config,
        load_hparams,
    )
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer

    if args.smoke:
        hps = default_model_config(n_speakers=2)
        hps.train.batch_size = 2
        hps.train.log_interval = 1
        hps.train.eval_interval = 4
        hps.model.upsample_initial_channel = 128
        hps.model.n_layers = 2
        make_smoke_dataset(os.path.join(args.model, "smoke_data"), hps)
        args.max_epochs = args.smoke_epochs
    else:
        hps = load_hparams(args.config)
    hps["preserved"] = args.preserved

    use_pretrained = (args.train_with_pretrained_model
                      and os.path.exists(args.pretrained_g))
    trainer = Trainer(
        hps,
        args.model,
        pretrained_g=args.pretrained_g if use_pretrained else None,
        pretrained_d=(args.pretrained_d if use_pretrained
                      and os.path.exists(args.pretrained_d) else None),
        drop_speaker_embed=args.drop_speaker_embed,
        device=args.device,
        use_mesh=not args.no_mesh,
    )
    if args.cont:
        trainer.resume()
    trainer.fit(args.max_epochs)
    print(f"rank {trainer.rank} of {trainer.world}: training done at step "
          f"{trainer.global_step}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
