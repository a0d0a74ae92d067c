"""Objective evaluation metrics for synthesized speech (the port's copy of
``personalized_text_to_speech_tpu/eval``)."""

from personalized_text_to_speech_tpu_torch.eval.metrics import (  # noqa: F401
    MCD,
    LSD,
    F0_metrics,
    MRSTFT,
    evaluate_pair,
)
