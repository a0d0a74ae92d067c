"""Serving engine of the port."""

from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine  # noqa: F401
