"""Entry points of the port: ``python -m personalized_text_to_speech_tpu_torch.tools.tts``
(batch synthesis) and ``... .tools.serve`` (the HTTP API)."""
