"""Entry points of the port, each run as ``python -m
personalized_text_to_speech_tpu_torch.tools.<name>``: ``tts`` (batch
synthesis) and ``serve`` (the HTTP API); the measurement tools ``bench``
(1/RTF), ``bench_cost`` (the serving stages' roofline), ``bench_serve``
(throughput under concurrent clients), ``bench_stream`` (time to the first
streamed audio), ``bench_train`` (the train step and its ``mfu``) and
``profile_ops`` (device time per op and per kernel)."""
