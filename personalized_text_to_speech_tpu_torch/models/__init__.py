"""Model modules of the port (counterparts of the JAX package's ``models``)."""

from personalized_text_to_speech_tpu_torch.models.synthesizer import (  # noqa: F401
    Generator,
    PosteriorEncoder,
    SynthesizerTrn,
    TextEncoder,
)
