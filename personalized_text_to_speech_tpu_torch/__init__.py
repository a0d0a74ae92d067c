"""personalized_text_to_speech_tpu_torch — the PyTorch/CUDA port of the
trilingual multi-speaker VITS system in ``personalized_text_to_speech_tpu``.

The JAX package is the reference and stays as it is; this package does the
same work in PyTorch on an NVIDIA H100, module for module, under the same
names (``config``, ``text``, ``data``, ``ops``, ``models``, ``infer``,
``train``, ``utils``, ``tools``).  It
imports ``torch`` and nothing of JAX or of the JAX package: what it needs
from there (the config loader, the text frontend, the audio IO and the
dataset) it keeps as its own copy.

Every Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper.  The one on the ported path is Monotonic Alignment Search
(``ops/mas.py`` + ``csrc/mas.cu``).  Convolutions, matmuls and elementwise
work are plain PyTorch, as the JAX package left them to XLA.

Layout: modules run ``[B, C, T]`` inside; the public model methods take and
return the JAX package's ``[B, T, C]`` shapes so the two compare like with
like.
"""

__version__ = "0.1.0"

from personalized_text_to_speech_tpu_torch.config import HParams, load_hparams  # noqa: F401
