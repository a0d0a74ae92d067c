"""The TTS serving engine: text → waveform with bucketed shapes.

Counterpart of ``personalized_text_to_speech_tpu/infer/engine.py``
(reference ``VC_inference.py:31-53``, ``cmd_inference.py:47-117``):

* text IDs are padded to the smallest **text bucket**,
* the encoder + duration stage runs, and ONE scalar sync (the largest
  predicted frame count) picks the smallest **frame bucket**,
* the flow + HiFi-GAN decode stage runs over that canvas, masked to each
  utterance's true length.

Buckets come from the config's ``tpu`` section, as in the JAX package.  The
engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card, the default raises.  Noise comes from an
explicit ``torch.Generator`` seeded per call.

Default sampling knobs match the reference UI (noise 0.667, noise_w 0.8,
speed → ``length_scale = 1/speed``, ``VC_inference.py:48-49``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from personalized_text_to_speech_tpu_torch import text as text_frontend
from personalized_text_to_speech_tpu_torch.config import HParams
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.text.cleaners import auto_tag
from personalized_text_to_speech_tpu_torch.utils.torch_compat import load_torch_checkpoint

LANGUAGE_MARKS = {
    "Japanese": "[JA]",
    "日本語": "[JA]",
    "Chinese": "[ZH]",
    "简体中文": "[ZH]",
    "English": "[EN]",
    "Korean": "[KO]",
    "Mix": "",
    None: None,
}

logger = logging.getLogger(__name__)


def _chunk_ids(seq: Sequence[int], cap: int) -> List[List[int]]:
    """Split an over-long ID sequence into ≤``cap`` pieces, each synthesized
    as its own utterance, so no text is dropped."""
    seq = list(seq)
    if len(seq) <= cap:
        return [seq]
    return [seq[i : i + cap] for i in range(0, len(seq), cap)]


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TTSEngine:
    """Config + weights → a synthesizer on one device."""

    def __init__(
        self,
        hps: HParams,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        checkpoint_path: Optional[str] = None,
        device: str = "cuda",
        seed: int = 1234,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TTSEngine: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        self.hps = hps
        self.sampling_rate = hps.data.sampling_rate
        self.hop_length = hps.data.hop_length
        self.add_blank = hps.data.add_blank
        self.symbols = list(hps.symbols)
        self.cleaners = list(hps.data.text_cleaners)
        self.speakers: Dict[str, int] = dict(
            hps.speakers.items() if hasattr(hps.speakers, "items") else {}
        )
        self.text_buckets = list(hps.tpu.text_buckets)
        self.frame_buckets = list(hps.tpu.frame_buckets)
        self._seed = seed
        self._call_counter = 0

        # random init from `seed` without touching the global RNG stream
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = SynthesizerTrn.from_hparams(hps)
        if checkpoint_path is not None:
            state_dict, _ = load_torch_checkpoint(checkpoint_path)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    def _next_seed(self) -> int:
        self._call_counter += 1
        return (self._seed * 1000003 + self._call_counter) % (2 ** 31)

    # ------------------------------------------------------------------
    # text handling
    # ------------------------------------------------------------------
    def text_to_ids(
        self,
        text: str,
        language: Optional[str] = None,
        is_symbol: bool = False,
    ) -> List[int]:
        """Tag + clean + map text to IDs.  ``is_symbol=True`` treats the
        input as already-cleaned IPA (reference ``VC_inference.py:31-36``)."""
        if is_symbol:
            seq = text_frontend.cleaned_text_to_sequence(text, self.symbols)
        else:
            mark = LANGUAGE_MARKS.get(language) if language else None
            if mark:
                text = mark + text + mark
            elif mark is None and "[" not in text:
                text = auto_tag(text)  # no/unknown language → per-script tags
            seq = text_frontend.text_to_sequence(text, self.symbols, self.cleaners)
        if self.add_blank:
            seq = text_frontend.intersperse(seq, 0)
        return seq

    def speaker_id(self, speaker) -> int:
        if isinstance(speaker, str):
            if speaker in self.speakers:
                return self.speakers[speaker]
            if speaker.lstrip("-").isdigit():
                return int(speaker)
            raise KeyError(
                f"unknown speaker {speaker!r}; have {list(self.speakers)[:8]}"
            )
        return int(speaker)

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def submit_ids(
        self,
        id_seqs: Sequence[Sequence[int]],
        speaker_ids: Sequence[int],
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        rng: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run a batch and return device tensors ``(wav, y_lengths)``; the
        only wait is the one scalar that picks the frame bucket.
        Sequences past the largest text bucket are truncated with a warning
        (:meth:`synthesize_ids` chunks them instead)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._next_seed() if rng is None else rng))
        cap = self.text_buckets[-1]
        for i, s in enumerate(id_seqs):
            if len(s) > cap:
                logger.warning(
                    "submit_ids: sequence %d has %d ids > largest text bucket "
                    "%d; truncating. Use synthesize_ids for chunking.",
                    i, len(s), cap,
                )
        id_seqs = [list(s)[:cap] for s in id_seqs]
        lengths = [len(s) for s in id_seqs]
        t_bucket = _next_bucket(max(lengths), self.text_buckets)
        x = np.zeros((len(id_seqs), t_bucket), dtype=np.int64)
        for i, s in enumerate(id_seqs):
            x[i, : len(s)] = s
        x = torch.from_numpy(x).to(self.device)
        x_lengths = torch.tensor(lengths, dtype=torch.int32, device=self.device)
        sid = torch.tensor([int(s) for s in speaker_ids], dtype=torch.long,
                           device=self.device)

        w_ceil, m_p, logs_p, x_mask = self.model.infer_encode(
            x, x_lengths, sid, length_scale=length_scale,
            noise_scale_w=noise_scale_w, generator=gen,
        )
        n_frames = int(w_ceil.sum(dim=-1).max())  # one scalar sync picks the bucket
        f_bucket = _next_bucket(max(n_frames, 1), self.frame_buckets)
        return self.model.infer_decode(
            w_ceil, m_p, logs_p, x_mask, sid, noise_scale=noise_scale,
            max_len=f_bucket, generator=gen,
        )

    @staticmethod
    def collect(handle, hop_length: int) -> List[np.ndarray]:
        """Fetch a ``submit_ids`` result → list of true-length wavs."""
        wav_dev, y_len_dev = handle
        wav = wav_dev.float().cpu().numpy()
        y_lengths = y_len_dev.cpu().numpy()
        return [wav[i, : int(y_lengths[i]) * hop_length] for i in range(wav.shape[0])]

    def synthesize_ids(
        self,
        id_seqs: Sequence[Sequence[int]],
        speaker_ids: Sequence[int],
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        rng: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Batched synthesis of pre-tokenized sequences → list of wavs.
        Sequences past the largest text bucket are chunked, synthesized
        piecewise in the same batch, and concatenated."""
        cap = self.text_buckets[-1]
        chunked: List[List[int]] = []
        owner: List[int] = []  # flat index → original sequence index
        for i, s in enumerate(id_seqs):
            pieces = _chunk_ids(s, cap)
            if len(pieces) > 1:
                logger.warning(
                    "synthesize_ids: sequence %d (%d ids) exceeds the largest "
                    "text bucket (%d); splitting into %d chunks.",
                    i, len(s), cap, len(pieces),
                )
            for p in pieces:
                chunked.append(p)
                owner.append(i)
        handle = self.submit_ids(
            chunked, [speaker_ids[i] for i in owner], noise_scale=noise_scale,
            noise_scale_w=noise_scale_w, length_scale=length_scale, rng=rng,
        )
        flat = self.collect(handle, self.hop_length)
        if len(flat) == len(id_seqs):
            return flat
        joined: List[List[np.ndarray]] = [[] for _ in id_seqs]
        for w, i in zip(flat, owner):
            joined[i].append(w)
        return [np.concatenate(ws) for ws in joined]

    def tts(
        self,
        text: str,
        speaker=0,
        language: Optional[str] = None,
        speed: float = 1.0,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        rng: Optional[int] = None,
    ) -> Tuple[int, np.ndarray]:
        """Single-utterance API (reference ``VC_inference.py:39-51``)."""
        ids = self.text_to_ids(text, language)
        wavs = self.synthesize_ids(
            [ids], [self.speaker_id(speaker)], noise_scale=noise_scale,
            noise_scale_w=noise_scale_w, length_scale=1.0 / speed, rng=rng,
        )
        return self.sampling_rate, wavs[0]
