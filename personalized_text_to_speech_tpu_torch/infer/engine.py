"""The TTS serving engine: text → waveform with bucketed shapes.

Counterpart of ``personalized_text_to_speech_tpu/infer/engine.py``
(reference ``VC_inference.py:31-53``, ``cmd_inference.py:47-117``):

* text IDs are padded to the smallest **text bucket**,
* the encoder + duration stage runs, and ONE scalar sync (the largest
  predicted frame count) picks the smallest **frame bucket**,
* the flow + HiFi-GAN decode stage runs over that canvas, masked to each
  utterance's true length.

Around that two-stage core: long-form input split into sentences (one
bucketed batch, or a sentence-by-sentence stream), streaming within a
sentence (fixed frame chunks decoded with a halo), a one-call path that
guesses the frame canvas instead of waiting for the predicted length, and
voice conversion of a waveform between two known speakers.

Buckets come from the config's ``tpu`` section, as in the JAX package.  The
engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card, the default raises.  Noise comes from an
explicit ``torch.Generator`` seeded per call, drawn in a fixed order (the
duration noise, then the prior's over the whole frame canvas), so every
path that renders the same text with the same seed takes the same draws.
``dtype="bfloat16"`` runs the model under ``torch.autocast`` (the train
step's policy); weights, draws, spectrograms and durations stay float32.

Default sampling knobs match the reference UI (noise 0.667, noise_w 0.8,
speed → ``length_scale = 1/speed``, ``VC_inference.py:48-49``).
"""

from __future__ import annotations

import logging
import re
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from personalized_text_to_speech_tpu_torch import text as text_frontend
from personalized_text_to_speech_tpu_torch.config import HParams
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.ops.spectrogram import (
    MelConfig,
    linear_spectrogram,
)
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

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?。！？；;…])\s*")

DTYPES = ("float32", "bfloat16")

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


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Float waveform → 16-bit PCM on its device: clip to [-1, 1], scale by
    32767, truncate toward zero (as XLA's convert in the JAX engine)."""
    return (wav.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


class TTSEngine:
    """Config + weights → a synthesizer on one device."""

    def __init__(
        self,
        hps: HParams,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        checkpoint_path: Optional[str] = None,
        device: str = "cuda",
        dtype: str = "float32",
        seed: int = 1234,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TTSEngine: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, not {dtype!r}")
        self.dtype = dtype
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
        self.mel_cfg = MelConfig.from_hparams(hps)
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

    def _generator(self, rng: Optional[int]) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._next_seed() if rng is None else rng))
        return gen

    def _autocast(self):
        """The model's precision region: bf16 autocast, or nothing."""
        return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16,
                              enabled=self.dtype == "bfloat16")

    def _sid(self, speakers: Sequence[int]) -> torch.Tensor:
        return torch.tensor([int(s) for s in speakers], dtype=torch.long,
                            device=self.device)

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
    # the two-stage core
    # ------------------------------------------------------------------
    def _padded(self, id_seqs) -> Tuple[torch.Tensor, torch.Tensor]:
        """ID sequences (each within the largest text bucket) → ``(x [B,
        t_bucket], x_lengths [B])`` on the device."""
        lengths = [len(s) for s in id_seqs]
        x = np.zeros((len(id_seqs), _next_bucket(max(lengths), self.text_buckets)),
                     dtype=np.int64)
        for i, s in enumerate(id_seqs):
            x[i, : len(s)] = s
        return (torch.from_numpy(x).to(self.device),
                torch.tensor(lengths, dtype=torch.int32, device=self.device))

    def _encode_padded(self, x, x_lengths, sid, length_scale, noise_scale_w,
                       gen):
        """``infer_encode`` under the engine's autocast on a padded batch:
        the encoder + duration stage's device work, with no wait."""
        with self._autocast():
            return self.model.infer_encode(
                x, x_lengths, sid, length_scale=length_scale,
                noise_scale_w=noise_scale_w, generator=gen,
            )

    def _encode(self, id_seqs, sid, length_scale, noise_scale_w, gen):
        """The encoder + duration stage on ``id_seqs`` padded to their text
        bucket → ``(stats, f_bucket, n_frames)``, ``stats`` being
        ``infer_encode``'s outputs; the one wait is the scalar ``n_frames``
        that picks the frame bucket."""
        stats = self._encode_padded(*self._padded(id_seqs), sid, length_scale,
                                    noise_scale_w, gen)
        n_frames = int(stats[0].sum(dim=-1).max())  # the one scalar sync
        return stats, _next_bucket(max(n_frames, 1), self.frame_buckets), n_frames

    def _decode(self, stats, sid, noise_scale, f_bucket, gen, pcm16):
        """``infer_decode`` under the engine's autocast on the encode's
        ``stats`` → device tensors ``(wav, y_lengths)``, the wav quantized
        on the device (:func:`to_pcm16`) with ``pcm16``."""
        with self._autocast():
            wav, y_lengths = self.model.infer_decode(
                *stats, sid, noise_scale=noise_scale, max_len=f_bucket,
                generator=gen,
            )
        return (to_pcm16(wav) if pcm16 else wav), y_lengths

    @torch.inference_mode()
    def submit_ids(
        self,
        id_seqs: Sequence[Sequence[int]],
        speaker_ids: Sequence[int],
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        rng: Optional[int] = None,
        pcm16: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run a batch and return device tensors ``(wav, y_lengths)``; the
        only wait is the one scalar that picks the frame bucket.  With
        ``pcm16`` the wav is quantized on the device (:func:`to_pcm16`), so
        half the bytes cross to the host.  Sequences past the largest text
        bucket are truncated with a warning (:meth:`synthesize_ids` chunks
        them instead)."""
        gen = self._generator(rng)
        cap = self.text_buckets[-1]
        for i, s in enumerate(id_seqs):
            if len(s) > cap:
                logger.warning(
                    "submit_ids: sequence %d has %d ids > largest text bucket "
                    "%d; truncating. Use synthesize_ids for chunking.",
                    i, len(s), cap,
                )
        sid = self._sid(speaker_ids)
        stats, f_bucket, _ = self._encode(
            [list(s)[:cap] for s in id_seqs], sid, length_scale, noise_scale_w,
            gen,
        )
        return self._decode(stats, sid, noise_scale, f_bucket, gen, pcm16)

    # ------------------------------------------------------------------
    # the two stages alone, and their cost
    # ------------------------------------------------------------------
    def stage_calls(
        self, batch: int, t_bucket: Optional[int] = None,
        f_bucket: Optional[int] = None, pcm16: bool = True,
    ) -> Tuple[Callable, Callable, int, int]:
        """The two serving stages as calls of their own on a dummy batch (ids
        ``1`` in the first 8 positions, lengths equal to ``t_bucket``,
        speaker 0, noise seed 0): ``(encode, decode, t_bucket, f_bucket)``.
        ``encode()`` is :meth:`_encode_padded` on the batch padded once
        beforehand, so it waits for nothing (the frame count that picks
        ``f_bucket`` is read once, here); ``decode()`` is :meth:`_decode` on
        the encode's output.  Both run the engine's serving code under its
        autocast.  ``t_bucket`` defaults to the second-largest text bucket
        and ``f_bucket`` to the frame bucket the encode picks."""
        t_bucket = t_bucket or self.text_buckets[-2]
        ids = [[1] * 8 + [0] * (t_bucket - 8)] * batch
        sid = self._sid([0] * batch)
        x, x_lengths = self._padded(ids)

        @torch.inference_mode()
        def encode():
            return self._encode_padded(x, x_lengths, sid, 1.0, 0.8,
                                       self._generator(0))

        with torch.inference_mode():
            stats, enc_bucket, _ = self._encode(ids, sid, 1.0, 0.8,
                                                self._generator(0))
        f_bucket = f_bucket or enc_bucket

        @torch.inference_mode()
        def decode():
            return self._decode(stats, sid, 0.667, f_bucket, self._generator(0),
                                pcm16)

        return encode, decode, t_bucket, f_bucket

    def cost_analysis(
        self, batch: int, t_bucket: Optional[int] = None,
        f_bucket: Optional[int] = None, pcm16: bool = True,
    ) -> Dict[str, Dict[str, float]]:
        """FLOPs and bytes of the two serving stages at the given batch and
        buckets (:meth:`stage_calls`, counted by
        :func:`~personalized_text_to_speech_tpu_torch.utils.profiling.cost_stats`,
        so matmuls and convolutions only): the roofline inputs of
        ``tools/bench_cost.py``.  Same signature, dummy batch and return
        shape as the JAX engine's ``cost_analysis``."""
        from personalized_text_to_speech_tpu_torch.utils.profiling import (
            cost_stats,
        )

        encode, decode, t_bucket, f_bucket = self.stage_calls(
            batch, t_bucket, f_bucket, pcm16)
        return {
            "encode": cost_stats(encode),
            "decode": cost_stats(decode),
            "buckets": {"text": float(t_bucket), "frames": float(f_bucket)},
        }

    @staticmethod
    def collect(handle, hop_length: int, dtype=np.float32) -> List[np.ndarray]:
        """Fetch a ``submit_ids`` result → list of true-length wavs.  PCM16
        comes back as float32 (÷ 32767) unless ``dtype`` is ``np.int16``."""
        wav_dev, y_len_dev = handle
        if wav_dev.dtype != torch.int16:
            wav_dev = wav_dev.float()
        wav = wav_dev.cpu().numpy()
        if wav.dtype == np.int16 and dtype == np.float32:
            wav = wav.astype(np.float32) / 32767.0
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
        pcm16: bool = False,
    ) -> List[np.ndarray]:
        """Batched synthesis of pre-tokenized sequences → list of wavs
        (int16 with ``pcm16``).  Sequences past the largest text bucket are
        chunked, synthesized piecewise in the same batch, and concatenated."""
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
            pcm16=pcm16,
        )
        flat = self.collect(handle, self.hop_length,
                            dtype=np.int16 if pcm16 else np.float32)
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

    # ------------------------------------------------------------------
    # long-form: sentence split, then one batch or a sentence stream
    # ------------------------------------------------------------------
    def split_sentences(self, text: str) -> List[str]:
        parts = [p.strip() for p in _SENTENCE_SPLIT.split(text)]
        return [p for p in parts if p]

    def stream_long_form(
        self,
        text: str,
        speaker=0,
        language: Optional[str] = None,
        speed: float = 1.0,
        chunk_frames: Optional[int] = None,
        **kwargs,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(sr, wav)`` per sentence, sentence i+1 submitted before
        sentence i is fetched, so playback starts after the first sentence.
        With ``chunk_frames``, each sentence streams within itself through
        :meth:`stream_tts`."""
        sentences = self.split_sentences(text) or [text]
        if chunk_frames is not None:
            for sent in sentences:
                yield from self.stream_tts(
                    sent, speaker=speaker, language=language, speed=speed,
                    chunk_frames=chunk_frames, **kwargs,
                )
            return
        sid = self.speaker_id(speaker)
        pending = self.submit_ids(
            [self.text_to_ids(sentences[0], language)], [sid],
            length_scale=1.0 / speed, **kwargs,
        )
        for nxt in sentences[1:]:
            nxt_handle = self.submit_ids(
                [self.text_to_ids(nxt, language)], [sid],
                length_scale=1.0 / speed, **kwargs,
            )
            yield self.sampling_rate, self.collect(pending, self.hop_length)[0]
            pending = nxt_handle
        yield self.sampling_rate, self.collect(pending, self.hop_length)[0]

    def long_form(
        self,
        text: str,
        speaker=0,
        language: Optional[str] = None,
        speed: float = 1.0,
        pause_ms: float = 120.0,
        **kwargs,
    ) -> Tuple[int, np.ndarray]:
        """Sentence split → one bucketed batch → the sentences joined with
        ``pause_ms`` of silence between them."""
        sentences = self.split_sentences(text) or [text]
        sid = self.speaker_id(speaker)
        id_seqs = [self.text_to_ids(s, language) for s in sentences]
        wavs = self.synthesize_ids(
            id_seqs, [sid] * len(id_seqs), length_scale=1.0 / speed, **kwargs,
        )
        pause = np.zeros(int(self.sampling_rate * pause_ms / 1000.0), np.float32)
        pieces: List[np.ndarray] = []
        for i, w in enumerate(wavs):
            pieces.append(w)
            if i != len(wavs) - 1:
                pieces.append(pause)
        return self.sampling_rate, np.concatenate(pieces)

    # ------------------------------------------------------------------
    # streaming within a sentence: the latent canvas z_p is per-frame (only
    # the reverse flow and HiFi-GAN are convolutional), so audio comes out in
    # fixed frame chunks decoded with a halo on each side
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def stream_tts(
        self,
        text: str,
        speaker=0,
        language: Optional[str] = None,
        speed: float = 1.0,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        chunk_frames: int = 96,
        halo_frames: int = 64,
        rng: Optional[int] = None,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(sr, wav_piece)`` every ``chunk_frames`` frames within a
        sentence.  The pieces concatenate to :meth:`tts`'s render with the
        same ``rng``: the same draws in the same order (duration noise, then
        the prior over the whole frame canvas), and a halo that covers the
        reverse flow's and HiFi-GAN's reach across chunk edges.  Chunk i+1 is
        launched before chunk i is copied to the host; text past the largest
        bucket streams piece by piece."""
        gen = self._generator(rng)
        sid = self._sid([self.speaker_id(speaker)])
        halo, chunk = halo_frames, chunk_frames
        size = chunk + 2 * halo
        for ids in _chunk_ids(self.text_to_ids(text, language),
                              self.text_buckets[-1]):
            stats, f_bucket, n_frames = self._encode(
                [ids], sid, 1.0 / speed, noise_scale_w, gen)
            n_frames = min(n_frames, f_bucket)
            with self._autocast():
                z_p, y_mask, _ = self.model.infer_expand(
                    *stats, noise_scale=noise_scale, max_len=f_bucket,
                    generator=gen,
                )
            # halo zeros in front, halo + chunk behind: every slice
            # [start, start + chunk + 2·halo) lies inside
            z_p = F.pad(z_p, (0, 0, halo, halo + chunk))
            y_mask = F.pad(y_mask, (0, 0, halo, halo + chunk))
            pending, pending_take = None, 0
            for start in range(0, n_frames, chunk):
                with self._autocast():
                    wav = self.model.decode_frames(
                        z_p[:, start:start + size], y_mask[:, start:start + size],
                        sid,
                    )
                if pending is not None:
                    yield self.sampling_rate, self._middle(pending, halo,
                                                           pending_take)
                pending, pending_take = wav, min(chunk, n_frames - start)
            if pending is not None:
                yield self.sampling_rate, self._middle(pending, halo, pending_take)

    def _middle(self, wav: torch.Tensor, halo: int, take: int) -> np.ndarray:
        hop = self.hop_length
        return wav[0, halo * hop:(halo + take) * hop].float().cpu().numpy()

    # ------------------------------------------------------------------
    # one call, no mid-pipeline wait: the frame canvas comes from a
    # frames-per-token guess instead of the predicted length; a prediction
    # that fills the canvas falls back to the two-stage path
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def tts_low_latency(
        self,
        text: str,
        speaker=0,
        language: Optional[str] = None,
        speed: float = 1.0,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        frames_per_token: float = 2.5,
        rng: Optional[int] = None,
    ) -> Tuple[int, np.ndarray]:
        """One ``model.infer`` call on a canvas of ``len(ids) ·
        frames_per_token / speed`` frames rounded up to a frame bucket, then
        one wait for the wav and its length.  With blanks interspersed,
        speech runs ~2 frames per token, so 2.5 leaves ~25 % headroom; a
        saturated canvas, or text past the largest bucket, is rendered again
        by :meth:`tts` with the same ``rng``."""
        if rng is None:
            rng = self._next_seed()
        kw = dict(speaker=speaker, language=language, speed=speed,
                  noise_scale=noise_scale, noise_scale_w=noise_scale_w, rng=rng)
        ids = self.text_to_ids(text, language)
        if len(ids) > self.text_buckets[-1]:
            return self.tts(text, **kw)
        f_bucket = _next_bucket(max(int(len(ids) * frames_per_token / speed), 1),
                                self.frame_buckets)
        with self._autocast():
            wav, y_lengths, _, _ = self.model.infer(
                *self._padded([ids]),
                self._sid([self.speaker_id(speaker)]), noise_scale=noise_scale,
                length_scale=1.0 / speed, noise_scale_w=noise_scale_w,
                max_len=f_bucket, generator=self._generator(rng),
            )
        wav = wav[0].float().cpu().numpy()  # the one wait
        n = int(y_lengths[0])
        if n >= f_bucket:  # canvas saturated → exact re-render
            return self.tts(text, **kw)
        return self.sampling_rate, wav[: n * self.hop_length]

    # ------------------------------------------------------------------
    # voice conversion (reference models.py:525-533: defined there, never
    # wired into its UI)
    # ------------------------------------------------------------------
    def vc_spectrogram(self, wav: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Voice conversion's input: the wav cut to whole hops, zero-padded
        to its frame bucket, its linear spectrogram ``[1, f_bucket, n_freq]``
        taken on the device in float32; and the true frame count."""
        hop = self.hop_length
        spec_len = len(wav) // hop
        if spec_len > self.frame_buckets[-1]:
            raise ValueError(
                f"voice_conversion: {spec_len} frames > the largest frame "
                f"bucket {self.frame_buckets[-1]}"
            )
        f_bucket = _next_bucket(max(spec_len, 1), self.frame_buckets)
        padded = np.zeros((1, f_bucket * hop), dtype=np.float32)
        padded[0, : spec_len * hop] = wav[: spec_len * hop]
        return linear_spectrogram(torch.from_numpy(padded).to(self.device),
                                  self.mel_cfg), spec_len

    @torch.inference_mode()
    def voice_conversion(
        self, wav: np.ndarray, speaker_src, speaker_tgt,
        rng: Optional[int] = None,
    ) -> Tuple[int, np.ndarray]:
        """Convert a waveform at the model's rate from one known speaker's
        voice to another's (:meth:`vc_spectrogram`, then
        ``SynthesizerTrn.voice_conversion``).  The posterior's noise
        ``[1, C, f_bucket]`` is the call's one draw; the output is cut to the
        input's whole hops."""
        spec, spec_len = self.vc_spectrogram(wav)
        with self._autocast():
            o, _, _ = self.model.voice_conversion(
                spec, torch.tensor([spec_len], dtype=torch.int32,
                                   device=self.device),
                self._sid([self.speaker_id(speaker_src)]),
                self._sid([self.speaker_id(speaker_tgt)]),
                generator=self._generator(rng),
            )
        hop = self.hop_length
        return self.sampling_rate, o[0, : spec_len * hop].float().cpu().numpy()

    def warmup(self) -> float:
        """One short request through the two-stage path (sets up the
        device's plans for its shapes); returns seconds."""
        t0 = time.perf_counter()
        self.tts("Warm up.", speaker=0, language="English")
        return time.perf_counter() - t0
