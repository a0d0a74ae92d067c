"""``Trainer.evaluate()`` of the port, at the tiny geometry of
``tiny_model_config()`` on the CPU.

Against the JAX package: the Trainer's generator carries the weights of
``tests/test_torch_vc.py::carried_weights``; the JAX side runs what the JAX
``Trainer.evaluate`` runs (``personalized_text_to_speech_tpu/train/loop.py:
399-466``): ``infer_encode`` with ``PRNGKey(0)``'s duration noise,
``infer_decode`` on the frame bucket with ``PRNGKey(1)``'s prior noise, and
``spec_to_mel(linear_spectrogram(…))`` of the wav and of the ground truth
padded to its frame bucket.  Both draws are injected into the port's
``evaluate``, and the port's decode gets JAX's ceiled durations (a ceil next
to an integer must not change the frame count; the port's own are checked
within one frame).  The wav is held within 1e-3 abs, the mels within 1e-3
of their largest value, the alignment image exactly.

Without JAX: ``fit`` calls ``evaluate`` at step 0 and every
``eval_interval``; a fit that evaluates at every step ends with weights and
draws bit for bit those of one whose ``evaluate`` is stubbed out; a train
step right after ``evaluate`` works; and with neither tensorboardX nor
matplotlib importable the writer saves the audio as ``.wav`` and the images
as ``.npy``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.config import tiny_model_config as jax_tiny
from personalized_text_to_speech_tpu.models.synthesizer import (
    SynthesizerTrn as JaxSynth,
)
from personalized_text_to_speech_tpu.ops.spectrogram import (
    MelConfig as JaxMelConfig,
    linear_spectrogram as jax_linear_spectrogram,
    spec_to_mel as jax_spec_to_mel,
)
from personalized_text_to_speech_tpu.utils import logging_utils as jax_logging
from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.train.loop import Trainer
from personalized_text_to_speech_tpu_torch.utils import logging_utils
from tests.test_torch_vc import carried_weights

torch.set_num_threads(2)

WAV_TOL = 1e-3
MEL_REL_TOL = 1e-3
SR = 8000


def write_corpus(directory, n: int = 4):
    """``n`` sine clips of 0.5–0.9 s at 8 kHz; ``train.txt`` holds all of
    them and ``val.txt`` the last one, with another text."""
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        k = int(SR * rng.uniform(0.5, 0.9))
        t = np.arange(k) / SR
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 250) * t)
        wav = wav + 0.01 * rng.normal(size=k)
        save_wav(str(directory / f"w{i}.wav"), wav, SR)
        lines.append(f"{directory / f'w{i}.wav'}|{i % 2}|ab ko→ no↓ da to mi.")
    (directory / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    (directory / "val.txt").write_text(
        lines[-1].rsplit("|", 1)[0] + "|ʃi ka↑ ɹu no.", encoding="utf-8")


def tiny_hps(directory, eval_interval: int = 10, epochs: int = 1):
    hps = tiny_model_config(n_speakers=4)
    hps.data.training_files = str(directory / "train.txt")
    hps.data.validation_files = str(directory / "val.txt")
    hps.train.eval_interval = eval_interval
    hps.train.epochs = epochs
    return hps


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    directory = tmp_path_factory.mktemp("torch_evaluate")
    write_corpus(directory)
    return directory


def _bucket(n, buckets):
    return next((b for b in buckets if n <= b), buckets[-1])


def _jax_evaluate(jm, params, item, hps):
    """What the JAX Trainer's evaluate computes, as numpy: durations, both
    draws, wav, lengths, the wav's mel, the ground truth's mel and frames,
    and the alignment from the durations."""
    ids = np.asarray(item["text"], np.int32)
    t_bucket = _bucket(len(ids), hps.tpu.text_buckets)
    x = np.zeros((1, t_bucket), np.int32)
    x[0, :len(ids)] = ids
    x_len = np.asarray([len(ids)], np.int32)
    sid = np.asarray([item["sid"]], np.int32)
    dp_noise = jax.random.normal(jax.random.PRNGKey(0), (1, t_bucket, 2),
                                 dtype=jnp.float32)
    w_ceil, m_p, logs_p, x_mask = jax.jit(
        lambda p, *a: jm.apply(p, *a, dp_noise=dp_noise, method=jm.infer_encode)
    )(params, x, x_len, sid)
    f_bucket = _bucket(max(int(np.max(np.sum(w_ceil, -1))), 1),
                       hps.tpu.frame_buckets)
    prior = jax.random.normal(jax.random.PRNGKey(1),
                              (1, f_bucket, m_p.shape[-1]), dtype=jnp.float32)
    wav, y_len = jax.jit(
        lambda p, *a: jm.apply(p, *a, max_len=f_bucket, prior_noise=prior,
                               method=jm.infer_decode)
    )(params, w_ceil, m_p, logs_p, x_mask, sid)
    cfg = JaxMelConfig.from_hparams(jax_tiny())
    mel = np.asarray(jax_spec_to_mel(jax_linear_spectrogram(wav, cfg), cfg))
    hop = hps.data.hop_length
    gt = np.asarray(item["wav"], np.float32)
    pad = _bucket(max(len(gt) // hop, 1), hps.tpu.frame_buckets) * hop
    gt_p = np.zeros((1, pad), np.float32)
    gt_p[0, :min(len(gt), pad)] = gt[:pad]
    gt_mel = np.asarray(jax_spec_to_mel(jax_linear_spectrogram(gt_p, cfg), cfg))
    durs = np.asarray(w_ceil)[0][:len(ids)]
    attn = np.zeros((min(int(durs.sum()), f_bucket), len(durs)), np.float32)
    pos = 0
    for j, d in enumerate(durs.astype(np.int64)):
        end = min(pos + int(d), attn.shape[0])
        attn[pos:end, j] = 1.0
        pos = end
    return dict(w_ceil=np.array(w_ceil), dp_noise=np.asarray(dp_noise),
                prior=np.asarray(prior), wav=np.asarray(wav)[0],
                y_len=int(y_len[0]), mel=mel[0], gt=gt,
                gt_mel=gt_mel[0, :min(len(gt), pad) // hop],
                attn=attn)


@pytest.fixture(scope="module")
def against_jax(corpus, tmp_path_factory):
    """(the port's images, audios, captured mels and own durations; the JAX
    side's arrays; the Trainer)."""
    jm = JaxSynth.from_hparams(jax_tiny())
    params, state = carried_weights(jm)
    hps = tiny_hps(corpus)
    trainer = Trainer(hps, str(tmp_path_factory.mktemp("run") / "m"),
                      device="cpu")
    model = trainer.g_state.module
    model.load_state_dict(state, strict=True)
    want = _jax_evaluate(jm, params, trainer.eval_set[0], hps)

    real_encode = model.infer_encode
    own = {}

    def fed_encode(*args, **kwargs):
        w_ceil, *rest = real_encode(*args, **kwargs)
        own["w_ceil"] = w_ceil.numpy().copy()
        return (torch.from_numpy(want["w_ceil"]), *rest)

    mels = []
    real_plot = logging_utils.plot_spectrogram_to_numpy

    def capture(spec):
        mels.append(np.array(spec))
        return real_plot(spec)

    model.infer_encode = fed_encode
    logging_utils.plot_spectrogram_to_numpy = capture
    try:
        images, audios = trainer.evaluate(dp_noise=want["dp_noise"],
                                          prior_noise=want["prior"])
    finally:
        del model.infer_encode
        logging_utils.plot_spectrogram_to_numpy = real_plot
    return dict(images=images, audios=audios, mels=mels, own=own,
                want=want, trainer=trainer)


def test_evaluate_wav_matches_jax(against_jax):
    want, audios = against_jax["want"], against_jax["audios"]
    hop = against_jax["trainer"].hps.data.hop_length
    assert want["y_len"] > 0
    gen = audios["gen/audio"]
    assert gen.shape == (want["y_len"] * hop,)
    np.testing.assert_allclose(gen, want["wav"][:want["y_len"] * hop],
                               rtol=0, atol=WAV_TOL)
    # the port's own durations are JAX's up to a ceil next to an integer
    assert np.abs(against_jax["own"]["w_ceil"] - want["w_ceil"]).max() <= 1


def test_evaluate_mels_match_jax(against_jax):
    want = against_jax["want"]
    gen_mel, gt_mel = against_jax["mels"]  # gen/mel, then gt/mel at step 0
    ref = want["mel"][:want["y_len"]].T
    assert gen_mel.shape == ref.shape == (
        against_jax["trainer"].hps.data.n_mel_channels, want["y_len"])
    np.testing.assert_allclose(gen_mel, ref, rtol=0,
                               atol=MEL_REL_TOL * np.abs(ref).max())
    assert gt_mel.shape == want["gt_mel"].T.shape
    np.testing.assert_allclose(gt_mel, want["gt_mel"].T, rtol=0,
                               atol=MEL_REL_TOL * np.abs(want["gt_mel"]).max())
    np.testing.assert_array_equal(against_jax["audios"]["gt/audio"], want["gt"])


def test_evaluate_alignment_image_matches_jax(against_jax):
    images = against_jax["images"]
    assert set(images) == {"gen/mel", "gen/attn", "gt/mel"}
    want = jax_logging.plot_alignment_to_numpy(against_jax["want"]["attn"].T)
    np.testing.assert_array_equal(images["gen/attn"], want)


def test_evaluate_writes_eval_files(against_jax):
    trainer = against_jax["trainer"]
    assert trainer.g_state.module.training  # back in train mode
    files = os.listdir(os.path.join(trainer.model_dir, "eval"))
    assert any(f.startswith("events.out.tfevents") for f in files)


# --------------------------------------------------------------------------
# without JAX
# --------------------------------------------------------------------------

def _weights(trainer):
    return {f"{n}.{k}": v.clone() for n, st in (("g", trainer.g_state),
                                                 ("d", trainer.d_state))
            for k, v in st.module.state_dict().items()}


def test_fit_evaluates_at_step_0_and_every_interval(corpus, tmp_path, monkeypatch):
    # 4 clips in batches of 2: 2 steps an epoch, 2 epochs, interval 2
    trainer = Trainer(tiny_hps(corpus, eval_interval=2, epochs=2),
                      str(tmp_path / "m"), device="cpu")
    calls = []
    monkeypatch.setattr(trainer, "evaluate",
                        lambda: calls.append(("evaluate", trainer.global_step)))
    # each checkpoint holds the full-width discriminator and its moments
    monkeypatch.setattr(trainer, "save",
                        lambda: calls.append(("save", trainer.global_step)))
    monkeypatch.setattr(trainer, "export_reference_checkpoint", lambda: None)
    trainer.fit(max_epochs=2)
    assert trainer.global_step == 4
    # evaluate() before each save; fit's last save after the last step
    assert calls == [("evaluate", 0), ("save", 0), ("evaluate", 2),
                     ("save", 2), ("save", 4)]


def test_evaluate_leaves_training_bit_identical(corpus, tmp_path):
    """Evaluating at every step (real ``evaluate``) and never (stubbed)
    end with the same weights, the same step generator and the same
    default generator."""
    ends = []
    for stub in (False, True):
        trainer = Trainer(tiny_hps(corpus, eval_interval=1),
                          str(tmp_path / f"stub{stub}"), device="cpu")
        calls = []
        real = trainer.evaluate
        trainer.evaluate = (lambda: calls.append(0)) if stub else (
            lambda: calls.append(real()))
        # ~0.5 GB a checkpoint (the full-width discriminator's moments),
        # and no draw in them
        trainer.save = trainer.export_reference_checkpoint = lambda: None
        torch.manual_seed(5)
        trainer.fit(max_epochs=1)
        assert len(calls) == trainer.global_step == 2
        if not stub:
            assert all(c is not None for c in calls)
        ends.append((_weights(trainer), trainer.generator.get_state(),
                     torch.get_rng_state()))
    (w_eval, g_eval, d_eval), (w_stub, g_stub, d_stub) = ends
    assert torch.equal(g_eval, g_stub) and torch.equal(d_eval, d_stub)
    for k, v in w_stub.items():
        assert torch.equal(w_eval[k], v), k


def test_train_step_right_after_evaluate(corpus, tmp_path):
    trainer = Trainer(tiny_hps(corpus), str(tmp_path / "m"), device="cpu")
    batch = next(iter(trainer.batcher))
    trainer.g_state.module.train()
    before = _weights(trainer)
    trainer.global_step = 1  # off the evaluation steps
    images, audios = trainer.evaluate()
    assert trainer.g_state.module.training
    assert set(audios) == {"gen/audio"} and np.isfinite(audios["gen/audio"]).all()
    metrics = trainer.train_step(batch)
    assert all(torch.isfinite(v) for k, v in metrics.items()
               if not k.startswith("_"))
    after = _weights(trainer)
    assert any(not torch.equal(before[k], after[k]) for k in before
               if k.startswith("g."))


def test_writer_without_tensorboardx_or_matplotlib(corpus, tmp_path, monkeypatch):
    for name in ("tensorboardX", "matplotlib", "matplotlib.pylab"):
        monkeypatch.setitem(sys.modules, name, None)
    trainer = Trainer(tiny_hps(corpus), str(tmp_path / "m"), device="cpu")
    images, audios = trainer.evaluate()
    n_mels, y_len = trainer.hps.data.n_mel_channels, (
        len(audios["gen/audio"]) // trainer.hps.data.hop_length)
    eval_dir = tmp_path / "m" / "eval"
    files = sorted(os.listdir(eval_dir))
    assert files == ["gen_attn_0.npy", "gen_audio_0.wav", "gen_mel_0.npy",
                     "gt_audio_0.wav", "gt_mel_0.npy", "scalars.jsonl"]
    mel = np.load(eval_dir / "gen_mel_0.npy")
    assert mel.shape == (n_mels, y_len, 3) and mel.dtype == np.uint8
    np.testing.assert_array_equal(mel, images["gen/mel"])
    assert mel.min() == 0 and mel.max() == 255
    from scipy.io import wavfile

    sr, pcm = wavfile.read(eval_dir / "gen_audio_0.wav")
    assert sr == SR and len(pcm) == len(audios["gen/audio"])


def test_plot_fallback_is_the_array_origin_at_the_bottom(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    spec = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 6.0]])  # [channels, frames]
    img = logging_utils.plot_spectrogram_to_numpy(spec)
    assert img.shape == (2, 3, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img[..., 0], [[128, 170, 255], [0, 42, 85]])
    assert (img[..., 0] == img[..., 2]).all()
    align = np.zeros((4, 2))  # [frames, tokens]
    align[:3, 0] = align[3:, 1] = 1.0
    img = logging_utils.plot_alignment_to_numpy(align.T)
    np.testing.assert_array_equal(img[..., 0], align[::-1] * 255)
