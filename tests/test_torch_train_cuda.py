"""The port's training path on the card against the same path on the CPU.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest

The CPU side is held against the JAX package in ``test_torch_train.py``;
here the card must give the CPU's numbers.  Both run fp32 with TF32 off
(cuDNN convolutions and cuBLAS products).  Bounds: the MAS path equal; each
loss term within 1e-4 of its own size; each network's whole gradient within
1e-3 of its L2 norm; each gradient tensor within 2e-2 of its own largest
magnitude (or of 1e-5 of its network's largest, for the gradients that are
zero in exact arithmetic and rounding noise on both devices).

Why the per-tensor bound is that wide: the discriminators are piecewise
linear (leaky ReLU), so a gradient jumps where a pre-activation changes
sign.  A pre-activation within rounding distance of zero takes one slope
on the CPU and the other on the card, and every gradient upstream of it
moves by that one position's share.  At this geometry the period-5 member's
third layer has a real-audio pre-activation of 1.6e-10 (of 0.23) in
float64: the card (fp32 or float64, cuDNN on or off) and the JAX package
take one side, torch on the CPU the other, and that layer's weight gradient
differs by 7.4e-3 of its largest value; the whole D gradient (the JAX
package against the CPU) by 3.6e-5 of its norm.  With no sign change the
two devices agree to ~1e-6.
"""

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.layers import power_iteration
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.ops import mas
from personalized_text_to_speech_tpu_torch.ops import spectrogram as spec_ops
from personalized_text_to_speech_tpu_torch.train.state import create_train_state
from personalized_text_to_speech_tpu_torch.train.step import (
    Batch,
    Samples,
    make_train_step,
)

LOSS_TOL = 1e-4
GRAD_NORM_TOL = 1e-3
GRAD_TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MAS kernel has no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _setup():
    """Tiny-width networks from a seed, one bucketed batch and the draws."""
    hps = tiny_model_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = SynthesizerTrn.from_hparams(hps)
        d = MultiPeriodDiscriminator()
    hop, b, tt, ts = hps.data.hop_length, 2, 20, 48
    rng = np.random.default_rng(0)
    t = np.arange(ts * hop) / hps.data.sampling_rate
    wav = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 300, size=(b, 1)) * t)
           + 0.02 * rng.normal(size=(b, ts * hop))).astype(np.float32)
    arrays = dict(text=rng.integers(1, 60, size=(b, tt)).astype(np.int32),
                  text_lengths=np.array([tt, 13], np.int32), wav=wav,
                  wav_lengths=np.array([ts * hop, 40 * hop], np.int32),
                  sid=np.array([0, 3], np.int32))
    seg = hps.train.segment_size // hop
    samples = (np.array([5, 40 - seg], np.int32),
               rng.normal(size=(b, ts, hps.model.inter_channels)).astype(np.float32),
               rng.normal(size=(b, tt, 2)).astype(np.float32))
    return hps, g, d, arrays, samples


def _run_step(hps, g, d, arrays, samples, device):
    g_state = create_train_state(g.to(device).eval(), hps, steps_per_epoch=4)
    d_state = create_train_state(d.to(device).eval(), hps, steps_per_epoch=4)
    batch = Batch.from_numpy(arrays, device)
    return make_train_step(hps, debug_grads=True)(
        g_state, d_state, batch,
        samples=Samples(*(torch.from_numpy(a).to(device) for a in samples)))


@pytest.mark.cuda
def test_step_on_card_matches_cpu(cuda_device):
    hps, g, d, arrays, samples = _setup()
    g_cpu, d_cpu = _setup()[1:3]
    want = _run_step(hps, g_cpu, d_cpu, arrays, samples, "cpu")
    before = mas.maximum_path_cuda.launches
    got = _run_step(hps, g, d, arrays, samples, cuda_device)
    torch.cuda.synchronize()
    assert mas.maximum_path_cuda.launches == before + 1
    assert torch.equal(got["_out"]["attn"].cpu(), want["_out"]["attn"])
    for k, w in want.items():
        if k.startswith("_"):
            continue
        err = abs(got[k].item() - w.item())
        assert err <= LOSS_TOL * max(abs(w.item()), 1e-3), (k, got[k].item(), w.item())
    for net in ("_grads_g", "_grads_d"):
        diff = {k: got[net][k].cpu() - w for k, w in want[net].items()}
        norm_rel = (torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in diff.values()]))
            / torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(w) for w in want[net].values()])))
        assert norm_rel.item() <= GRAD_NORM_TOL, (net, norm_rel.item())
        scales = {k: v.abs().max().item() for k, v in want[net].items()}
        floor = 1e-5 * max(scales.values())
        rel = sorted((v.abs().max().item() / max(scales[k], floor), k)
                     for k, v in diff.items())
        assert rel[-1][0] <= GRAD_TOL, rel[-5:]


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,n_mels", [(256, 64, 20), (1024, 256, 80)])
def test_spectrogram_on_card_matches_cpu(cuda_device, n_fft, hop, n_mels):
    cfg = spec_ops.MelConfig(sampling_rate=22050, n_fft=n_fft, hop_length=hop,
                             win_length=n_fft, n_mels=n_mels)
    rng = np.random.default_rng(1)
    wav = torch.from_numpy((0.3 * rng.normal(size=(4, 400 * hop))).astype(np.float32))
    want = spec_ops.linear_spectrogram(wav, cfg)
    got = spec_ops.linear_spectrogram(wav.to(cuda_device), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # magnitudes up to ~60: fp32 sums of n_fft products in another order
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with torch.autocast(device_type="cuda", dtype=torch.bfloat16):
        got_mel = spec_ops.spec_to_mel(got, cfg)
    assert got_mel.dtype == torch.float32
    want_mel = spec_ops.spec_to_mel(want, cfg)
    assert (got_mel.cpu() - want_mel).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_autocast"])
def test_power_iteration_on_card_is_fp32(cuda_device, bf16):
    """The spectral-norm discriminator's power iteration under CUDA's bf16
    autocast (``bf16_run``), which lowers ``torch.mv``: three iterations on
    the card give the CPU's fp32 ``u``/``v`` to 1e-6 (bf16 keeps 8 bits of
    mantissa, ~4e-3 of a value)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        d = MultiPeriodDiscriminator(use_spectral_norm=True)
    weights = d.state_dict()
    rng = np.random.default_rng(3)
    y, y_hat = (torch.from_numpy((0.3 * rng.normal(size=(2, 2048))).astype(
        np.float32)) for _ in range(2))
    out = {}
    for dev, autocast in (("cpu", False), ("cuda", bf16)):
        net = MultiPeriodDiscriminator(use_spectral_norm=True)
        net.load_state_dict(weights)
        net.to(dev)
        for _ in range(3):
            with torch.no_grad(), power_iteration(net), torch.autocast(
                    device_type=dev, dtype=torch.bfloat16, enabled=autocast):
                net(y.to(dev), y_hat.to(dev))
        out[dev] = {n: b.cpu() for n, b in net.named_buffers()}
    for n, want in out["cpu"].items():
        got = out["cuda"][n]
        assert got.dtype == torch.float32, n
        assert (got - want).abs().max().item() <= 1e-6 * want.norm().item(), n
