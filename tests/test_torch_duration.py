"""The deterministic duration predictor (``use_sdp=False``, JAX
``models/duration.py:133``) in the port, against the JAX package: one fused
train step and ``infer``.

The weights, batch and draws are ``tests/test_torch_accum.py``'s with
``use_sdp=False`` (no duration noise).  The step: every loss term within
1e-4 of its own size, every gradient tensor within 1e-4 of its largest
value (``tests/test_torch_train.py``'s bounds).  ``infer`` with the prior
noise injected: durations, lengths and alignment equal, the waveform within
1e-3 (``tests/test_torch_model.py``'s bound).
"""

import jax
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu_torch.models.duration import (
    DurationPredictor,
)
from personalized_text_to_speech_tpu_torch.utils.torch_compat import flax_to_torch
from tests.test_torch_accum import (
    JAX_LOSS_TOL,
    Setup,
    assert_grads_close,
    assert_scalars_match,
    scalars,
)

torch.set_num_threads(2)

MAX_LEN = 64
WAV_TOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    return Setup(spectral=False, use_sdp=False)


def test_fused_step_matches_jax(setup):
    j_metrics, _ = setup.jax_step(1)
    m, _, calls = setup.port_step(1)
    assert isinstance(setup.port_states()[0].module.dp, DurationPredictor)
    assert m["_out"]["l_length"].shape == (4,) and len(calls) == 1
    assert_scalars_match(scalars(j_metrics), scalars(m), tol=JAX_LOSS_TOL,
                         floor=1e-3)
    for net in ("g", "d"):
        assert_grads_close(flax_to_torch(j_metrics[f"_grads_{net}"]),
                           m[f"_grads_{net}"])


def test_infer_matches_jax(setup):
    rng = np.random.default_rng(6)
    x = rng.integers(1, 20, size=(2, 6)).astype(np.int32)
    x_lengths = np.array([6, 4], np.int32)
    sid = np.array([1, 3], np.int32)
    prior = rng.normal(size=(2, MAX_LEN, 8)).astype(np.float32)
    jm = setup.jm
    infer = jax.jit(lambda p, x, xl, sid, prior: jm.apply(
        {"params": p}, x, xl, sid, max_len=MAX_LEN, prior_noise=prior,
        method=jm.infer))
    want_wav, want_len, want_attn, want_mask = infer(
        setup.g_params, x, x_lengths, sid, prior)
    g = setup.port_states()[0].module
    with torch.no_grad():
        wav, y_lengths, attn, y_mask = g.infer(
            torch.from_numpy(x).long(), torch.from_numpy(x_lengths),
            torch.from_numpy(sid).long(), max_len=MAX_LEN,
            prior_noise=torch.from_numpy(prior))
    assert (np.asarray(want_len) < MAX_LEN).all(), "canvas must not saturate"
    np.testing.assert_array_equal(y_lengths.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    np.testing.assert_array_equal(y_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav), rtol=0,
                               atol=WAV_TOL)
    assert np.abs(np.asarray(want_wav)).max() > 0
