"""The PyTorch port's model against the JAX package, module by module and
as a whole, at the tiny geometry of ``tiny_model_config()``.

One flax init of the JAX ``SynthesizerTrn`` (eager, fixed key) provides the
weights of both sides: the port carries them across with its own
``utils/torch_compat.flax_to_torch`` and loads them strictly.  Leaves that
flax initialises to zero (the coupling layers' ``post``, the spline flows'
``proj``, ``ElementwiseAffine``, LayerNorm's ``beta``) are redrawn from a
numpy seed first, so the flows are not identities and every layout of the
carry is exercised.  Inputs and noise are numpy arrays from a seed, fed to
both sides.

Tolerances, all at fp32 on the CPU: module outputs agree to 1e-4 (sums in
another order, a few ulps per layer); the waveforms of ``infer`` and
``forward`` to 1e-3, the parity bound of the JAX package against the
reference; MAS paths exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.config import tiny_model_config as jax_tiny
from personalized_text_to_speech_tpu.models.attention import (
    MultiHeadAttention as JaxMHA,
)
from personalized_text_to_speech_tpu.models.layers import WN as JaxWN
from personalized_text_to_speech_tpu.models.synthesizer import (
    Generator as JaxGenerator,
    SynthesizerTrn as JaxSynth,
)
from personalized_text_to_speech_tpu.ops.spline import (
    piecewise_rational_quadratic_transform as jax_spline,
)
from personalized_text_to_speech_tpu.utils import torch_compat as jax_tc
from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.models.attention import (
    MultiHeadAttention,
)
from personalized_text_to_speech_tpu_torch.models.layers import WN
from personalized_text_to_speech_tpu_torch.models.synthesizer import (
    Generator,
    SynthesizerTrn,
)
from personalized_text_to_speech_tpu_torch.ops.spline import (
    piecewise_rational_quadratic_transform as port_spline,
)
from personalized_text_to_speech_tpu_torch.utils.torch_compat import flax_to_torch

torch.set_num_threads(2)

MODULE_TOL = 1e-4
WAV_TOL = 1e-3

B, T_TEXT, T_SPEC, MAX_LEN = 2, 12, 40, 64
X_LENGTHS = np.array([12, 7], np.int32)
Y_LENGTHS = np.array([40, 29], np.int32)
SID = np.array([0, 2], np.int32)


def _tr(a):
    """numpy [B, T, C] ↔ [B, C, T]."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 1, 2))


def _pt(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def _close(got, want, tol=MODULE_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _redraw_zero_leaves(tree, rng, scale=0.1):
    """Replace every all-zero leaf with N(0, scale) draws."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_zero_leaves(v, rng, scale)
        else:
            a = np.asarray(v)
            if not a.any():
                a = (rng.normal(size=a.shape) * scale).astype(a.dtype)
            out[k] = jnp.asarray(a)
    return out


def _carry(jax_params, module):
    """Load JAX params into a port module, strictly, and put it in eval mode."""
    module.load_state_dict(flax_to_torch(jax_params), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.integers(1, 60, size=(B, T_TEXT)).astype(np.int32),
        spec=np.abs(rng.normal(size=(B, T_SPEC, 129))).astype(np.float32),
        dp_noise=rng.normal(size=(B, T_TEXT, 2)).astype(np.float32),
        prior_noise=rng.normal(size=(B, MAX_LEN, 8)).astype(np.float32),
        posterior_noise=rng.normal(size=(B, T_SPEC, 8)).astype(np.float32),
        # the second start lies past T - segment: both sides clamp it back
        slice_ids=np.array([3, 50], np.int32),
    )


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model carrying the same weights)."""
    jm = JaxSynth.from_hparams(jax_tiny())
    key = jax.random.PRNGKey(0)
    ts = 40
    params = jm.init(
        {"params": key, "noise": key, "slice": key, "dropout": key},
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, ts, jm.spec_channels)), jnp.array([ts]), jnp.array([0]),
    )
    params = {"params": _redraw_zero_leaves(
        jax.device_get(params["params"]), np.random.default_rng(1)
    )}
    tm = _carry(params, SynthesizerTrn.from_hparams(tiny_model_config()))
    return jm, params, tm


def _jax_call(pair, fn, *args, **kw):
    jm, params, _ = pair
    return jm.apply(params, *args, method=fn, **kw)


# --------------------------------------------------------------------------
# weights across
# --------------------------------------------------------------------------

def test_carry_matches_jax_torch_compat(pair):
    _, params, tm = pair
    ours = flax_to_torch(params)
    theirs = jax_tc.flax_to_torch(params)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    assert set(ours) == set(tm.state_dict())


def test_pth_from_jax_package_loads_into_engine(pair, tmp_path):
    _, params, tm = pair
    path = str(tmp_path / "G_carry.pth")
    jax_tc.save_torch_checkpoint(params, path)
    engine = TTSEngine(tiny_model_config(), checkpoint_path=path, device="cpu")
    got = engine.model.state_dict()
    for k, v in tm.state_dict().items():
        assert torch.equal(got[k], v), k
    _, wav = engine.tts("Check weights.", speaker=0, language="English", rng=3)
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,banded", [(12, True), (12, False), (6, True)],
                         ids=["banded-T12", "2T-1-T12", "2T-1-T6"])
def test_attention_matches_jax(t, banded):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, t, 8)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([[t], [t - 3]])).astype(np.float32)
    attn_mask = (mask[:, :, None] * mask[:, None, :])[:, None]
    jmod = JaxMHA(8, 8, 2, window_size=4, banded_rel=banded)
    p = jmod.init(jax.random.PRNGKey(3), x, x, attn_mask)
    p = {"params": _redraw_zero_leaves(jax.device_get(p["params"]), rng)}
    want = jmod.apply(p, x, x, attn_mask)
    tmod = _carry(p, MultiHeadAttention(8, 8, 2, window_size=4,
                                        banded_rel=banded))
    with torch.no_grad():
        got = tmod(_pt(_tr(x)), _pt(_tr(x)), _pt(attn_mask))
        _close(got, _tr(want))
        # the banded and the 2T-1 paths are the same function
        tmod.banded_rel = not banded
        _close(tmod(_pt(_tr(x)), _pt(_tr(x)), _pt(attn_mask)), _tr(want))


def test_wn_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 15, 8)).astype(np.float32)
    mask = (np.arange(15)[None, :, None] < np.array([15, 9])[:, None, None])
    mask = mask.astype(np.float32)
    g = rng.normal(size=(2, 1, 6)).astype(np.float32)
    jmod = JaxWN(8, 5, 2, 3, gin_channels=6)
    p = jmod.init(jax.random.PRNGKey(5), x, mask, g=g)
    want = jmod.apply(p, x, mask, g=g)
    tmod = _carry(p, WN(8, 5, 2, 3, gin_channels=6))
    with torch.no_grad():
        _close(tmod(_pt(_tr(x)), _pt(_tr(mask)), g=_pt(_tr(g))), _tr(want))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_matches_jax_and_inverts(inverse):
    rng = np.random.default_rng(6)
    n, k = 500, 10
    x = rng.uniform(-6.0, 6.0, size=(n,)).astype(np.float32)  # tails too
    w, h = (rng.normal(size=(n, k)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=(n, k - 1)).astype(np.float32)
    kw = dict(tails="linear", tail_bound=5.0)
    want_y, want_ld = jax_spline(x, w, h, d, inverse=inverse, **kw)
    y, ld = port_spline(_pt(x), _pt(w), _pt(h), _pt(d), inverse=inverse, **kw)
    _close(y, want_y)
    _close(ld, want_ld)
    back, back_ld = port_spline(y, _pt(w), _pt(h), _pt(d), inverse=not inverse,
                                **kw)
    _close(back, x)
    _close(back_ld, -ld.numpy())


def _flow_args():
    rng = np.random.default_rng(7)
    z = rng.normal(size=(B, T_SPEC, 8)).astype(np.float32)
    mask = (np.arange(T_SPEC)[None, :, None] < Y_LENGTHS[:, None, None])
    return z, mask.astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_coupling_block_matches_jax(pair, reverse):
    _, _, tm = pair
    z, mask = _flow_args()

    def run(m, z, mask, sid):
        return m.flow(z, mask, g=m._speaker(sid), reverse=reverse)

    want = _jax_call(pair, run, z, mask, SID)
    with torch.no_grad():
        got = tm.flow(_pt(_tr(z)), _pt(_tr(mask)),
                      g=tm._speaker(_pt(SID)), reverse=reverse)
        _close(got, _tr(want))
        back = tm.flow(got, _pt(_tr(mask)), g=tm._speaker(_pt(SID)),
                       reverse=not reverse)
        _close(back, _tr(z * mask))


def test_coupling_layer_logdet_matches_jax(pair):
    _, _, tm = pair
    z, mask = _flow_args()

    def run(m, z, mask, sid):
        return m.flow.flows[1](z, mask, g=m._speaker(sid))

    want_y, want_ld = _jax_call(pair, run, z, mask, SID)
    with torch.no_grad():
        y, ld = tm.flow.flows[2](_pt(_tr(z)), _pt(_tr(mask)),
                                 g=tm._speaker(_pt(SID)))
    _close(y, _tr(want_y))
    _close(ld, want_ld)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_conv_flow_matches_jax(pair, reverse):
    _, _, tm = pair
    rng = np.random.default_rng(8)
    z = (rng.normal(size=(B, T_TEXT, 2)) * 2.0).astype(np.float32)
    h = rng.normal(size=(B, T_TEXT, 8)).astype(np.float32)
    mask = (np.arange(T_TEXT)[None, :, None] < X_LENGTHS[:, None, None])
    mask = mask.astype(np.float32)

    def run(m, z, mask, h):
        return m.dp.flow_couplings[2](z, mask, g=h, reverse=reverse)

    want = _jax_call(pair, run, z, mask, h)
    flow = tm.dp.flows[1 + 2 * 2]
    with torch.no_grad():
        got = flow(_pt(_tr(z)), _pt(_tr(mask)), g=_pt(_tr(h)), reverse=reverse)
        if reverse:
            _close(got, _tr(want))
            back, _ = flow(got, _pt(_tr(mask)), g=_pt(_tr(h)))
        else:
            _close(got[0], _tr(want[0]))
            _close(got[1], want[1])
            back = flow(got[0], _pt(_tr(mask)), g=_pt(_tr(h)), reverse=True)
    _close(back, _tr(z * mask))


def _port_text(tm, x):
    h, _, _, x_mask = tm.enc_p(_pt(x, torch.long), _pt(X_LENGTHS))
    return h, x_mask, tm._speaker(_pt(SID))


def test_text_encoder_matches_jax(pair, inputs):
    _, _, tm = pair
    want = _jax_call(pair, lambda m, x, xl: m.enc_p(x, xl), inputs["x"],
                     X_LENGTHS)
    with torch.no_grad():
        got = tm.enc_p(_pt(inputs["x"], torch.long), _pt(X_LENGTHS))
    for g, w in zip(got, want):
        _close(g, _tr(w))


def test_posterior_encoder_matches_jax(pair, inputs):
    _, _, tm = pair

    def run(m, y, yl, sid, noise):
        return m.enc_q(y, yl, g=m._speaker(sid), noise=noise)

    want = _jax_call(pair, run, inputs["spec"], Y_LENGTHS, SID,
                     inputs["posterior_noise"])
    with torch.no_grad():
        got = tm.enc_q(_pt(_tr(inputs["spec"])), _pt(Y_LENGTHS),
                       g=tm._speaker(_pt(SID)),
                       noise=_pt(_tr(inputs["posterior_noise"])))
    for g, w in zip(got, want):
        _close(g, _tr(w))


def test_sdp_reverse_logw_matches_jax(pair, inputs):
    _, _, tm = pair

    def run(m, x, xl, sid, noise):
        h, _, _, x_mask = m.enc_p(x, xl)
        return m.dp(h, x_mask, g=m._speaker(sid), reverse=True,
                    noise_scale=0.8, noise=noise)

    want = _jax_call(pair, run, inputs["x"], X_LENGTHS, SID, inputs["dp_noise"])
    with torch.no_grad():
        h, x_mask, g = _port_text(tm, inputs["x"])
        got = tm.dp(h, x_mask, g=g, reverse=True, noise_scale=0.8,
                    noise=_pt(_tr(inputs["dp_noise"])))
    _close(got, _tr(want))


def test_sdp_forward_nll_matches_jax(pair, inputs):
    _, _, tm = pair
    w = np.random.default_rng(9).integers(1, 6, size=(B, T_TEXT, 1))
    w = (w * (np.arange(T_TEXT)[None, :, None] < X_LENGTHS[:, None, None]))
    w = w.astype(np.float32)

    def run(m, x, xl, sid, w, noise):
        h, _, _, x_mask = m.enc_p(x, xl)
        return m.dp(h, x_mask, w=w, g=m._speaker(sid), noise=noise)

    want = _jax_call(pair, run, inputs["x"], X_LENGTHS, SID, w,
                     inputs["dp_noise"])
    with torch.no_grad():
        h, x_mask, g = _port_text(tm, inputs["x"])
        got = tm.dp(h, x_mask, w=_pt(_tr(w)), g=g,
                    noise=_pt(_tr(inputs["dp_noise"])))
    # an NLL summed over T·2 terms of size ~10: compare relative to that
    _close(got, want, tol=MODULE_TOL * 100)


def _generator_case():
    rng = np.random.default_rng(10)
    z = rng.normal(size=(B, 10, 8)).astype(np.float32)
    mask = (np.arange(10)[None, :, None] < np.array([10, 6])[:, None, None])
    g = rng.normal(size=(B, 1, 6)).astype(np.float32)
    return z, mask.astype(np.float32), g


def test_generator_with_mask_matches_jax(pair):
    _, _, tm = pair
    z, mask, g = _generator_case()
    want = _jax_call(pair, lambda m, z, g, mask: m.dec(z, g=g, x_mask=mask),
                     z, g, mask)
    with torch.no_grad():
        got = tm.dec(_pt(_tr(z)), g=_pt(_tr(g)), x_mask=_pt(_tr(mask)))
    _close(got, _tr(want))


def test_generator_resblock1_matches_jax():
    z, mask, g = _generator_case()
    cfg = ("1", (3, 5), ((1, 3, 5), (1, 3, 5)), (8, 8), 16, (16, 16))
    jmod = JaxGenerator(8, *cfg, gin_channels=6)
    p = jmod.init(jax.random.PRNGKey(11), z, g, mask)
    want = jmod.apply(p, z, g, mask)
    tmod = _carry(p, Generator(8, *cfg, gin_channels=6))
    with torch.no_grad():
        got = tmod(_pt(_tr(z)), g=_pt(_tr(g)), x_mask=_pt(_tr(mask)))
    _close(got, _tr(want))
    # the stage re-masking: zero beyond each utterance's samples
    assert not got[1, :, 6 * 64:].any()


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

def _port_infer(tm, inputs, **kw):
    with torch.no_grad():
        return tm.infer(
            _pt(inputs["x"], torch.long), _pt(X_LENGTHS), _pt(SID),
            max_len=MAX_LEN, dp_noise=_pt(inputs["dp_noise"]),
            prior_noise=_pt(inputs["prior_noise"]), **kw,
        )


def test_infer_matches_jax(pair, inputs):
    jm, _, tm = pair
    want_wav, want_len, want_attn, want_mask = _jax_call(
        pair, jm.infer, inputs["x"], X_LENGTHS, SID, max_len=MAX_LEN,
        dp_noise=inputs["dp_noise"], prior_noise=inputs["prior_noise"],
    )
    wav, y_lengths, attn, y_mask = _port_infer(tm, inputs)
    assert (np.asarray(want_len) < MAX_LEN).all(), "canvas must not saturate"
    np.testing.assert_array_equal(y_lengths.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    np.testing.assert_array_equal(y_mask.numpy(), np.asarray(want_mask))
    _close(wav, want_wav, tol=WAV_TOL)


def test_encode_then_decode_matches_jax_and_infer(pair, inputs):
    """``infer_encode`` → ``infer_decode`` against JAX, and against the
    port's own one-call ``infer``.  The decode stage is fed JAX's
    ``w_ceil``: a 1e-6 difference in ``logw`` next to an integer would
    change a frame count, so the durations are compared through ``logw``
    (:func:`test_sdp_reverse_logw_matches_jax`) and handed across."""
    jm, _, tm = pair
    w_ceil, m_p, logs_p, x_mask = _jax_call(
        pair, jm.infer_encode, inputs["x"], X_LENGTHS, SID,
        dp_noise=inputs["dp_noise"],
    )
    want_wav, want_len = _jax_call(
        pair, jm.infer_decode, w_ceil, m_p, logs_p, x_mask, SID,
        max_len=MAX_LEN, prior_noise=inputs["prior_noise"],
    )
    with torch.no_grad():
        enc = tm.infer_encode(_pt(inputs["x"], torch.long), _pt(X_LENGTHS),
                              _pt(SID), dp_noise=_pt(inputs["dp_noise"]))
        for got, want in zip(enc[1:], (m_p, logs_p, x_mask)):
            _close(got, want)
        wav, y_lengths = tm.infer_decode(
            _pt(np.asarray(w_ceil)), *enc[1:], _pt(SID), max_len=MAX_LEN,
            prior_noise=_pt(inputs["prior_noise"]),
        )
    np.testing.assert_array_equal(y_lengths.numpy(), np.asarray(want_len))
    _close(wav, want_wav, tol=WAV_TOL)
    one_call = _port_infer(tm, inputs)[0]
    _close(wav, one_call.numpy(), tol=0.0)


def test_forward_matches_jax(pair, inputs):
    jm, _, tm = pair
    want = _jax_call(
        pair, jm.__call__, inputs["x"], X_LENGTHS, inputs["spec"], Y_LENGTHS,
        SID, deterministic=True, slice_ids=inputs["slice_ids"],
        posterior_noise=inputs["posterior_noise"], dp_noise=inputs["dp_noise"],
    )
    with torch.no_grad():
        got = tm(
            _pt(inputs["x"], torch.long), _pt(X_LENGTHS), _pt(inputs["spec"]),
            _pt(Y_LENGTHS), _pt(SID), slice_ids=_pt(inputs["slice_ids"]),
            posterior_noise=_pt(inputs["posterior_noise"]),
            dp_noise=_pt(inputs["dp_noise"]),
        )
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    assert got["attn"].sum() == Y_LENGTHS.sum()  # one token per valid frame
    for k in ("wav_hat", "z", "z_p", "m_p", "logs_p", "m_q", "logs_q",
              "l_length", "x_mask", "y_mask"):
        _close(got[k], want[k], tol=WAV_TOL)
