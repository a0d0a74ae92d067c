"""The port's spectral-norm discriminator against the JAX package's.

* Conv1d and Conv2d (``models/layers.py``): three training forwards from
  the same weights and estimates; each ``u``/``v`` within 1e-6 of JAX's and
  each output within 1e-5 of its largest value.  Outside the
  ``power_iteration`` switch the estimates are frozen, in ``eval()`` and in
  ``train()`` alike, and the output is JAX's frozen apply.
* The iteration runs in fp32 with autocast off, whatever autocast the
  caller runs under: every matrix-vector product of it is taken with
  autocast disabled (on the CPU autocast leaves ``torch.mv`` alone anyway;
  the card's case is in ``tests/test_torch_train_cuda.py``).
* The port's conv is the legacy ``torch.nn.utils.spectral_norm`` hook's
  twin: the same draws from the same seed, the same keys and the same
  forwards.
* The ensemble (periods 2 and 3) after one mutable apply, jitted: logits,
  feature maps and ``u``/``v``, each within 1e-5 of its largest value.
* A port ``D_*.pth`` loads into the JAX package's ``torch_to_flax``, and
  back through the port's ``flax_to_torch`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.models.discriminator import (
    MultiPeriodDiscriminator as JaxMPD,
)
from personalized_text_to_speech_tpu.models.layers import (
    Conv1d as JaxConv1d,
    Conv2d as JaxConv2d,
)
from personalized_text_to_speech_tpu.utils import torch_compat as jax_tc
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.layers import (
    SpectralNormConv1d,
    SpectralNormConv2d,
    power_iteration,
)
from personalized_text_to_speech_tpu_torch.utils.torch_compat import (
    flax_to_torch,
    save_torch_checkpoint,
)

torch.set_num_threads(2)

UV_TOL = 1e-6
OUT_TOL = 1e-5


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _conv_pair(kind):
    """(port conv, JAX conv, JAX variables, port input, JAX input) from one
    seed; the JAX estimates start from the port's."""
    rng = np.random.default_rng(0 if kind == "1d" else 1)
    torch.manual_seed(3)
    if kind == "1d":
        port = SpectralNormConv1d(4, 8, 5, padding=2, groups=2)
        jax_mod = JaxConv1d(8, 5, padding=2, groups=2, spectral_norm=True)
        x = rng.normal(size=(2, 4, 32)).astype(np.float32)
        x_jax = x.transpose(0, 2, 1)
        w = _np(port.weight_orig).transpose(2, 1, 0)
    else:
        port = SpectralNormConv2d(3, 6, (5, 1), stride=(3, 1), padding=(2, 0))
        jax_mod = JaxConv2d(6, (5, 1), strides=(3, 1), padding=(2, 0),
                            spectral_norm=True)
        x = rng.normal(size=(2, 3, 12, 3)).astype(np.float32)
        x_jax = x.transpose(0, 2, 3, 1)
        w = _np(port.weight_orig).transpose(2, 3, 1, 0)
    variables = {
        "params": {"w_orig": jnp.asarray(w), "bias": jnp.asarray(_np(port.bias))},
        "spectral": {"u": jnp.asarray(_np(port.weight_u).copy()),
                     "v": jnp.asarray(_np(port.weight_v).copy())},
    }
    return port, jax_mod, variables, torch.from_numpy(x), jnp.asarray(x_jax)


def _to_port_layout(y, kind):
    y = np.asarray(y)
    return y.transpose(0, 2, 1) if kind == "1d" else y.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_conv_training_forwards_match_jax(kind):
    port, jax_mod, variables, x, x_jax = _conv_pair(kind)
    port.eval()  # dropout's switch: it must not stop the iteration
    for _ in range(3):
        y_jax, new = jax_mod.apply(variables, x_jax, mutable=["spectral"])
        variables["spectral"] = new["spectral"]
        with torch.no_grad(), power_iteration(port):
            y = port(x)
        for name in ("u", "v"):
            np.testing.assert_allclose(
                _np(getattr(port, f"weight_{name}")),
                np.asarray(variables["spectral"][name]), rtol=0, atol=UV_TOL)
        want = _to_port_layout(y_jax, kind)
        np.testing.assert_allclose(_np(y), want, rtol=0,
                                   atol=OUT_TOL * np.abs(want).max())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_conv_output_frozen_outside_the_switch(mode):
    port, jax_mod, variables, x, x_jax = _conv_pair("1d")
    port.train(mode == "train")
    u, v = port.weight_u.clone(), port.weight_v.clone()
    with torch.no_grad():
        y = port(x)
    assert torch.equal(port.weight_u, u) and torch.equal(port.weight_v, v)
    want = _to_port_layout(jax_mod.apply(variables, x_jax), "1d")
    np.testing.assert_allclose(_np(y), want, rtol=0,
                               atol=OUT_TOL * np.abs(want).max())


def test_iteration_runs_fp32_with_autocast_off(monkeypatch):
    port, _, _, x, _ = _conv_pair("1d")
    with torch.no_grad(), power_iteration(port):
        port(x)
    want_u, want_v = port.weight_u.clone(), port.weight_v.clone()

    port, _, _, x, _ = _conv_pair("1d")
    real_mv = torch.mv
    seen = []

    def mv(*args, **kwargs):
        seen.append((torch.is_autocast_enabled("cpu"),
                     torch.is_autocast_enabled("cuda"), args[0].dtype))
        return real_mv(*args, **kwargs)

    monkeypatch.setattr(torch, "mv", mv)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16), \
            power_iteration(port):
        y = port(x)
    assert y.dtype == torch.bfloat16  # the conv itself runs in bf16
    assert len(seen) == 3  # Wᵀu, W v, then σ's W v
    assert all(s == (False, False, torch.float32) for s in seen)
    assert port.weight_u.dtype == port.weight_v.dtype == torch.float32
    assert torch.equal(port.weight_u, want_u)
    assert torch.equal(port.weight_v, want_v)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_conv_is_the_legacy_hooks_twin(kind):
    args = ((4, 8, 5), dict(padding=2)) if kind == "1d" else \
        ((3, 6, (5, 1)), dict(stride=(3, 1), padding=(2, 0)))
    cls, base = ((SpectralNormConv1d, torch.nn.Conv1d) if kind == "1d"
                 else (SpectralNormConv2d, torch.nn.Conv2d))
    torch.manual_seed(5)
    port = cls(*args[0], **args[1])
    torch.manual_seed(5)
    legacy = torch.nn.utils.spectral_norm(base(*args[0], **args[1]))
    assert list(port.state_dict()) == list(legacy.state_dict())
    for k, v in legacy.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    x = torch.randn(2, *(args[0][0], 16) if kind == "1d" else (args[0][0], 12, 3))
    legacy.train()
    for _ in range(3):
        with torch.no_grad(), power_iteration(port):
            y = port(x)
        with torch.no_grad():
            want = legacy(x)
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
        for k in ("weight_u", "weight_v"):
            torch.testing.assert_close(getattr(port, k), getattr(legacy, k),
                                       rtol=0, atol=UV_TOL)


# --------------------------------------------------------------------------
# the ensemble
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ensemble():
    """The port's spectral-norm MPD (periods 2, 3) and the JAX one holding
    its weights and estimates, read by the JAX package's ``.pth`` loader."""
    torch.manual_seed(11)
    port = MultiPeriodDiscriminator((2, 3), use_spectral_norm=True)
    jd = JaxMPD(periods=(2, 3), use_spectral_norm=True)
    wav = jnp.zeros((1, 256))
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), wav, wav)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = jax_tc.torch_to_flax(state, template, strict=True)
    return port, jd, variables


def test_ensemble_state_dict_is_the_references(ensemble):
    port, _, _ = ensemble
    keys = list(port.state_dict())
    convs = {k.rsplit(".", 1)[0] for k in keys}
    assert len(convs) == 7 + 2 * 6  # S: 6 + post; each P: 5 + post
    for c in convs:
        assert {f"{c}.{s}" for s in ("bias", "weight_orig", "weight_u",
                                     "weight_v")} <= set(keys), c
    assert not [k for k in keys if k.endswith(("weight_g", ".weight"))]


def test_ensemble_mutable_apply_matches_jax(ensemble):
    port, jd, variables = ensemble
    rng = np.random.default_rng(4)
    y, y_hat = (rng.normal(size=(2, 256)).astype(np.float32) * 0.3
                for _ in range(2))
    apply = jax.jit(lambda v, a, b: jd.apply(v, a, b, mutable=["spectral"]))
    (j_r, j_g, j_fr, j_fg), new = apply(variables, y, y_hat)
    p = MultiPeriodDiscriminator((2, 3), use_spectral_norm=True)
    p.load_state_dict(port.state_dict())
    p.eval()
    with torch.no_grad(), power_iteration(p):
        p_r, p_g, p_fr, p_fg = p(torch.from_numpy(y), torch.from_numpy(y_hat))

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=OUT_TOL * max(np.abs(want).max(), 1e-6))

    for got, want in zip(p_r + p_g, j_r + j_g):
        close(got, want)
    for got_maps, want_maps in zip(p_fr + p_fg, j_fr + j_fg):
        for got, want in zip(got_maps, want_maps):
            want = np.asarray(want)
            close(got, want.transpose(0, 2, 1) if want.ndim == 3
                  else want.transpose(0, 3, 1, 2))
    carried = flax_to_torch({"params": variables["params"],
                             "spectral": new["spectral"]})
    moved = 0
    for name, b in p.named_buffers():
        np.testing.assert_allclose(_np(b), _np(carried[name]), rtol=0,
                                   atol=OUT_TOL * np.abs(_np(b)).max())
        moved += not torch.equal(b, port.state_dict()[name])
    assert moved >= 2 * 19 - 3  # every estimate but the conv_posts' u


def test_port_pth_loads_into_jax_and_back(ensemble, tmp_path):
    port, _, variables = ensemble
    path = str(tmp_path / "D_0.pth")
    save_torch_checkpoint(port.state_dict(), path, iteration=3)
    state, meta = jax_tc.load_torch_state_dict(path)
    assert meta["iteration"] == 3
    loaded = jax_tc.torch_to_flax(state, variables, strict=True)
    assert set(loaded) == {"params", "spectral"}
    back = flax_to_torch(loaded)
    assert set(back) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
