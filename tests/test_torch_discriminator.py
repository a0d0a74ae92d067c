"""The port's discriminators (``models/discriminator.py``) and their weight
carry (``utils/torch_compat.py``) against the JAX package.

One flax init of the JAX ``MultiPeriodDiscriminator`` gives the weights of
both sides: the port carries them with its own ``flax_to_torch`` and loads
them strictly.  The segment length is a multiple of none of the periods, so
every period discriminator pads with a reflection.  Logits and every feature
map (the JAX package keeps channels last; compared in torch's layout) agree
to 1e-4 in fp32: sums of a few thousand products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.models.discriminator import (
    MultiPeriodDiscriminator as JaxMPD,
)
from personalized_text_to_speech_tpu.utils import torch_compat as jax_tc
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.utils.torch_compat import (
    flax_to_torch,
    load_partial_state_dict,
    load_torch_checkpoint,
)

torch.set_num_threads(2)

TOL = 1e-4
SEG = 1001  # 1001 = 7·11·13: the pad runs for periods 2, 3 and 5 here
PERIOD_SETS = {"periods-2-3": (2, 3), "periods-all": (2, 3, 5, 7, 11)}


@pytest.fixture(scope="module", params=sorted(PERIOD_SETS))
def pair(request):
    periods = PERIOD_SETS[request.param]
    jm = JaxMPD(periods=periods)
    wav = jnp.zeros((1, 64))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), wav, wav))
    tm = MultiPeriodDiscriminator(periods)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return jm, params, tm.eval(), periods


def _segments(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(SEG) / 800.0
    y = (0.5 * np.sin(2 * np.pi * 60 * t)[None] * np.ones((2, 1))
         + 0.05 * rng.normal(size=(2, SEG))).astype(np.float32)
    y_hat = (0.3 * rng.normal(size=(2, SEG))).astype(np.float32)
    return y, y_hat


def test_carry_matches_jax_torch_compat(pair):
    _, params, tm, _ = pair
    ours = flax_to_torch(params)
    theirs = jax_tc.flax_to_torch(params)
    assert set(ours) == set(theirs) == set(tm.state_dict())
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == np.shape(v), k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def _to_torch_layout(a):
    """JAX feature map → torch's: [B, T, C] → [B, C, T]; [B, H, W, C] →
    [B, C, H, W]."""
    a = np.asarray(a)
    return np.moveaxis(a, -1, 1)


def test_logits_and_feature_maps_match_jax(pair):
    jm, params, tm, periods = pair
    y, y_hat = _segments()
    want = jm.apply(params, y, y_hat)
    with torch.no_grad():
        got = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
    assert len(got[0]) == 1 + len(periods)
    for g_logits, w_logits in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(g_logits.numpy(), np.asarray(w_logits),
                                   rtol=0, atol=TOL)
    for g_maps, w_maps in zip(got[2] + got[3], want[2] + want[3]):
        assert len(g_maps) == len(w_maps)
        for g, w in zip(g_maps, w_maps):
            w = _to_torch_layout(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


def test_reference_pth_from_jax_loads_whole(pair, tmp_path):
    """A ``D_*.pth`` the JAX package exports loads into the port's
    discriminator with no key left fresh."""
    _, params, tm, periods = pair
    path = str(tmp_path / "D_carry.pth")
    jax_tc.save_torch_checkpoint(params, path)
    state, meta = load_torch_checkpoint(path)
    fresh_model = MultiPeriodDiscriminator(periods)
    assert load_partial_state_dict(fresh_model, state) == []
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh_model.state_dict()[k], v), k
    assert meta["iteration"] == 0
