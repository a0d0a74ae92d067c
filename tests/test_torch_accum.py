"""Exact gradient accumulation in the port's train step, against the JAX
package's and against the port's own fused step.

The geometry and the batch are ``tests/test_train_accum.py``'s (B=4, 6
tokens, 24 frames, periods 2 and 3), dropout off (the modules in
``eval()``, JAX's ``deterministic=True``).  One flax init gives both sides'
weights (the port's init carried by the JAX package's ``.pth`` loader, zero
leaves redrawn); the draws are JAX ``_sample``'s from the same key.

* Port ``accum_steps=2`` against one jitted JAX ``accum_steps=2`` step,
  both with the spectral-norm discriminator: every scalar within 1e-4 of
  its size and every gradient tensor within 1e-4 of its largest value
  (``tests/test_torch_train.py``'s bounds for the port against JAX: six
  convolution stacks summed in another order), and ``u``/``v`` within 1e-6.
* Port k=2 and k=4 against port k=1, with and without spectral norm and
  with ``use_sdp=False``: scalars 1e-5 relative and D's gradients rtol
  1e-4, atol 1e-6 × the largest gradient (the JAX accumulation test's
  bounds); the ``u``/``v`` of the accumulated step equal to the fused
  step's.  G's gradients are held to 1e-4 of each tensor's largest value
  (the bound of the port against JAX), not to the elementwise one: the
  decoder's convolutions round by batch size (ŷ at B=1 differs from ŷ at
  B=4 by 2.6e-7 of its size on the CPU), and the mel loss's log divides
  the quietest bins' error by their magnitude, so at k=4 the decoder's
  gradients move by 1.6e-5 of their norm (measured; with the mel loss
  alone the same, without it 2.8e-7).  D's gradients and the encoders'
  agree to ~1e-7.
* MAS runs twice per microbatch; a batch not divisible by k raises.
* Dropout on: each microbatch's two forwards draw the same masks.
* The Trainer with ``use_spectral_norm`` and ``accum_steps: 2`` takes its
  steps, exports the reference's keys and resumes ``u``/``v`` exactly.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.models.discriminator import (
    MultiPeriodDiscriminator as JaxMPD,
)
from personalized_text_to_speech_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from personalized_text_to_speech_tpu.train.step import (
    Batch as JaxBatch,
    make_train_step as jax_make_train_step,
)
from personalized_text_to_speech_tpu.utils import torch_compat as jax_tc
from personalized_text_to_speech_tpu_torch.config import (
    load_hparams_from_dict,
    tiny_model_config,
)
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.models import synthesizer
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.train.loop import Trainer
from personalized_text_to_speech_tpu_torch.train.state import create_train_state
from personalized_text_to_speech_tpu_torch.train.step import (
    Batch,
    Samples,
    make_train_step,
)
from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc
from tests.test_model import tiny_model
from tests.test_torch_train import _g_init_args, _jax_params_from, _seeded
from tests.test_train import HOP, tiny_hps

torch.set_num_threads(2)

B, TT, TS = 4, 6, 24
JAX_LOSS_TOL = 1e-4
JAX_GRAD_TOL = 1e-4
UV_TOL = 1e-6
SCALAR_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_KEY = 100


def _arrays():
    """``tests/test_train_accum.py``'s batch."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 8, TS * HOP)
    wav = np.stack([np.sin(2 * np.pi * (20 + 7 * i) * t) * (0.3 + 0.1 * i)
                    for i in range(B)]).astype(np.float32)
    return dict(
        text=rng.integers(1, 10, size=(B, TT)).astype(np.int32),
        text_lengths=np.array([6, 5, 6, 4], np.int32), wav=wav,
        wav_lengths=np.array([TS * HOP, (TS - 4) * HOP, TS * HOP,
                              (TS - 6) * HOP], np.int32),
        sid=np.array([0, 1, 2, 3], np.int32))


def _draws(hps, arrays, use_sdp=True):
    """The draws of JAX's ``_sample`` from ``STEP_KEY`` (step.py:179-193)."""
    seg = hps.train.segment_size // HOP
    rng_post, rng_dp, rng_slice, _ = jax.random.split(
        jax.random.PRNGKey(STEP_KEY), 4)
    ids_max = np.maximum(arrays["wav_lengths"] // HOP - seg + 1, 1)
    u = jax.random.uniform(rng_slice, (B,))
    ids = np.asarray((u * ids_max.astype(u.dtype)).astype(jnp.int32))
    post = np.asarray(jax.random.normal(rng_post, (B, TS, 8), jnp.float32))
    dp = (np.asarray(jax.random.normal(rng_dp, (B, TT, 2), jnp.float32))
          if use_sdp else None)
    return Samples(*(None if a is None else torch.from_numpy(np.array(a))
                     for a in (ids, post, dp)))


class Setup:
    """Flax weights for the tiny G and the spectral-norm (or weight-norm)
    D, from the port's init, and the port's modules built to hold them."""

    def __init__(self, spectral: bool, use_sdp: bool = True):
        self.hps = tiny_hps()
        self.hps.model["use_spectral_norm"] = spectral
        self.hps.model["use_sdp"] = use_sdp
        self.p_hps = load_hparams_from_dict(self.hps.to_dict())
        self.jm = tiny_model(use_sdp=use_sdp)
        self.jd = JaxMPD(periods=(2, 3), use_spectral_norm=spectral)
        self.kw = {k: getattr(self.jm, k)
                   for k in inspect.signature(SynthesizerTrn).parameters}
        self.spectral = spectral
        self.g_params = _jax_params_from(
            _seeded(lambda: SynthesizerTrn(**self.kw)), self.jm,
            *_g_init_args(self.jm.spec_channels))["params"]
        port_d = _seeded(lambda: MultiPeriodDiscriminator(
            (2, 3), use_spectral_norm=spectral), seed=2)
        wav = jnp.zeros((1, 256))
        shapes = jax.eval_shape(self.jd.init, jax.random.PRNGKey(0), wav, wav)
        template = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)
        self.d_vars = jax_tc.torch_to_flax(
            {k: v.numpy() for k, v in port_d.state_dict().items()}, template,
            strict=True)
        self.arrays = _arrays()
        self.samples = _draws(self.hps, self.arrays, use_sdp)

    def port_states(self):
        g = SynthesizerTrn(**self.kw)
        g.load_state_dict(tc.flax_to_torch(self.g_params), strict=True)
        d = MultiPeriodDiscriminator((2, 3), use_spectral_norm=self.spectral)
        d.load_state_dict(tc.flax_to_torch(self.d_vars), strict=True)
        return (create_train_state(g.eval(), self.p_hps, steps_per_epoch=4),
                create_train_state(d.eval(), self.p_hps, steps_per_epoch=4))

    def port_step(self, k, remat="none"):
        """One port step → (metrics, d_state, MAS calls)."""
        g_state, d_state = self.port_states()
        step = make_train_step(self.p_hps, debug_grads=True, accum_steps=k,
                               remat=remat)
        calls = []
        real = synthesizer.maximum_path
        synthesizer.maximum_path = lambda *a: calls.append(a[0].shape) or real(*a)
        try:
            m = step(g_state, d_state, Batch.from_numpy(self.arrays, "cpu"),
                     samples=self.samples)
        finally:
            synthesizer.maximum_path = real
        return m, d_state, calls

    def jax_step(self, k):
        step = jax.jit(jax_make_train_step(
            self.jm, self.jd, self.hps, debug_grads=True, accum_steps=k,
            deterministic=True))
        g_state = jax_create_train_state(self.jm.apply, self.g_params,
                                         self.hps, steps_per_epoch=4)
        d_state = jax_create_train_state(self.jd.apply, self.d_vars["params"],
                                         self.hps, steps_per_epoch=4)
        if self.spectral:
            d_state = d_state.replace(
                mutables={"spectral": self.d_vars["spectral"]})
        _, d_state, metrics = step(g_state, d_state, JaxBatch(**self.arrays),
                                   jax.random.PRNGKey(STEP_KEY))
        return jax.device_get(metrics), jax.device_get(d_state.mutables)


def scalars(m):
    return {k: float(v) for k, v in m.items() if not k.startswith("_")}


def assert_scalars_match(want, got, tol=SCALAR_TOL, floor=1.0):
    assert set(want) == set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= tol * max(floor, abs(w)), (k, got[k], w)


def assert_grads_match(want, got):
    """The JAX accumulation test's bound (``test_train_accum.py``)."""
    assert set(want) == set(got)
    scale = max(v.abs().max().item() for v in want.values() if v is not None)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        torch.testing.assert_close(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(scale, 1.0), msg=k)


def assert_grads_close(want, got, tol=JAX_GRAD_TOL):
    """Each tensor within ``tol`` of its own largest value, or of 1e-5 of
    the network's largest for a gradient that is zero in exact arithmetic
    and rounding noise (``tests/test_torch_train.py``)."""
    assert set(want) == set(got)
    floor = 1e-5 * max(w.abs().max().item() for w in want.values()
                       if w is not None)
    for k, w in want.items():
        if got[k] is None or w is None:
            assert got[k] is None and (w is None or not w.any()), k
            continue
        err = (got[k] - w).abs().max().item()
        assert err <= tol * max(w.abs().max().item(), floor), (k, err)


def uv_of(d_state):
    return {n: b.clone() for n, b in d_state.module.named_buffers()}


@pytest.fixture(scope="module")
def spectral_setup():
    return Setup(spectral=True)


@pytest.fixture(scope="module")
def fused(spectral_setup):
    return spectral_setup.port_step(1)


def test_accum_matches_jax_accum(spectral_setup):
    """Port and JAX ``accum_steps=2`` with the spectral-norm D."""
    j_metrics, j_mut = spectral_setup.jax_step(2)
    m, d_state, _ = spectral_setup.port_step(2)
    assert_scalars_match(scalars(j_metrics), scalars(m), tol=JAX_LOSS_TOL,
                         floor=1e-3)
    for net in ("g", "d"):
        assert_grads_close(tc.flax_to_torch(j_metrics[f"_grads_{net}"]),
                           m[f"_grads_{net}"])
    carried = tc.flax_to_torch({"params": {}, **j_mut})
    uv = uv_of(d_state)
    assert set(carried) == set(uv) and len(uv) == 2 * 19
    for n, b in uv.items():
        torch.testing.assert_close(b, carried[n], rtol=0, atol=UV_TOL, msg=n)


@pytest.mark.parametrize("k", [2, 4])
def test_accum_matches_fused_with_spectral_norm(spectral_setup, fused, k):
    m1, d1, calls1 = fused
    mk, dk, callsk = spectral_setup.port_step(k)
    assert_scalars_match(scalars(m1), scalars(mk))
    assert_grads_match(m1["_grads_d"], mk["_grads_d"])
    assert_grads_close(m1["_grads_g"], mk["_grads_g"])
    uv1, uvk = uv_of(d1), uv_of(dk)
    assert all(torch.equal(uv1[n], uvk[n]) for n in uv1)
    # the estimates advanced (twice, as the fused step's), not 2k times
    d0 = spectral_setup.port_states()[1].module
    assert sum(not torch.equal(b, uv1[n])
               for n, b in d0.named_buffers()) >= 2 * 19 - 3
    assert calls1 == [(B, TS, TT)]
    assert callsk == [(B // k, TS, TT)] * (2 * k)


@pytest.mark.parametrize("use_sdp", [True, False], ids=["sdp", "no_sdp"])
def test_accum_matches_fused_weight_norm(use_sdp):
    setup = Setup(spectral=False, use_sdp=use_sdp)
    m1, _, _ = setup.port_step(1)
    m2, _, _ = setup.port_step(2)
    assert_scalars_match(scalars(m1), scalars(m2))
    assert_grads_match(m1["_grads_d"], m2["_grads_d"])
    assert_grads_close(m1["_grads_g"], m2["_grads_g"])


def test_batch_not_divisible_raises(spectral_setup):
    with pytest.raises(ValueError, match="not divisible"):
        spectral_setup.port_step(3)
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(spectral_setup.p_hps, accum_steps=0)


def test_dropout_masks_shared_by_each_microbatchs_forwards(spectral_setup):
    """With dropout on, phase 2's forward of each microbatch is phase 1's:
    the same masks (the text encoder's and the duration predictor's), so
    the ŷ and alignment that trained D train G."""
    setup = spectral_setup
    g_state, d_state = setup.port_states()
    g_state.module.train()
    step = make_train_step(setup.p_hps, debug_grads=True, accum_steps=2)
    torch.manual_seed(0)
    m = step(g_state, d_state, Batch.from_numpy(setup.arrays, "cpu"),
             samples=setup.samples)
    phase1, phase2 = m["_out_d"], m["_out"]
    assert set(phase1) == set(phase2)
    for n in phase1:
        assert torch.equal(phase1[n], phase2[n]), n
    # the masks were drawn: the dropout-off forward gives another prior
    eval_m, _, _ = setup.port_step(2)
    assert not torch.equal(eval_m["_out"]["m_p"], phase2["m_p"])


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_trainer_accum")
    sr = 8000
    rng = np.random.default_rng(1)
    lines = []
    for i in range(4):
        n = int(sr * rng.uniform(0.5, 0.9))
        t = np.linspace(0, n / sr, n)
        save_wav(str(tmp / f"w{i}.wav"),
                 0.4 * np.sin(2 * np.pi * rng.uniform(100, 250) * t), sr)
        lines.append(f"{tmp / f'w{i}.wav'}|{i % 2}|ab ko→ no↓ da to mi.")
    (tmp / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    hps = tiny_model_config(n_speakers=4)
    hps.data.training_files = str(tmp / "train.txt")
    hps.train.eval_interval = 10
    hps.train.accum_steps = 2
    hps.model.use_spectral_norm = True
    trainer = Trainer(hps, str(tmp / "run"), device="cpu")
    uv0 = uv_of(trainer.d_state)
    calls = []
    real = synthesizer.maximum_path
    synthesizer.maximum_path = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        trainer.fit(max_epochs=1)
    finally:
        synthesizer.maximum_path = real
    return hps, trainer, uv0, calls


def test_trainer_steps_with_spectral_norm_and_accumulation(trained):
    hps, trainer, uv0, calls = trained
    assert trainer.global_step == 2 == trainer.d_state.step
    # batch 2 in two microbatches of 1: 4 forwards a step
    assert len(calls) == 8 and all(s[0] == 1 for s in calls)
    uv = uv_of(trainer.d_state)
    assert sum(not torch.equal(uv[n], uv0[n]) for n in uv) >= len(uv) - 6
    state, _ = tc.load_torch_checkpoint(
        os.path.join(trainer.model_dir, "D_latest.pth"))
    assert set(state) == set(trainer.d_state.module.state_dict())
    assert any(k.endswith("weight_orig") for k in state)
    for n, b in uv.items():
        assert torch.equal(state[n], b), n


def test_trainer_resume_restores_uv_exactly(trained):
    hps, trainer, _, _ = trained
    fresh = Trainer(hps, trainer.model_dir, device="cpu")
    assert fresh.resume() and fresh.global_step == 2
    want = uv_of(trainer.d_state)
    got = uv_of(fresh.d_state)
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
