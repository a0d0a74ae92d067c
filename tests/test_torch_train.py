"""The port's training path against the JAX package: losses, the optimizer,
one fused GAN step, and the Trainer on a filelist.

* Losses and AdamW with the staircase decay: the same numpy inputs and
  gradients on both sides.
* One fused step at the tiny geometry of ``tests/test_train.py``: one flax
  init gives both sides' weights (carried by the port's ``flax_to_torch``,
  loaded strictly); the JAX step runs once, jitted, with
  ``debug_grads=True, deterministic=True``; the port's step gets the same
  batch and the draws JAX's ``_sample`` makes from the same key
  (``step.py:179-193``), with its modules in ``eval()`` mode.  The MAS path
  must be equal, every loss term within 1e-4 of its own size, and every
  gradient tensor within 1e-4 of its own largest magnitude (measured: at
  most 4.3e-5, in the duration predictor's spline flows): the step is a
  chain of fp32 sums in another order (six convolution stacks, a
  spectrogram, two losses through the discriminators), each a few ulps.
* The Trainer on synthetic wavs on the CPU: two steps, save → resume
  restores the step and the Adam moments exactly, the exported
  ``G_latest.pth`` loads strictly into ``TTSEngine``, JAX-exported
  ``G/D .pth`` files with another speaker count warm-start it, and the CLI
  resumes the run.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from personalized_text_to_speech_tpu.config import (
    tiny_model_config as jax_tiny_config,
)
from personalized_text_to_speech_tpu.models.discriminator import (
    MultiPeriodDiscriminator as JaxMPD,
)
from personalized_text_to_speech_tpu.models.synthesizer import (
    SynthesizerTrn as JaxSynth,
)
from personalized_text_to_speech_tpu.ops.spectrogram import (
    MelConfig as JaxMelConfig,
    linear_spectrogram as jax_linear_spectrogram,
)
from personalized_text_to_speech_tpu.train import losses as jax_losses
from personalized_text_to_speech_tpu.train.state import (
    create_train_state as jax_create_train_state,
    make_optimizer as jax_make_optimizer,
)
from personalized_text_to_speech_tpu.train.step import (
    Batch as JaxBatch,
    make_train_step as jax_make_train_step,
)
from personalized_text_to_speech_tpu.utils import torch_compat as jax_tc
from personalized_text_to_speech_tpu_torch.config import (
    load_hparams_from_dict,
    save_hparams,
    tiny_model_config,
)
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.train import losses
from personalized_text_to_speech_tpu_torch.train.__main__ import main as train_cli
from personalized_text_to_speech_tpu_torch.train.loop import Trainer
from personalized_text_to_speech_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from personalized_text_to_speech_tpu_torch.train.step import (
    Batch,
    Samples,
    make_train_step,
)
from personalized_text_to_speech_tpu_torch.utils.torch_compat import flax_to_torch
from tests.test_model import tiny_model
from tests.test_torch_model import _redraw_zero_leaves
from tests.test_train import HOP, tiny_hps

torch.set_num_threads(2)

LOSS_TOL = 1e-4
GRAD_TOL = 1e-4


def _pt(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# losses and the optimizer
# --------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(3)
    outs = [rng.normal(size=(2, n)).astype(np.float32) for n in (7, 5, 3)]
    fmaps = [[rng.normal(size=(2, 4, n)).astype(np.float32) for n in (9, 4)]
             for _ in range(3)]
    return rng, outs, fmaps


@pytest.mark.parametrize("name", ["feature", "discriminator", "generator", "kl"])
def test_loss_matches_jax(name):
    rng, outs, fmaps = _loss_inputs()
    if name == "feature":
        fmaps_g = [[f + 0.1 * rng.normal(size=f.shape).astype(np.float32)
                    for f in fm] for fm in fmaps]
        want = [jax_losses.feature_loss(fmaps, fmaps_g)]
        got = [losses.feature_loss([[_pt(f) for f in fm] for fm in fmaps],
                                   [[_pt(f) for f in fm] for fm in fmaps_g])]
    elif name == "discriminator":
        gen = [o[::-1].copy() for o in outs]
        w_total, w_r, w_g = jax_losses.discriminator_loss(outs, gen)
        g_total, g_r, g_g = losses.discriminator_loss(
            [_pt(o) for o in outs], [_pt(o) for o in gen])
        want, got = [w_total, *w_r, *w_g], [g_total, *g_r, *g_g]
    elif name == "generator":
        w_total, w_each = jax_losses.generator_loss(outs)
        g_total, g_each = losses.generator_loss([_pt(o) for o in outs])
        want, got = [w_total, *w_each], [g_total, *g_each]
    else:
        z_p, logs_q, m_p, logs_p = (
            rng.normal(size=(2, 11, 4)).astype(np.float32) * 0.5 for _ in range(4))
        mask = (np.arange(11)[None, :, None] < np.array([11, 6])[:, None, None])
        mask = mask.astype(np.float32)
        want = [jax_losses.kl_loss(z_p, logs_q, m_p, logs_p, mask)]
        got = [losses.kl_loss(*map(_pt, (z_p, logs_q, m_p, logs_p, mask)))]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, atol=1e-6)


def test_adamw_staircase_matches_optax():
    """Three AdamW updates across an epoch boundary (2 steps per epoch, a
    steep γ so the staircase shows) on identical gradients."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[1]["b"][:] = 0.0  # a zero gradient: only the decay moves it
    kw = dict(betas=(0.8, 0.99), eps=1e-9, lr_decay=0.5, steps_per_epoch=2)

    tx = jax_make_optimizer(2e-4, **kw)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(_pt(v)) for k, v in params.items()}
    opt, sched = make_optimizer(list(t_params.values()), 2e-4, **kw)
    lrs = []
    for g in grads:
        upd, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for k, p in t_params.items():
            p.grad = _pt(g[k])
        lrs.append(sched.get_last_lr()[0])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [2e-4, 2e-4, 1e-4], rtol=1e-12)
    for k, p in t_params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                   rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# one fused step against JAX
# --------------------------------------------------------------------------

B, TT, TS = 2, 6, 24


def _jax_params_from(port_module, jax_module, *init_args, seed=1):
    """Flax params of ``jax_module`` holding ``port_module``'s torch init
    (the reference's own init), read by the JAX package's ``.pth`` loader
    (``torch_to_flax``, strict) into the shapes of ``jax_module.init``,
    taken by ``jax.eval_shape`` (traced, not run: a flax init takes tens
    of seconds on the CPU).  Leaves that both initialise to zero (the
    coupling and spline projections, ElementwiseAffine, LayerNorm's beta)
    are redrawn from a numpy seed, so no layer is an identity."""
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "noise": key, "slice": key, "dropout": key}
    shapes = jax.eval_shape(jax_module.init, rngs, *init_args)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = {k: v.numpy() for k, v in port_module.state_dict().items()}
    params = jax_tc.torch_to_flax(state, {"params": template}, strict=True)
    return {"params": _redraw_zero_leaves(jax.device_get(params["params"]),
                                          np.random.default_rng(seed))}


def _seeded(build, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _g_init_args(spec_channels, b=1, tt=8, ts=40):
    return (jnp.ones((b, tt), jnp.int32), jnp.full((b,), tt),
            jnp.zeros((b, ts, spec_channels)), jnp.full((b,), ts),
            jnp.zeros((b,), jnp.int32))


def _d_init_args(n=256):
    return (jnp.zeros((1, n)), jnp.zeros((1, n)))


@pytest.fixture(scope="module")
def step_pair():
    """Both sides' outputs of one fused step from the same weights, batch
    and draws."""
    hps = tiny_hps()
    jm = tiny_model()
    jd = JaxMPD(periods=(2, 3))
    kw = {k: getattr(jm, k) for k in inspect.signature(SynthesizerTrn).parameters}
    g_params = _jax_params_from(_seeded(lambda: SynthesizerTrn(**kw)), jm,
                                *_g_init_args(jm.spec_channels))["params"]
    d_params = _jax_params_from(_seeded(lambda: MultiPeriodDiscriminator((2, 3))),
                                jd, *_d_init_args(), seed=2)["params"]

    rng = np.random.default_rng(0)
    t = np.linspace(0, 8, TS * HOP)
    wav = (np.stack([np.sin(2 * np.pi * 25 * t), 0.5 * np.sin(2 * np.pi * 40 * t)])
           * 0.6 + 0.02 * rng.normal(size=(B, TS * HOP))).astype(np.float32)
    arrays = dict(text=rng.integers(1, 10, size=(B, TT)).astype(np.int32),
                  text_lengths=np.array([6, 5], np.int32), wav=wav,
                  wav_lengths=np.array([TS * HOP, (TS - 4) * HOP], np.int32),
                  sid=np.array([0, 1], np.int32))

    # JAX: one jitted fused step with the gradients out
    step_key = jax.random.PRNGKey(7)
    j_step = jax.jit(jax_make_train_step(jm, jd, hps, debug_grads=True,
                                         deterministic=True))
    j_g = jax_create_train_state(jm.apply, g_params, hps, steps_per_epoch=4)
    j_d = jax_create_train_state(jd.apply, d_params, hps, steps_per_epoch=4)
    _, _, j_metrics = j_step(j_g, j_d, JaxBatch(**arrays), step_key)
    j_metrics = jax.device_get(j_metrics)

    # the draws of JAX's _sample from the same key (step.py:179-193)
    seg = hps.train.segment_size // HOP
    rng_post, rng_dp, rng_slice, _ = jax.random.split(step_key, 4)
    ids_max = np.maximum(arrays["wav_lengths"] // HOP - seg + 1, 1)
    u = jax.random.uniform(rng_slice, (B,))
    ids = np.asarray((u * ids_max.astype(u.dtype)).astype(jnp.int32))
    post = np.asarray(jax.random.normal(rng_post, (B, TS, 8), jnp.float32))
    dp = np.asarray(jax.random.normal(rng_dp, (B, TT, 2), jnp.float32))

    # the JAX forward's alignment on the same inputs, for the MAS path
    mel_cfg = JaxMelConfig.from_hparams(hps)

    @jax.jit
    def j_attn_fn(params, a, ids, post, dp):
        spec = jax_linear_spectrogram(a["wav"], mel_cfg)
        return jm.apply(
            {"params": params}, a["text"], a["text_lengths"], spec,
            a["wav_lengths"] // HOP, a["sid"], deterministic=True,
            slice_ids=ids, posterior_noise=post, dp_noise=dp,
        )["attn"]

    j_attn = np.asarray(j_attn_fn(g_params, arrays, ids, post, dp))

    # the port: same weights, batch and draws; dropout off
    p_hps = load_hparams_from_dict(hps.to_dict())
    g = SynthesizerTrn(**kw)
    g.load_state_dict(flax_to_torch(g_params), strict=True)
    d = MultiPeriodDiscriminator((2, 3))
    d.load_state_dict(flax_to_torch(d_params), strict=True)
    g_state = create_train_state(g.eval(), p_hps, steps_per_epoch=4)
    d_state = create_train_state(d.eval(), p_hps, steps_per_epoch=4)
    samples = Samples(_pt(ids), _pt(post), _pt(dp))
    p_metrics = make_train_step(p_hps, debug_grads=True)(
        g_state, d_state, Batch.from_numpy(arrays, "cpu"), samples=samples)
    return j_metrics, j_attn, p_metrics, (g_state, d_state)


def test_step_mas_path_equals_jax(step_pair):
    _, j_attn, p_metrics, _ = step_pair
    attn = p_metrics["_out"]["attn"].numpy()
    np.testing.assert_array_equal(attn, j_attn)
    assert attn.sum() == TS + (TS - 4)  # one token per valid frame


def test_step_losses_match_jax(step_pair):
    j_metrics, _, p_metrics, _ = step_pair
    names = {k for k in j_metrics if not k.startswith("_")}
    assert names == {k for k in p_metrics if not k.startswith("_")}
    assert len(names) == 9 + 3 * 3  # 3 members: 1 scale + periods 2, 3
    for k in sorted(names):
        want = float(j_metrics[k])
        got = p_metrics[k].item()
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-3), (k, got, want)


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_gradients_match_jax(step_pair, net):
    j_metrics, _, p_metrics, states = step_pair
    want = flax_to_torch(j_metrics[f"_grads_{net}"])
    got = p_metrics[f"_grads_{net}"]
    module = states[0 if net == "g" else 1].module
    assert set(want) == set(got) == {n for n, _ in module.named_parameters()}
    errs = {}
    for k, w in want.items():
        gk = got[k]
        scale = w.abs().max().item()
        if gk is None:  # a parameter the step does not reach
            assert scale == 0.0, k
            continue
        errs[k] = ((gk - w).abs().max().item(), scale)
    # a gradient that is zero in exact arithmetic (the attention key's bias:
    # a shift every key's score shares cancels in the softmax) is rounding
    # noise on both sides, ~1e-10 of the network's largest; it is held to
    # the bound of a tensor at 1e-5 of that largest
    floor = 1e-5 * max(s for _, s in errs.values())
    for k, (err, scale) in errs.items():
        assert err <= GRAD_TOL * max(scale, floor), (k, err, scale, floor)


def test_step_updates_both_networks(step_pair):
    _, _, p_metrics, (g_state, d_state) = step_pair
    assert g_state.step == d_state.step == 1
    for k, v in p_metrics.items():
        if not k.startswith("_"):
            assert torch.isfinite(v), k


# --------------------------------------------------------------------------
# the Trainer on a filelist, on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_trainer")
    sr = 8000
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        n = int(sr * rng.uniform(0.5, 0.9))
        t = np.linspace(0, n / sr, n)
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 250) * t)
        save_wav(str(tmp / f"w{i}.wav"), wav, sr)
        lines.append(f"{tmp / f'w{i}.wav'}|{i % 2}|ab ko→ no↓ da to mi.")
    (tmp / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    hps = tiny_model_config(n_speakers=4)
    hps.data.training_files = str(tmp / "train.txt")
    hps.train.eval_interval = 10
    model_dir = str(tmp / "run")
    trainer = Trainer(hps, model_dir, device="cpu")
    trainer.fit(max_epochs=1)
    return hps, model_dir, trainer, tmp


def test_trainer_takes_steps_and_exports(trained):
    hps, model_dir, trainer, _ = trained
    assert trainer.global_step == 2 == trainer.g_state.step == trainer.d_state.step
    assert trainer.g_state.module.training
    for name in ("G_latest.pth", "D_latest.pth", "config.json", "train.log"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    # saved at step 0 and at the end
    assert sorted(os.listdir(os.path.join(model_dir, "checkpoints"))) == [
        "step_00000000.pt", "step_00000002.pt"]
    engine = TTSEngine(hps, checkpoint_path=os.path.join(model_dir, "G_latest.pth"),
                       device="cpu")
    for k, v in trainer.g_state.module.state_dict().items():
        assert torch.equal(engine.model.state_dict()[k], v), k
    _, wav = engine.tts("Check weights.", speaker=0, language="English", rng=3)
    assert len(wav) > 0 and np.isfinite(wav).all()


def test_trainer_resume_restores_state_exactly(trained):
    hps, model_dir, trainer, _ = trained
    fresh = Trainer(hps, model_dir, device="cpu")
    assert fresh.resume()
    assert fresh.global_step == 2 and fresh.epoch == 2
    for mine, theirs in ((fresh.g_state, trainer.g_state),
                         (fresh.d_state, trainer.d_state)):
        assert mine.step == theirs.step == 2
        for k, v in theirs.module.state_dict().items():
            assert torch.equal(mine.module.state_dict()[k], v), k
        a, b = mine.optimizer.state_dict(), theirs.optimizer.state_dict()
        assert a["param_groups"] == b["param_groups"]
        assert len(a["state"]) == len(b["state"]) > 0
        for i, s in b["state"].items():
            for name in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a["state"][i][name], s[name]), (i, name)
        assert mine.scheduler.get_last_lr() == theirs.scheduler.get_last_lr()


def test_trainer_warm_starts_from_jax_pth_with_other_speaker_count(trained, tmp_path):
    """JAX-exported G/D files of a 3-speaker model warm-start the
    4-speaker Trainer: every tensor loads, the speaker table row by row
    (rows 0-2 from the file, row 3 fresh)."""
    hps, _, _, _ = trained
    jcfg = jax_tiny_config(n_speakers=3)
    jm = JaxSynth.from_hparams(jcfg)
    g_params = _jax_params_from(
        _seeded(lambda: SynthesizerTrn.from_hparams(
            tiny_model_config(n_speakers=3)), seed=4),
        jm, *_g_init_args(jm.spec_channels), seed=4)
    d_params = _jax_params_from(_seeded(MultiPeriodDiscriminator, seed=5), JaxMPD(),
                                *_d_init_args(), seed=5)
    g_path, d_path = str(tmp_path / "G_0.pth"), str(tmp_path / "D_0.pth")
    jax_tc.save_torch_checkpoint(jax.device_get(g_params), g_path)
    jax_tc.save_torch_checkpoint(jax.device_get(d_params), d_path)

    base = Trainer(hps, str(tmp_path / "fresh"), device="cpu")
    warm = Trainer(hps, str(tmp_path / "warm"), pretrained_g=g_path,
                   pretrained_d=d_path, device="cpu")
    want_g = flax_to_torch(jax.device_get(g_params))
    got_g = warm.g_state.module.state_dict()
    for k, v in want_g.items():
        if k == "emb_g.weight":
            assert v.shape[0] == 3 and got_g[k].shape[0] == 4
            assert torch.equal(got_g[k][:3], v)
            assert torch.equal(got_g[k][3], base.g_state.module.state_dict()[k][3])
        else:
            assert torch.equal(got_g[k], v), k
    for k, v in flax_to_torch(jax.device_get(d_params)).items():
        assert torch.equal(warm.d_state.module.state_dict()[k], v), k
    # --drop_speaker_embed keeps every fresh row
    dropped = Trainer(hps, str(tmp_path / "drop"), pretrained_g=g_path,
                      drop_speaker_embed=True, device="cpu")
    assert torch.equal(dropped.g_state.module.emb_g.weight,
                       base.g_state.module.emb_g.weight)


def test_cli_resumes_the_run(trained, tmp_path):
    """``python -m …train -c cfg -m dir -n 2 --cont true --device cpu``
    resumes the Trainer's run at step 2 and trains epoch 2."""
    hps, model_dir, _, _ = trained
    cfg = str(tmp_path / "cfg.json")
    cli_hps = load_hparams_from_dict(hps.to_dict())
    cli_hps.train.epochs = 2
    save_hparams(cli_hps, cfg)
    assert train_cli(["-c", cfg, "-m", model_dir, "-n", "2", "--cont", "true",
                      "--preserved", "2", "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(model_dir, "checkpoints"))) == [
        "step_00000002.pt", "step_00000004.pt"]


def test_trainer_defaults_to_the_card(trained):
    hps, _, _, tmp = trained
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(hps, str(tmp / "cuda_run"))
