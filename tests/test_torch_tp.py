"""Tensor parallelism in the port (``parallel/tp.py``) over a data × model
mesh of processes, on the CPU over gloo.

Every rank runs in a process of its own with a wall-clock limit
(``parallel.dryrun.spawn_ranks``; ranks import no JAX).  The runs start
together in background threads when the first test asks for them, and the
JAX tensor-parallel step compiles meanwhile.

* The decision: for every parameter of the tiny G and the weight-norm D,
  ``param_specs`` at tp 2 and 4 equals JAX ``tp.param_pspecs`` on the
  carried flax tree (each JAX leaf marked along its sharded axis and
  carried by ``utils/torch_compat.py``'s key and transpose rules); JAX's
  rule cases (``tests/test_sharding.py``: conv, convT, out-1 post,
  embedding, norm) and tp 1; no grouped conv is left whole for its groups.
* Against JAX: two ranks, data 1 × model 2, the fused step (B=4, dropout
  off) against the JAX package's fused step jitted on a data 1 × model 2
  mesh of the conftest's CPU devices with ``tp.shard_pytree``, on the same
  weights and draws (``tests/test_torch_accum.py``'s ``Setup``).
* Against one process: four ranks, data 2 × model 2, in the fused step, and
  with ``accum_steps`` 2, remat ``full`` and the spectral-norm D against one
  process's step over the same microbatches (``accum_steps`` 4 on the 4
  rows; the accumulated step rounds by microbatch size).
* The bounds are JAX's (``dryrun.compare_tp``): losses and ``grad_norm_*``
  within 2e-4, each rank's gradient slices within rtol 2e-4 / atol 2e-6 ×
  the network's largest gradient, parameters after the update within 3
  learning rates (``tests/test_sharding.py``), ``u``/``v`` within the
  gradients' bounds; replicated tensors bit-identical across each model
  group.  A tensor past JAX's bound is excused within 2e-2 of its largest
  value while its network's gradient stays within 1e-4 of its norm: the
  CPU's kernels round with the memory's alignment, so now and then a run
  (and even one rank of a model group) computes a spectrogram differently
  by rounding, and a leaky-ReLU pre-activation near zero can then take the
  other slope (measured: 1 of 13 runs of the tiny dry run, 1.32x JAX's
  bound on one tensor at 2.6e-5 of its largest value).
* Checkpoints: a model = 1 ``Trainer`` run is resumed by two ranks at model
  = 2 (their slices equal the checkpoint's, moments too), which train,
  save and resume bit for bit; a model = 1 ``Trainer`` resumes their
  checkpoint with equal parameters and moments, loads their ``G_latest.pth``
  strictly, and its ``evaluate()`` equals theirs.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch import nn

from personalized_text_to_speech_tpu.parallel import (
    batch_sharding,
    create_mesh as jax_create_mesh,
)
from personalized_text_to_speech_tpu.parallel import tp as jax_tp
from personalized_text_to_speech_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from personalized_text_to_speech_tpu.train.step import (
    Batch as JaxBatch,
    make_train_step as jax_make_train_step,
)
from personalized_text_to_speech_tpu_torch.config import (
    default_model_config,
    tiny_model_config,
)
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.models.discriminator import (
    MultiPeriodDiscriminator,
)
from personalized_text_to_speech_tpu_torch.models.layers import (
    LayerNorm,
    conv1d,
    conv_transpose1d,
)
from personalized_text_to_speech_tpu_torch.models.synthesizer import SynthesizerTrn
from personalized_text_to_speech_tpu_torch.parallel import dryrun, tp
from personalized_text_to_speech_tpu_torch.train.loop import Trainer
from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc
from tests.test_torch_accum import STEP_KEY, Setup

torch.set_num_threads(2)

# seconds a run of ranks may take before it is killed
RANK_LIMIT_S = 150


# --------------------------------------------------------------------------
# the decision
# --------------------------------------------------------------------------

def _carried_specs(params, tp_size):
    """JAX ``param_pspecs`` of a flax tree, carried to torch keys and dims:
    each leaf is marked with its index along its sharded axis (zeros where
    it is replicated), carried by ``flax_to_torch``, and the one torch dim
    the mark varies along is the sharded dim."""
    specs = jax_tp.param_pspecs(params, tp_size)
    flat, treedef = jax_tp._flatten_with_str_paths(params)
    marks = []
    for path, leaf in flat:
        shape = np.shape(leaf)
        axes = [i for i, a in enumerate(tuple(specs[path])) if a == "model"]
        mark = np.zeros(shape, np.float32)
        if axes:
            idx = [1] * len(shape)
            idx[axes[0]] = shape[axes[0]]
            mark = mark + np.arange(shape[axes[0]], dtype=np.float32).reshape(idx)
        marks.append(mark)
    carried = tc.flax_to_torch(jax.tree_util.tree_unflatten(treedef, marks))
    out = {}
    for key, t in carried.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1
                   and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
        assert len(varying) <= 1, key
        out[key] = varying[0] if varying else None
    return out


@pytest.fixture(scope="module")
def spec_setup():
    return Setup(spectral=False)


@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("net", ["g", "d"])
def test_param_specs_match_jax(spec_setup, net, tp_size):
    g_state, d_state = spec_setup.port_states()
    module = g_state.module if net == "g" else d_state.module
    params = spec_setup.g_params if net == "g" else spec_setup.d_vars["params"]
    want = _carried_specs(params, tp_size)
    got = tp.param_specs(module, tp_size)
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, diff
    assert any(d is not None for d in got.values())


class _Rules(nn.Module):
    """The cases of ``tests/test_sharding.py::TestTPSpecs`` in torch."""

    def __init__(self):
        super().__init__()
        self.conv = conv1d(4, 8, 3, weight_norm=True)  # g indexes out
        self.convT = conv_transpose1d(6, 8, 5, 1, 0)  # g indexes in
        self.post = conv1d(8, 1, 7)  # out 1: not divisible
        self.emb = nn.Embedding(10, 8)
        self.norm = LayerNorm(8)


@pytest.mark.parametrize("tp_size", [1, 2])
def test_spec_rules(tp_size):
    specs = tp.param_specs(_Rules(), tp_size)
    if tp_size == 1:
        assert all(d is None for d in specs.values())
        return
    assert specs == {
        "conv.bias": 0, "conv.weight_g": 0, "conv.weight_v": 0,
        "convT.bias": 0, "convT.weight_g": None, "convT.weight_v": 1,
        "post.weight": None, "post.bias": None,
        "emb.weight": 1, "norm.gamma": None, "norm.beta": None}


@pytest.mark.parametrize("tp_size", [2, 4])
def test_no_grouped_conv_stays_whole(spec_setup, tp_size):
    """Every grouped conv whose out size the tp size divides shards: none
    is kept whole for its groups (the scale discriminator's 4–256, the
    SDP's depthwise convs), at the tiny and at the full width."""
    g_state, d_state = spec_setup.port_states()
    for module in (g_state.module, d_state.module, *_full_width()):
        grouped = [m for m in module.modules()
                   if isinstance(m, nn.Conv1d) and m.groups > 1
                   and m.out_channels % tp_size == 0]
        assert all(m.groups % tp_size == 0 for m in grouped)
    assert any(m.groups > 1 for m in MultiPeriodDiscriminator().modules()
               if isinstance(m, nn.Conv1d))


def _full_width():
    """G and D at the production widths, shapes only (the meta device)."""
    with torch.device("meta"):
        return (SynthesizerTrn.from_hparams(default_model_config(n_speakers=8)),
                MultiPeriodDiscriminator())


@pytest.mark.parametrize("tp_size", [2, 4])
def test_full_width_shards_most_of_g(tp_size):
    """At the production widths at least 90 % of G's parameters shard, as
    ``dryrun_multichip`` asserts (``__graft_entry__.py:521-523``)."""
    sharded, total = tp.count_sharded(_full_width()[0], tp_size)
    assert sharded / total >= dryrun.MIN_SHARDED, (sharded, total)


# --------------------------------------------------------------------------
# the step on ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setups(spec_setup):
    return {False: spec_setup, True: Setup(spectral=True)}


def _job(setup, accum_steps=1, remat="none"):
    g_state, d_state = setup.port_states()
    job = dryrun.make_job(
        setup.p_hps, g_state.module.state_dict(), d_state.module.state_dict(),
        setup.arrays, setup.samples, g_kwargs=setup.kw,
        d_kwargs={"periods": (2, 3), "use_spectral_norm": setup.spectral},
        accum_steps=accum_steps, remat=remat)
    job["with_params"] = True
    return job


# case → (spectral, accum_steps, remat); the reference is one process over
# the same microbatches: accum_steps × the 2 data ranks
CASES = {"fused": (False, 1, "none"), "accum2_full_spectral": (True, 2, "full")}


def _case(setup, k, remat):
    ref = dryrun.run_step(_job(setup, accum_steps=2 * k if k > 1 else 1), "cpu")
    ranks = dryrun.spawn_ranks(_job(setup, k, remat), 4, "cpu", RANK_LIMIT_S,
                               model=2)
    return ref, ranks


@pytest.fixture(scope="module")
def background(setups, tmp_path_factory):
    """Every run, started at once in threads (each waits on its
    subprocesses); a test reads its result."""
    pool = ThreadPoolExecutor(max_workers=4)
    try:
        futures = {case: pool.submit(_case, setups[spectral], k, remat)
                   for case, (spectral, k, remat) in CASES.items()}
        futures["jax"] = pool.submit(dryrun.spawn_ranks, _job(setups[False]),
                                     2, "cpu", RANK_LIMIT_S, model=2)
        futures["trainer"] = pool.submit(_trainer_runs,
                                         tmp_path_factory.mktemp("tp_run"))
        yield futures
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


@pytest.fixture(scope="module")
def runs(background):
    return lambda case: background[case].result(timeout=4 * RANK_LIMIT_S)


def test_two_ranks_match_jax_tensor_parallel(setups, runs):
    """The JAX package's fused step, jitted on a data 1 × model 2 mesh with
    G and D sharded by ``tp.shard_pytree``, against the two port ranks
    (which run meanwhile)."""
    setup = setups[False]
    mesh = jax_create_mesh({"data": 1, "model": 2}, jax.devices()[:2])
    step = jax.jit(jax_make_train_step(setup.jm, setup.jd, setup.hps,
                                       debug_grads=True, deterministic=True))
    g_state = jax_tp.shard_pytree(jax_create_train_state(
        setup.jm.apply, setup.g_params, setup.hps, steps_per_epoch=4), mesh)
    d_state = jax_tp.shard_pytree(jax_create_train_state(
        setup.jd.apply, setup.d_vars["params"], setup.hps, steps_per_epoch=4),
        mesh)
    sharded = [leaf for leaf in jax.tree_util.tree_leaves(g_state.params)
               if not leaf.sharding.is_fully_replicated]
    assert sharded
    batch = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, batch_sharding(mesh)),
        JaxBatch(**setup.arrays))
    with mesh:
        g_new, d_new, metrics = step(g_state, d_state, batch,
                                     jax.random.PRNGKey(STEP_KEY))
    metrics = jax.device_get(metrics)
    ref = {
        "metrics": {n: float(v) for n, v in metrics.items()
                    if not n.startswith("_")},
        "grads_g": tc.flax_to_torch(metrics["_grads_g"]),
        "grads_d": tc.flax_to_torch(metrics["_grads_d"]),
        "params": {"g": tc.flax_to_torch(jax.device_get(g_new.params)),
                   "d": tc.flax_to_torch(jax.device_get(d_new.params))},
    }
    ranks = runs("jax")
    assert [r["mesh"] for r in ranks] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    report = dryrun.compare_tp(ref, ranks, forwards=1)
    assert report["sharded_g"] > 0.25


@pytest.mark.parametrize("case", list(CASES))
def test_four_ranks_match_one_process(runs, case):
    ref, ranks = runs(case)
    spectral, k, remat = CASES[case]
    assert [r["mesh"] for r in ranks] == [(2, 2, 0, 0), (2, 2, 0, 1),
                                          (2, 2, 1, 0), (2, 2, 1, 1)]
    assert [r["rows"] for r in ranks] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    forwards = 1 if k == 1 else 2 * k + k  # remat full: one more a graph
    report = dryrun.compare_tp(ref, ranks, forwards=forwards)
    # every rank's slices differ from its model-group peer's
    assert ranks[0]["grads_g"]["dec.conv_pre.weight"].shape[0] * 2 == \
        ref["grads_g"]["dec.conv_pre.weight"].shape[0]
    if spectral:
        u = "discriminators.1.convs.1.weight_u"
        assert ranks[0]["specs"]["d"][u] == 0
        assert ranks[0]["uv"][u].shape[0] * 2 == ref["uv"][u].shape[0]
        assert report["uv_excess"] > 0  # the estimates were compared
    else:
        assert ref["uv"] == {}


# --------------------------------------------------------------------------
# the Trainer: checkpoints across tp sizes, evaluate()
# --------------------------------------------------------------------------

def _trainer_hps(tmp: Path, model: int):
    sr = 8000
    listing = tmp / "train.txt"
    if not listing.exists():
        rng = np.random.default_rng(4)
        lines = []
        for i in range(8):
            n = int(sr * rng.uniform(0.5, 0.9))
            t = np.arange(n) / sr
            save_wav(str(tmp / f"w{i}.wav"),
                     0.4 * np.sin(2 * np.pi * rng.uniform(100, 250) * t), sr)
            lines.append(f"{tmp / f'w{i}.wav'}|{i % 2}|ab ko→ no↓ da to mi.")
        listing.write_text("\n".join(lines), encoding="utf-8")
    hps = tiny_model_config(n_speakers=4)
    hps.data.training_files = hps.data.validation_files = str(listing)
    hps.train.eval_interval = 1000
    hps.train.epochs = 3
    hps.tpu.mesh = {"data": -1, "model": model}
    return hps


def _noise(hps):
    gen = torch.Generator().manual_seed(5)
    return (torch.randn(1, max(hps.tpu.text_buckets), 2, generator=gen),
            torch.randn(1, max(hps.tpu.frame_buckets), hps.model.inter_channels,
                        generator=gen))


def _trainer_runs(tmp):
    """One epoch at model 1 in this process, then two ranks at model 2
    resume it for a second epoch and one step more; then model 1 resumes
    theirs and evaluates."""
    hps1 = _trainer_hps(tmp, 1)
    model_dir = tmp / "run"
    one = Trainer(hps1, str(model_dir), device="cpu")
    one.fit(1)
    first = {k: v.clone() for k, v in dryrun.whole_state(one).items()}
    dp_noise, prior_noise = _noise(hps1)
    job = {"hps": _trainer_hps(tmp, 2).to_dict(), "model_dir": str(model_dir),
           "epochs": 2, "extra_steps": 1, "dp_noise": dp_noise,
           "prior_noise": prior_noise}
    ranks = dryrun.spawn_ranks(job, 2, "cpu", RANK_LIMIT_S, task="trainer")
    back = Trainer(hps1, str(model_dir), device="cpu")
    back.resume()
    want = back.evaluate(dp_noise=dp_noise, prior_noise=prior_noise)
    return {"one_steps": one.global_step, "first": first, "ranks": ranks,
            "back": back, "last": dryrun.whole_state(back), "evaluate": want,
            "model_dir": model_dir, "hps": hps1}


@pytest.fixture(scope="module")
def trainer_run(runs):
    return runs("trainer")


def test_model1_checkpoint_resumes_at_model2(trainer_run):
    ranks = trainer_run["ranks"]
    assert [r["mesh"] for r in ranks] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    for rank in ranks:
        assert rank["resumed"]
        assert any(d is not None for d in rank["specs"]["g"].values())
        assert not dryrun.slices_differ(trainer_run["first"], rank,
                                        rank["start"])


def test_model2_checkpoint_resumes_at_model1(trainer_run):
    ranks = trainer_run["ranks"]
    back = trainer_run["back"]
    assert back.global_step == ranks[0]["steps"] > trainer_run["one_steps"]
    assert back.mesh.model == 1
    for rank in ranks:
        assert not dryrun.slices_differ(trainer_run["last"], rank, rank["end"])


def test_full_state_round_trip(trainer_run):
    """Save gathers the slices, a new model-2 Trainer's resume keeps them:
    bit for bit on both ranks; the exported ``G_latest.pth`` is the whole
    G and loads strictly into an unsharded model."""
    assert all(r["resume_held"] for r in trainer_run["ranks"])
    state, _ = tc.load_torch_checkpoint(
        str(trainer_run["model_dir"] / "G_latest.pth"))
    g = SynthesizerTrn.from_hparams(trainer_run["hps"])
    g.load_state_dict(state, strict=True)
    for k, v in trainer_run["back"].g_state.module.state_dict().items():
        assert torch.equal(state[k], v), k


def test_evaluate_under_tp_equals_unsharded(trainer_run):
    ranks = trainer_run["ranks"]
    assert ranks[1]["evaluate"] is None
    got, want = ranks[0]["evaluate"], trainer_run["evaluate"]
    for part_got, part_want in zip(got, want):
        assert set(part_got) == set(part_want)
        for k, v in part_want.items():
            assert np.array_equal(part_got[k].numpy(), np.asarray(v)), k


def _fake_runs(got_scale: float, spread: float):
    """One process's gradients and one model-2 rank's slices of them, the
    rank's first tensor off by ``got_scale`` of its largest value at one
    element and every element of the second tensor off by ``spread`` of
    its own value."""
    w = {"a": torch.linspace(-1.0, 1.0, 8).reshape(4, 2),
         "b": torch.full((4,), 20.0)}
    got = {"a": w["a"][:2].clone(), "b": w["b"][:2] * (1 + spread)}
    got["a"][0, 0] += got_scale
    specs = {"a": 0, "b": 0}
    ref = {"metrics": {"loss": 1.0}, "grads_g": w, "grads_d": w,
           "params": {"g": {}, "d": {}}, "uv": {}}
    rank = {"rank": 0, "mesh": (1, 2, 0, 0), "metrics": {"loss": 1.0},
            "grads_g": got, "grads_d": got, "specs": {"g": specs, "d": specs},
            "checksums": {}, "uv": {}, "params": None, "lr": 2e-4,
            "sharded_g": (1, 1), "mas_calls": 1, "mas_launches": 0,
            "mas_plain_equal": None, "memory": None, "step_ms": None,
            "allreduce_ms": None}
    return ref, [rank]


@pytest.mark.parametrize("got_scale,spread,ok", [
    (0.0, 0.0, True),  # equal
    (1e-3, 0.0, True),  # past JAX's bound by a slope flip's share: listed
    (5e-2, 0.0, False),  # past TP_KINK_TOL of the tensor's largest value
    (1e-3, 1e-3, False),  # the network's norm off by more than 1e-4
])
def test_compare_tp_excuses_only_slope_flips(got_scale, spread, ok):
    ref, ranks = _fake_runs(got_scale, spread)
    if not ok:
        with pytest.raises(AssertionError, match="gradient"):
            dryrun.compare_tp(ref, ranks, forwards=1)
        return
    report = dryrun.compare_tp(ref, ranks, forwards=1)
    assert [e["tensor"] for e in report["excused"]] == \
        (["g.a", "d.a"] if got_scale else [])
