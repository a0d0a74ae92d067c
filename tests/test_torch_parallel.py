"""Data parallelism in the port across processes, on the CPU over gloo.

Every rank runs in a process of its own, started from the test with a
wall-clock limit after which it is killed (``parallel.dryrun.spawn_ranks``;
ranks import no JAX), so no process group lives in the pytest worker.  The
multi-process runs start together in background threads when the first
step test asks for them, and the JAX step compiles meanwhile.

* ``BucketBatcher``'s rank shards against the JAX package's on the same
  filelist: the same batches per rank, the same length on every rank and
  the bucket order shared by all.
* 2 ranks × B=2 against the port's single-process fused step at B=4, the
  geometry and batch of ``tests/test_train_accum.py`` (6 tokens, 24 frames,
  periods 2 and 3, dropout off; the ranks' rows have unequal text and frame
  sums, so a mean of per-rank means would miss the duration and KL
  normalisers): fused, with ``accum_steps`` 2 per rank, and with the
  spectral-norm D.  Scalars within 1e-5 relative; D's gradients rtol 1e-4,
  atol 1e-6 × the largest, and G's within 1e-4 of each tensor's largest
  value (``tests/test_torch_accum.py``'s bounds for k against k=1: the
  same sums split at another batch size).  Every rank holds the same
  gradients, parameters after the update and ``u``/``v``, and the
  ``u``/``v`` of one process; MAS runs once a forward on each rank.
* The same 2-rank fused step against one jitted JAX step sharded over a
  2-device ``data`` mesh (the JAX package's own data-parallel path, on the
  conftest's CPU devices), with the draws of JAX's ``_sample``:
  ``tests/test_torch_train.py``'s bounds (1e-4 of each scalar and of each
  gradient tensor's largest value).
* The CLI under ``torch.distributed.run`` with 2 ranks on synthetic wavs:
  both ranks take ``len(batcher)`` steps, only rank 0 writes the run's
  files, and ``--cont`` resumes both.
* A mesh other than the world size raises; ``tpu.sp`` with a ``model``
  axis above 1 raises (ROADMAP.md, Queue 1, item 9); ranks whose gradients
  differ in their ``None`` pattern raise at once instead of waiting in a
  collective.
* Two run directories of one name in a process keep their own
  ``train.log`` (the logger was keyed by the basename, so a ``Trainer`` in
  a second ``run/`` wrote into the first's log).
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.data.dataset import (
    BucketBatcher as JaxBucketBatcher,
    DatasetConfig as JaxDatasetConfig,
    TextAudioSpeakerDataset as JaxDataset,
)
from personalized_text_to_speech_tpu.parallel import (
    create_mesh as jax_create_mesh,
    replicated,
    shard_batch,
)
from personalized_text_to_speech_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from personalized_text_to_speech_tpu.train.step import (
    Batch as JaxBatch,
    make_train_step as jax_make_train_step,
)
from personalized_text_to_speech_tpu_torch import parallel
from personalized_text_to_speech_tpu_torch.config import (
    save_hparams,
    tiny_model_config,
)
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.data.dataset import (
    BucketBatcher,
    DatasetConfig,
    TextAudioSpeakerDataset,
)
from personalized_text_to_speech_tpu_torch.parallel import dryrun
from personalized_text_to_speech_tpu_torch.train.loop import Trainer
from personalized_text_to_speech_tpu_torch.utils import logging_utils
from personalized_text_to_speech_tpu_torch.utils import torch_compat as tc
from tests.test_torch_accum import (
    B,
    JAX_GRAD_TOL,
    JAX_LOSS_TOL,
    STEP_KEY,
    Setup,
    assert_grads_close,
    assert_grads_match,
    assert_scalars_match,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
# seconds a rank, or a run of the CLI, may take before it is killed
RANK_LIMIT_S = 120
CLI_LIMIT_S = 180


# --------------------------------------------------------------------------
# the mesh, the rank and the batcher
# --------------------------------------------------------------------------

def test_no_group_is_rank_0_of_1():
    assert (parallel.rank(), parallel.world_size(), parallel.is_primary()) == \
        (0, 1, True)
    mesh = parallel.create_mesh({"data": -1})
    assert (mesh.data, mesh.model, mesh.data_index, mesh.model_index) == \
        (1, 1, 0, 0)
    assert parallel.create_mesh(None) == parallel.create_mesh({"data": 1})
    with pytest.raises(ValueError, match="world size"):
        parallel.create_mesh({"data": 2})


@pytest.mark.parametrize("axes,world", [
    ({"data": 2}, 1), ({"data": 1, "model": 2}, 1),
    ({"data": -1, "model": 2}, 1), ({"data": 2, "model": 2}, 2),
    ({"data": -1, "model": 3}, 4)])
def test_mesh_other_than_the_world_raises(axes, world):
    """data × model must be the world size: one process per device."""
    with pytest.raises(ValueError, match="world size"):
        parallel.mesh_shape(axes, world)


@pytest.mark.parametrize("axes,world,shape", [
    ({"data": -1, "model": 2}, 2, (1, 2)), ({"data": -1, "model": 2}, 4, (2, 2)),
    ({"data": 2, "model": -1}, 8, (2, 4)), ({"model": 4}, 4, (1, 4)),
    (None, 3, (3, 1))])
def test_mesh_fills_the_world(axes, world, shape):
    assert parallel.mesh_shape(axes, world) == shape


@pytest.mark.parametrize("axes", [{"data": -1, "model": 2},
                                  {"data": 1, "model": 2}])
def test_sp_with_model_axis_raises(axes, tmp_path):
    """Sequence parallelism over the model axis is the next slice."""
    hps = tiny_model_config()
    hps.tpu.mesh = axes
    hps.tpu.sp = True
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, Queue 1, item 9"):
        Trainer(hps, str(tmp_path / "run"), device="cpu")


@pytest.fixture(scope="module")
def filelist(tmp_path_factory):
    """41 files whose sizes (the batcher reads lengths from them) spread
    over four buckets, and texts of every length class."""
    tmp = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(7)
    lines = []
    for i in range(41):
        frames = int(rng.choice([rng.integers(40, 300), rng.integers(301, 400),
                                 rng.integers(401, 500), rng.integers(601, 700)]))
        path = tmp / f"f{i}.wav"
        path.write_bytes(b"\0" * (2 * 256 * frames))
        lines.append(f"{path}|{i % 3}|{'ab ' * int(rng.integers(1, 40))}")
    out = tmp / "list.txt"
    out.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(out)


@pytest.mark.parametrize("shards,epoch", [(2, 0), (2, 1), (3, 0), (3, 1)])
def test_bucket_batcher_shards_match_jax(filelist, shards, epoch):
    symbols = tiny_model_config().symbols
    port_ds = TextAudioSpeakerDataset(filelist, DatasetConfig(), symbols, seed=3)
    jax_ds = JaxDataset(filelist, JaxDatasetConfig(), symbols, seed=3)
    assert port_ds.lengths == jax_ds.lengths and len(port_ds) == 41
    per_rank = []
    for r in range(shards):
        port = BucketBatcher(port_ds, 4, shard_index=r, shard_count=shards,
                             seed=11)
        ref = JaxBucketBatcher(jax_ds, 4, shard_index=r, shard_count=shards,
                               seed=11)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = port.batch_indices()
        assert got == ref.batch_indices()
        assert len(port) == len(ref) == len(got)
        per_rank.append(got)
    # every rank: as many batches, the buckets in one order
    assert len({len(b) for b in per_rank}) == 1
    assert len({tuple(bi for bi, _ in b) for b in per_rank}) == 1
    assert len(port.buckets) == 4
    seen = {i for b in per_rank for _, ids in b for i in ids}
    assert seen == set(range(41))


def test_shard_index_outside_count_raises(filelist):
    ds = TextAudioSpeakerDataset(filelist, DatasetConfig(),
                                 tiny_model_config().symbols)
    with pytest.raises(ValueError, match="shard_index"):
        BucketBatcher(ds, 4, shard_index=2, shard_count=2)


# --------------------------------------------------------------------------
# the data-parallel step against one process
# --------------------------------------------------------------------------

CASES = {"fused": (False, 1), "accum2": (False, 2), "spectral": (True, 1)}


@pytest.fixture(scope="module")
def setups():
    return {spectral: Setup(spectral=spectral) for spectral in (False, True)}


def _job(setup, accum_steps=1):
    g_state, d_state = setup.port_states()
    return dryrun.make_job(
        setup.p_hps, g_state.module.state_dict(), d_state.module.state_dict(),
        setup.arrays, setup.samples, g_kwargs=setup.kw,
        d_kwargs={"periods": (2, 3), "use_spectral_norm": setup.spectral},
        accum_steps=accum_steps)


def _run_case(setup, k):
    """A case's single-process fused step at B=4 and its 2-rank step."""
    ref = dryrun.run_step(_job(setup), "cpu")
    ranks = dryrun.spawn_ranks(_job(setup, k), WORLD, "cpu", RANK_LIMIT_S)
    return setup, ref, ranks


@pytest.fixture(scope="module")
def background(setups, tmp_path_factory):
    """Every case's runs and the CLI's two runs, started at once in two
    threads (each waits on its subprocesses); a test reads its result."""
    pool = ThreadPoolExecutor(max_workers=2)
    cli_dir = tmp_path_factory.mktemp("dp_cli")
    try:
        futures = {case: pool.submit(_run_case, setups[spectral], k)
                   for case, (spectral, k) in CASES.items()}
        futures["cli"] = pool.submit(_cli_runs, cli_dir)
        yield futures
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


@pytest.fixture(scope="module")
def runs(background):
    return lambda case: background[case].result(timeout=4 * RANK_LIMIT_S)


def test_two_ranks_match_jax_data_parallel(setups, runs):
    """The JAX package's fused step, jitted, on a 2-device ``data`` mesh with
    the batch sharded and the states replicated, against the 2-rank port
    (whose ranks run meanwhile)."""
    setup = setups[False]
    mesh = jax_create_mesh({"data": WORLD}, jax.devices()[:WORLD])
    step = jax.jit(jax_make_train_step(setup.jm, setup.jd, setup.hps,
                                       debug_grads=True, deterministic=True))
    g_state = jax.device_put(jax_create_train_state(
        setup.jm.apply, setup.g_params, setup.hps, steps_per_epoch=4),
        replicated(mesh))
    d_state = jax.device_put(jax_create_train_state(
        setup.jd.apply, setup.d_vars["params"], setup.hps, steps_per_epoch=4),
        replicated(mesh))
    batch = shard_batch(JaxBatch(**setup.arrays), mesh)
    assert len(batch.wav.sharding.device_set) == WORLD
    with mesh:
        _, _, metrics = step(g_state, d_state, batch,
                             jax.random.PRNGKey(STEP_KEY))
    metrics = jax.device_get(metrics)
    want = {n: float(v) for n, v in metrics.items() if not n.startswith("_")}
    _, _, ranks = runs("fused")
    for res in ranks:
        assert_scalars_match(want, res["metrics"], tol=JAX_LOSS_TOL,
                             floor=1e-3)
        for net in ("g", "d"):
            assert_grads_close(tc.flax_to_torch(metrics[f"_grads_{net}"]),
                               res[f"grads_{net}"], tol=JAX_GRAD_TOL)


def test_ranks_hold_unequal_normalisers(setups):
    """The two ranks' rows differ in Σ text lengths and Σ frames, so the
    normalisers matter."""
    a = setups[False].arrays
    half = B // WORLD
    assert a["text_lengths"][:half].sum() != a["text_lengths"][half:].sum()
    assert a["wav_lengths"][:half].sum() != a["wav_lengths"][half:].sum()


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process(runs, case):
    setup, ref, ranks = runs(case)
    k = CASES[case][1]
    report = dryrun.compare(ref, ranks, forwards=1 if k == 1 else 2 * k)
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 4)]
    for res in ranks:
        assert_scalars_match(ref["metrics"], res["metrics"])
        assert_grads_match(ref["grads_d"], res["grads_d"])
        assert_grads_close(ref["grads_g"], res["grads_g"])
    if setup.spectral:
        assert len(ref["uv"]) == 2 * 19
        for n, v in ref["uv"].items():
            assert torch.equal(ranks[0]["uv"][n], v), n
        # and the estimates moved in the step
        d0 = setup.port_states()[1].module
        moved = sum(not torch.equal(b, ranks[0]["uv"][n])
                    for n, b in d0.named_buffers())
        assert moved >= 2 * 19 - 3
    else:
        assert ref["uv"] == {} and report["uv_rel_err"] == 0.0


def test_nccl_needs_a_card_a_rank(setups):
    with pytest.raises(ValueError, match="a card a rank"):
        dryrun.spawn_ranks(_job(setups[False]), WORLD, "cpu", backend="nccl")


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        dryrun.main(["--nproc", "2"])


def test_dryrun_full_width_splits_the_train_batch():
    """At full width the ranks split the train step's 16 rows."""
    with pytest.raises(ValueError, match="16 rows"):
        dryrun.synthetic_job(full_width=True, nproc=3)
    with pytest.raises(ValueError, match="16 rows"):
        dryrun.synthetic_job(full_width=True, nproc=2, per_rank=2)


# --------------------------------------------------------------------------
# collectives that would never meet
# --------------------------------------------------------------------------

_GRAD_PATTERN_SCRIPT = """
import sys, torch
from personalized_text_to_speech_tpu_torch import parallel
from personalized_text_to_speech_tpu_torch.parallel import mesh
from personalized_text_to_speech_tpu_torch.utils import runtime
mesh.BUCKET_BYTES = 40  # buckets smaller than a tensor
rank, port, drop = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
torch.set_num_threads(1)
runtime.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                         timeout_s=60)
torch.manual_seed(0)
net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
(net(torch.ones(1, 3)) * (rank + 1)).sum().backward()
if drop and rank == 1:
    net[0].bias.grad = None
try:
    parallel.allreduce_grads(net)
except RuntimeError as e:
    print("raised:", e, flush=True)
    # a group left to the interpreter's exit aborts now and then
    torch.distributed.destroy_process_group()
    sys.exit(3)
# the sum of rank 0's gradient and twice it
torch.manual_seed(0)
ref = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
(ref(torch.ones(1, 3)) * 3).sum().backward()
for a, b in zip(net.parameters(), ref.parameters()):
    assert torch.allclose(a.grad, b.grad, rtol=1e-6, atol=0), (a.grad, b.grad)
# again through the module's kept buffers, then with one None more on both
# ranks (new buffers): the sums double, the None stays None
parallel.allreduce_grads(net)
net[1].weight.grad = None
parallel.allreduce_grads(net)
for (n, a), b in zip(net.named_parameters(), ref.parameters()):
    if n == "1.weight":
        assert a.grad is None
    else:
        assert torch.allclose(a.grad, 4 * b.grad, rtol=1e-6, atol=0), n
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("drop", [False, True], ids=["same", "one_none"])
def test_allreduce_grads_sums_or_raises(drop):
    """The same pattern: the gradients are summed (in buckets smaller than
    a tensor), again through the kept buffers and again after the pattern
    changed on both ranks; one ``None`` more on rank 1: both ranks raise
    well inside the group's 60 s timeout."""
    port = dryrun.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GRAD_PATTERN_SCRIPT, str(r), str(port),
         "1" if drop else "0"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=40)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if drop:
        assert codes == [3, 3], outs
        assert all("None pattern" in o for o in outs), outs
    else:
        assert codes == [0, 0], outs


# --------------------------------------------------------------------------
# the Trainer through the CLI under torch.distributed.run
# --------------------------------------------------------------------------

def _run_cli(config, model_dir, epochs, cont=False):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD),
           "-m", "personalized_text_to_speech_tpu_torch.train",
           "-c", str(config), "-m", str(model_dir), "-n", str(epochs),
           "--device", "cpu"]
    if cont:
        cmd += ["--cont", "true"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=CLI_LIMIT_S,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _cli_runs(tmp):
    """Two ranks of the CLI for one epoch, then ``--cont`` for a second."""
    sr = 8000
    rng = np.random.default_rng(4)
    lines = []
    for i in range(8):
        n = int(sr * rng.uniform(0.5, 0.9))
        t = np.arange(n) / sr
        save_wav(str(tmp / f"w{i}.wav"),
                 0.4 * np.sin(2 * np.pi * rng.uniform(100, 250) * t), sr)
        lines.append(f"{tmp / f'w{i}.wav'}|{i % 2}|ab ko→ no↓ da to mi.")
    (tmp / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    hps = tiny_model_config(n_speakers=4)
    hps.data.training_files = hps.data.validation_files = str(tmp / "train.txt")
    hps.train.eval_interval = 10
    hps.train.epochs = 2
    config = tmp / "config.json"
    save_hparams(hps, str(config))
    model_dir = tmp / "run"
    first = _run_cli(config, model_dir, epochs=1)
    files = sorted(str(p.relative_to(model_dir)) for p in model_dir.rglob("*"))
    log_first = (model_dir / "train.log").read_text()
    second = _run_cli(config, model_dir, epochs=2, cont=True)
    return hps, model_dir, first, files, log_first, second


@pytest.fixture(scope="module")
def cli_run(background):
    return background["cli"].result(timeout=3 * CLI_LIMIT_S)


def test_run_dirs_of_one_name_keep_their_logs(tmp_path):
    dirs = [tmp_path / "a" / "run", tmp_path / "b" / "run"]
    loggers = [logging_utils.get_logger(str(d)) for d in dirs]
    try:
        for d, logger in zip(dirs, loggers):
            logger.info("line of %s", d.parent.name)
        for d in dirs:
            lines = (d / "train.log").read_text().splitlines()
            assert len(lines) == 1 and lines[0].endswith(
                f"\trun\tINFO\tline of {d.parent.name}"), lines
    finally:
        for logger in loggers:
            for h in list(logger.handlers):
                logger.removeHandler(h)
                h.close()


def test_cli_two_ranks_take_every_batch(cli_run):
    hps, _, first, files, _, _ = cli_run
    ds = TextAudioSpeakerDataset(hps.data.training_files,
                                 DatasetConfig.from_hparams(hps), hps.symbols)
    steps = len(BucketBatcher(ds, hps.train.batch_size, shard_index=0,
                              shard_count=WORLD))
    assert steps == 2
    for r in range(WORLD):
        assert f"rank {r} of {WORLD}: training done at step {steps}" in first


def test_cli_only_rank_0_writes(cli_run):
    _, model_dir, first, files, log_first, _ = cli_run
    assert {"config.json", "train.log", "githash", "G_latest.pth",
            "D_latest.pth", "eval", "checkpoints"} <= set(files)
    # one TensorBoard writer in the run directory and one under eval/
    events = [f for f in files if "tfevents" in f]
    assert len([f for f in events if f.startswith("eval/")]) == 1
    assert len([f for f in events if "/" not in f]) == 1
    assert any(f.startswith("eval/") for f in files)
    # rank 0's step lines are in the file, and no line twice
    steps = [ln for ln in log_first.splitlines() if "loss_g=" in ln]
    assert len(steps) == 2
    assert json.loads((model_dir / "config.json").read_text())["train"][
        "eval_interval"] == 10


def test_cli_cont_resumes_both_ranks(cli_run):
    _, model_dir, _, _, _, second = cli_run
    for r in range(WORLD):
        assert f"rank {r} of {WORLD}: training done at step 4" in second
    # every rank resumed, but only rank 0 wrote it to train.log
    assert second.count("resumed at step 2 (epoch 2)") == WORLD
    log = (model_dir / "train.log").read_text()
    assert log.count("resumed at step 2 (epoch 2)") == 1
