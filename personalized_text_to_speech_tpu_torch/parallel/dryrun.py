"""Data- and tensor-parallel dry run: one GAN train step on n ranks against
one process's step on the global batch.

    python -m personalized_text_to_speech_tpu_torch.parallel.dryrun \\
        --nproc 2 [--model M] --device cpu|cuda [--full-width] \\
        [--backend gloo|nccl]

Counterpart of the data-parallel and ``tp`` stages of
``__graft_entry__.py::dryrun_multichip``.  The ranks form a mesh of data
``nproc / M`` × model ``M`` (:func:`~.mesh.create_mesh`; ``--model`` 1, the
default, is data parallelism alone).  The parent draws the weights, a
global batch with unequal text and frame lengths, and the step's draws, all
from seeds (``--full-width``: the production widths of
``config.default_model_config`` at the train step's geometry, 16 rows of
400 frames and up to 192 tokens, 16 / data rows a data rank; else the tiny
test geometry, 2 rows a data rank); it runs one process's fused step on the
whole batch (modules in ``eval()``, dropout off, no group), then spawns
``nproc`` ranks on 127.0.0.1 over gloo (the default; it also takes CUDA
tensors, so two ranks may share one card, which NCCL refuses) or over NCCL
(``--backend nccl``: one card a rank).  Each rank takes its data index's
rows and their draws, shards G and D over its model group
(:mod:`.tp`), runs the step in the group (:mod:`..train.step`) and writes
its losses, gradients (its slices), a checksum of every parameter after the
update, its ``u``/``v`` and its MAS calls, and on the card times
``allreduce_grads`` of G and of D after the step.

Data parallelism alone: the run fails unless every loss is within
:data:`LOSS_TOL` of the single process's, each network's gradient within
:data:`GRAD_TOL` of its norm, and every rank holds the same gradients, the
same parameters and the same ``u``/``v``.  With a model axis the bounds are
JAX's (``tests/test_sharding.py``, ``dryrun_multichip``'s ``tp`` stage): every
loss and ``grad_norm_*`` within :data:`TP_LOSS_TOL` (relative and absolute),
each rank's gradient slices within rtol :data:`TP_RTOL` and atol
:data:`TP_ATOL` × the network's largest gradient (at least 1) of the same
slices of the single process's, its parameters after the update within 3 ×
the learning rate, its ``u``/``v`` within the gradients' bounds; every
replicated parameter bit-identical across each model group, and every
tensor across the ranks of one model index (the report also says whether a
model group's losses came out bit for bit alike, as its ranks compute
their replicated activations alike); at full width at least
:data:`MIN_SHARDED` of G's parameters sharded.  A gradient tensor past
JAX's bound is excused, and listed, within :data:`TP_KINK_TOL` of its own
largest value while its network's gradient stays within
:data:`TP_NORM_TOL` of its norm: the layouts round differently (so do the
CPU's kernels with the memory's alignment, even across the ranks of one
model group), and a leaky-ReLU pre-activation within rounding distance of
zero then takes the other slope, which no bound on rounding holds (at full
width on the card JAX's bound failed by 1.42x on one tensor, and held
everywhere with the slopes smoothed: PERF.md, PR 10).  Either way each rank must run
MAS once a forward (on the card each call's path must equal the plain
MAS's on its scores, checked on the rank that made it).  Every process
computes in fp32 with TF32 off.  On the card each rank also reports its
resident memory after the step, its peak during it, and the median of
:data:`TIMED_STEPS` more steps.  Each stage prints one OK line with its
wall-clock time and budget; a rank past its budget is killed and the run
fails.  The last line is a JSON object with the errors and each rank's MAS
launches.  No sequence-parallel stage: the port has none yet (ROADMAP.md,
Queue 1, item 9).

:func:`run_step`, :func:`run_trainer`, :func:`spawn_ranks`, :func:`compare`
and :func:`compare_tp` are the pieces the tests and ``chip_smoke.py`` use
with their own batches and bounds.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from personalized_text_to_speech_tpu_torch import parallel

# every loss within this share of the single process's (floor 1e-3), and
# each network's gradient within this share of its L2 norm: the same fp32
# sums split at another batch size (phase 14's bounds for accumulation)
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
# tensor parallelism, JAX's bounds (tests/test_sharding.py): losses and
# gradient norms rtol = atol = TP_LOSS_TOL; gradients rtol TP_RTOL, atol
# TP_ATOL × max(the network's largest gradient, 1); parameters after one
# AdamW update within TP_PARAM_LRS learning rates (a gradient at rounding
# level may take the other sign, and AdamW's first step is ±lr)
TP_LOSS_TOL = 2e-4
TP_RTOL, TP_ATOL = 2e-4, 2e-6
TP_PARAM_LRS = 3
# a tensor past the bound is excused if it is within TP_KINK_TOL of its
# own largest value and its network's gradient within TP_NORM_TOL of its
# norm: a leaky-ReLU (or ReLU) pre-activation within rounding distance of
# zero takes the other slope in the other layout, and every gradient
# upstream moves by that position's share (PERF.md, PR 10; chip_smoke.py's
# TRAIN_GRAD_TOL for card against CPU)
TP_KINK_TOL = 2e-2
TP_NORM_TOL = 1e-4
# the share of G's parameters a full-width model axis must shard
MIN_SHARDED = 0.90
# steps the dry run times on the card after the checked one
TIMED_STEPS = 3
# seconds the ranks of a dry run may take before they are killed
BUDGET_S = 300.0
# torch threads per rank
RANK_THREADS = 2
# the package's parent: the directory a rank's `python -m` runs from
_ROOT = Path(__file__).resolve().parents[2]
_MODULE = "personalized_text_to_speech_tpu_torch.parallel.dryrun"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_job(hps, g_state: dict, d_state: dict, batch: Dict[str, np.ndarray],
             samples, g_kwargs: Optional[dict] = None,
             d_kwargs: Optional[dict] = None, accum_steps: int = 1,
             remat: str = "none") -> dict:
    """What every process of a dry run needs, as tensors and plain values
    (``torch.load(weights_only=True)`` reads it back): the config, the
    modules' constructor arguments (G's from the config unless
    ``g_kwargs`` gives them all) and weights, the global batch and the
    step's global draws (:class:`~..train.step.Samples`)."""
    return {
        "hps": hps.to_dict(),
        "g_kwargs": dict(g_kwargs or {}),
        "d_kwargs": dict(d_kwargs or {}),
        "g_state": {k: v.detach().cpu() for k, v in g_state.items()},
        "d_state": {k: v.detach().cpu() for k, v in d_state.items()},
        "batch": {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        "samples": [None if t is None else t.detach().cpu() for t in samples],
        "accum_steps": int(accum_steps),
        "remat": remat,
    }


def _checksum(t: torch.Tensor) -> str:
    raw = t.detach().cpu().contiguous().view(-1).view(torch.uint8)
    return hashlib.sha1(raw.numpy().tobytes()).hexdigest()


def _checksums(trainer) -> Dict[str, str]:
    return {k: _checksum(v) for k, v in whole_state(trainer).items()}


@contextlib.contextmanager
def _mas_spy():
    """Every MAS call of the generator forwards within the block, appended
    to the list it yields: on the card, once the block is over, whether its
    path equals the plain MAS's on its scores (kept until then, so the plain
    MAS stays off a timed step's clock); on the CPU ``None``."""
    from personalized_text_to_speech_tpu_torch.models import synthesizer
    from personalized_text_to_speech_tpu_torch.ops import mas

    calls, kept = [], []
    real = synthesizer.maximum_path

    def spy(neg_cent, x_len, y_len):
        path = real(neg_cent, x_len, y_len)
        if path.is_cuda:
            kept.append((len(calls), neg_cent.detach().float().clone(),
                         x_len.clone(), y_len.clone(), path.clone()))
        calls.append(None)
        return path

    synthesizer.maximum_path = spy
    try:
        yield calls
    finally:
        synthesizer.maximum_path = real
    for i, scores, x_len, y_len, path in kept:
        calls[i] = bool(torch.equal(
            path, mas.maximum_path_plain(scores, x_len, y_len)))


def _state_bytes(states) -> int:
    """Bytes of the parameters, gradients and AdamW moments of ``states``
    (counted from the tensors, not measured)."""
    total = 0
    for state in states:
        for p in state.module.parameters():
            total += p.numel() * p.element_size() * (2 if p.grad is not None
                                                     else 1)
        for entry in state.optimizer.state.values():
            total += sum(v.numel() * v.element_size() for v in entry.values()
                         if torch.is_tensor(v) and v.dim() > 0)
    return total


def run_step(job: dict, device: str, model: int = 1) -> dict:
    """One train step of ``job`` on ``device`` (modules in ``eval()``) on
    this process's rows: the whole batch without a process group, else
    its data index's share of it, with G and D sharded over a model axis of
    ``model``; on the card then ``job["timed_steps"]`` more steps on the
    same batch.  Returns, from the checked step, the metrics, the gradients
    (CPU; this rank's slices), a checksum of every parameter and buffer
    after the update, the ``u``/``v`` buffers and, with
    ``job["with_params"]``, the parameters; the state's sharded dims and
    the MAS calls of all the steps; on the card its memory beyond what the
    process held before the call (after the modules and states are built,
    at the step's peak, after the step; and the state's bytes counted from
    its tensors) and the median of the timed steps; on the card in a
    group, also the median time of ``allreduce_grads`` over the data group
    of G and of D and of its gradient-pattern check alone (``g_check``,
    ``d_check``), and with a model axis of the replicated gradients' sync
    over the model group (``g_replicated_sync``) and of a broadcast of the
    same gradients from model index 0 in its place
    (``g_replicated_broadcast``), by CUDA
    events (10 calls after 2; they change the gradients, so they run after
    the gradients are copied out)."""
    from personalized_text_to_speech_tpu_torch.config import (
        load_hparams_from_dict,
    )
    from personalized_text_to_speech_tpu_torch.models.discriminator import (
        MultiPeriodDiscriminator,
    )
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        SynthesizerTrn,
    )
    from personalized_text_to_speech_tpu_torch.ops import mas
    from personalized_text_to_speech_tpu_torch.parallel import tp
    from personalized_text_to_speech_tpu_torch.train.state import (
        create_train_state,
    )
    from personalized_text_to_speech_tpu_torch.train.step import (
        Batch,
        Samples,
        make_train_step,
    )

    on_card = torch.device(device).type == "cuda"
    if on_card:  # what the process held before: not this step's
        base = torch.cuda.memory_allocated(device)
    hps = load_hparams_from_dict(job["hps"])
    g = (SynthesizerTrn(**job["g_kwargs"]) if job["g_kwargs"]
         else SynthesizerTrn.from_hparams(hps))
    d = MultiPeriodDiscriminator(**job["d_kwargs"])
    g.load_state_dict(job["g_state"], strict=True)
    d.load_state_dict(job["d_state"], strict=True)
    g.to(device).eval()
    d.to(device).eval()
    mesh = parallel.create_mesh({"data": -1, "model": model})
    parallel.broadcast_module(g)
    parallel.broadcast_module(d)
    specs = {"g": tp.state_specs(g, model), "d": tp.state_specs(d, model)}
    sharded_g = tp.count_sharded(g, model)
    tp.shard_module(g, mesh)
    tp.shard_module(d, mesh)
    g_state = create_train_state(g, hps, steps_per_epoch=4)
    d_state = create_train_state(d, hps, steps_per_epoch=4)

    b = job["batch"]["wav"].shape[0]
    if b % mesh.data:
        raise ValueError(f"batch {b} not divisible by {mesh.data} data ranks")
    per = b // mesh.data
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    arrays = {k: v[rows].numpy() for k, v in job["batch"].items()}
    batch = Batch.from_numpy(arrays, device)
    samples = Samples(*(None if t is None else t[rows].to(device)
                        for t in job["samples"]))
    step = make_train_step(hps, debug_grads=True,
                           accum_steps=job["accum_steps"], remat=job["remat"],
                           mesh=mesh)

    launches = mas.maximum_path_cuda.launches
    memory = None
    timed = job.get("timed_steps", 0) if on_card else 0
    times = []
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    with _mas_spy() as calls:
        m = step(g_state, d_state, batch, samples=samples)
        if on_card:
            torch.cuda.synchronize(device)
            mib = 2.0**20
            memory = {
                "before_step_mib": (before - base) / mib,
                "peak_mib": (torch.cuda.max_memory_allocated(device) - base)
                / mib,
                "after_step_mib": (torch.cuda.memory_allocated(device) - base)
                / mib,
                "state_mib": _state_bytes((g_state, d_state)) / mib}
        # what the checked step left, before any timed step
        result = {
            "metrics": {n: float(v) for n, v in m.items()
                        if not n.startswith("_")},
            "grads_g": {n: None if v is None else v.detach().cpu()
                        for n, v in m["_grads_g"].items()},
            "grads_d": {n: None if v is None else v.detach().cpu()
                        for n, v in m["_grads_d"].items()},
            "checksums": {f"{net}.{k}": _checksum(v)
                          for net, mod in (("g", g), ("d", d))
                          for k, v in mod.state_dict().items()},
            "uv": {n: t.detach().cpu() for n, t in d.named_buffers()
                   if n.endswith(("weight_u", "weight_v"))},
            "params": ({net: {k: v.detach().cpu()
                              for k, v in mod.state_dict().items()}
                        for net, mod in (("g", g), ("d", d))}
                       if job.get("with_params") else None)}
        del m
        for _ in range(timed):  # on the same batch
            t0 = time.perf_counter()
            step(g_state, d_state, batch, samples=samples)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)

    result.update({
        "rank": parallel.rank(), "world": parallel.world_size(),
        "mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index),
        "rows": (rows.start, rows.stop),
        "specs": specs, "sharded_g": sharded_g,
        "lr": float(hps.train.learning_rate),
        "mas_calls": len(calls),
        "mas_launches": mas.maximum_path_cuda.launches - launches,
        "mas_plain_equal": None if None in calls else all(calls),
        "memory": memory, "allreduce_ms": None,
        "step_ms": sorted(times)[len(times) // 2] if times else None,
    })
    if torch.distributed.is_initialized() and on_card:
        from personalized_text_to_speech_tpu_torch.parallel import mesh as mesh_mod

        result["allreduce_ms"] = {}
        for net, mod in (("g", g), ("d", d)):
            if mesh.model == 1 or mesh.data > 1:  # the data group's sum
                result["allreduce_ms"][net] = _cuda_median_ms(
                    lambda: parallel.allreduce_grads(mod, mesh.data_group))
                result["allreduce_ms"][f"{net}_check"] = _cuda_median_ms(
                    lambda: mesh_mod._check_grad_pattern(
                        [p.grad for p in mod.parameters()],
                        torch.device(device), mesh.data_group))
            if mesh.model > 1:
                # the broadcast the step takes, and the all-reduce it could
                # take instead (then averaged) on the same gradients
                result["allreduce_ms"][f"{net}_replicated_sync"] = \
                    _cuda_median_ms(lambda: tp.sync_replicated_grads(mod, mesh))
                sharded = tp.sharded_names(mod)
                rep = [p.grad for n, p in mod.named_parameters()
                       if n not in sharded and p.grad is not None]
                result["allreduce_ms"][f"{net}_replicated_broadcast"] = \
                    _cuda_median_ms(lambda: parallel.mesh._bucketed(
                        rep, lambda t: torch.distributed.broadcast(
                            t, mesh.model_root, group=mesh.model_group)))
    return result


def whole_state(trainer) -> Dict[str, torch.Tensor]:
    """Each tensor of the Trainer's two states as this process holds it:
    the parameters and buffers (``g.<key>``), and AdamW's moments by their
    parameter's name (``g.opt.<name>.exp_avg``)."""
    out = {}
    for net, state in (("g", trainer.g_state), ("d", trainer.d_state)):
        out.update({f"{net}.{k}": v.detach()
                    for k, v in state.module.state_dict().items()})
        for name, p in state.module.named_parameters():
            for k, v in state.optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and v.dim() > 0:
                    out[f"{net}.opt.{name}.{k}"] = v.detach()
    return out


def slices_differ(whole: Dict[str, torch.Tensor], rank: dict,
                  checksums: Dict[str, str]) -> List[str]:
    """The keys of an unsharded :func:`whole_state` whose slice for the
    :func:`run_trainer` result ``rank`` differs from that rank's checksum
    (or that one side lacks)."""
    _, model, _, index = rank["mesh"]
    bad = sorted(set(whole) ^ set(checksums))
    for key, t in whole.items():
        if key not in checksums:
            continue
        net, rest = key.split(".", 1)
        name = (rest.split(".", 1)[1].rsplit(".", 1)[0]
                if rest.startswith("opt.") else rest)
        if _checksum(_slice(t, rank["specs"][net][name], model, index)) \
                != checksums[key]:
            bad.append(key)
    return bad


def run_trainer(job: dict, device: str) -> dict:
    """A :class:`~..train.loop.Trainer` of ``job["hps"]`` (its ``tpu.mesh``
    over this group) in ``job["model_dir"]``: ``resume`` (a checkpoint of
    any tp size), ``fit`` for ``job["epochs"]``, ``job["extra_steps"]``
    more steps, ``save`` and ``export_reference_checkpoint``; then a new
    Trainer resumes the checkpoint and must hold this rank's state bit for
    bit, and ``evaluate()`` runs with the injected ``job["dp_noise"]`` and
    ``job["prior_noise"]``.  Returns this rank's mesh and checksums at the
    start (after the resume) and at the end, the state's sharded dims,
    whether the resume held, the evaluation (rank 0), the MAS calls, and
    the step count after the fit and at the end."""
    from personalized_text_to_speech_tpu_torch.config import (
        load_hparams_from_dict,
    )
    from personalized_text_to_speech_tpu_torch.ops import mas
    from personalized_text_to_speech_tpu_torch.train.loop import Trainer

    hps = load_hparams_from_dict(job["hps"])
    launches = mas.maximum_path_cuda.launches
    with _mas_spy() as calls:
        trainer = Trainer(hps, job["model_dir"], device=device)
        resumed = trainer.resume()
        start = _checksums(trainer)
        trainer.fit(job["epochs"])
        fit_steps = trainer.global_step
        batches = list(trainer.batcher)
        for i in range(job["extra_steps"]):
            trainer.train_step(batches[i % len(batches)])
        trainer.save()
        trainer.export_reference_checkpoint()
    end = _checksums(trainer)
    again = Trainer(hps, job["model_dir"], device=device)
    again.resume()
    held = _checksums(again) == end and \
        again.global_step == trainer.global_step
    del again
    out = trainer.evaluate(dp_noise=job["dp_noise"],
                           prior_noise=job["prior_noise"])
    if out is not None:  # numpy → tensors, which torch.load(weights_only) reads
        out = [{k: torch.from_numpy(np.asarray(v)) for k, v in part.items()}
               for part in out]
    mesh = trainer.mesh
    return {
        "rank": trainer.rank,
        "mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index),
        "resumed": resumed, "start": start, "end": end, "resume_held": held,
        "specs": {net: dict(getattr(state.module, "_tp_specs", {}))
                  for net, state in (("g", trainer.g_state),
                                     ("d", trainer.d_state))},
        "fit_steps": fit_steps, "steps": trainer.global_step,
        "evaluate": out,
        "mas_calls": len(calls),
        "mas_launches": mas.maximum_path_cuda.launches - launches,
        "mas_plain_equal": None if None in calls else all(calls),
    }


def _cuda_median_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def spawn_ranks(job: dict, nproc: int, device: str,
                budget_s: float = BUDGET_S, backend: str = "gloo",
                model: int = 1, task: str = "step") -> List[dict]:
    """Run :func:`run_step` (``task="step"``, on a model axis of ``model``)
    or :func:`run_trainer` (``task="trainer"``) in a group of ``nproc``
    fresh processes over ``backend``, each on ``device`` (``cuda`` ranks
    take the cards round robin; NCCL needs a card a rank); returns their
    results by rank.  Every rank is killed once ``budget_s`` has passed or
    as soon as one rank fails (its peers would wait for it until the
    group's timeout), and a failure raises with the tail of each failed
    rank's log."""
    if backend == "nccl" and (torch.device(device).type != "cuda"
                              or nproc > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs a card a rank: {nproc} ranks, "
                         f"{torch.cuda.device_count()} cards")
    if task not in ("step", "trainer"):
        raise ValueError(f"task must be 'step' or 'trainer', got {task!r}")
    if torch.device(device).type == "cuda":
        from personalized_text_to_speech_tpu_torch.ops import mas

        mas.build_library()  # once, before the ranks look for it
    with tempfile.TemporaryDirectory(prefix="ptts_dp_") as tmp:
        tmp = Path(tmp)
        torch.save(job, tmp / "job.pt")
        port = free_port()
        procs, logs = [], []
        for r in range(nproc):
            log = open(tmp / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _MODULE, "--worker", str(tmp / "job.pt"),
                 "--task", task, "--rank", str(r), "--nproc", str(nproc),
                 "--model", str(model), "--port", str(port),
                 "--device", device, "--backend", backend,
                 "--timeout", str(budget_s),
                 "--out", str(tmp / f"rank{r}.pt")],
                cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + budget_s
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if None not in codes or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = "\n".join(
                f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                + (tmp / f"rank{r}.log").read_text()[-3000:] for r in failed)
            raise RuntimeError(f"ranks {failed} of {nproc} failed or ran "
                               f"past {budget_s:.0f} s:\n{tails}")
        return [torch.load(tmp / f"rank{r}.pt", weights_only=True)
                for r in range(nproc)]


def _grad_rel_err(got: dict, want: dict) -> float:
    if set(got) != set(want) or any(
            (got[n] is None) != (want[n] is None) for n in want):
        raise AssertionError("the gradients' names or None pattern differ")
    diff = sum((got[n] - w).double().square().sum().item()
               for n, w in want.items() if w is not None)
    norm = sum(w.double().square().sum().item()
               for w in want.values() if w is not None)
    return (diff / max(norm, 1e-30)) ** 0.5


def compare(ref: dict, ranks: List[dict], forwards: int,
            loss_tol: float = LOSS_TOL, grad_tol: float = GRAD_TOL) -> dict:
    """Hold the ranks' results to one process's (module docstring);
    ``forwards`` is the MAS calls each rank makes.  Returns the errors."""
    first = ranks[0]
    loss_err = 0.0
    for res in ranks:
        if set(res["metrics"]) != set(ref["metrics"]):
            raise AssertionError(f"rank {res['rank']}: other metrics")
        for n, w in ref["metrics"].items():
            err = abs(res["metrics"][n] - w) / max(abs(w), 1e-3)
            loss_err = max(loss_err, err)
            if err > loss_tol:
                raise AssertionError(
                    f"rank {res['rank']}: {n} {res['metrics'][n]} against "
                    f"{w} (relative {err:.3g} > {loss_tol})")
        for net in ("grads_g", "grads_d"):
            if not all(res[net][n] is None and v is None
                       or torch.equal(res[net][n], v)
                       for n, v in first[net].items()):
                raise AssertionError(f"rank {res['rank']}: {net} differ "
                                     "from rank 0's")
        if res["checksums"] != first["checksums"]:
            bad = [k for k, v in res["checksums"].items()
                   if first["checksums"][k] != v]
            raise AssertionError(f"rank {res['rank']}: parameters differ "
                                 f"from rank 0's after the update: {bad[:6]}")
        if not all(torch.equal(res["uv"][n], v) for n, v in first["uv"].items()):
            raise AssertionError(f"rank {res['rank']}: u/v differ from rank 0's")
        if res["mas_calls"] != forwards or res["mas_plain_equal"] is False:
            raise AssertionError(
                f"rank {res['rank']}: {res['mas_calls']} MAS calls (want "
                f"{forwards}), plain MAS equal: {res['mas_plain_equal']}")
    grad_err = {net: _grad_rel_err(first[net], ref[net])
                for net in ("grads_g", "grads_d")}
    if any(e > grad_tol for e in grad_err.values()):
        raise AssertionError(f"gradients against one process: {grad_err} "
                             f"(bound {grad_tol} of the norm)")
    uv_err = max(((first["uv"][n] - v).abs().max() / v.norm()).item()
                 for n, v in ref["uv"].items()) if ref["uv"] else 0.0
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "uv_rel_err": uv_err, "ranks": len(ranks),
            "mas_calls_per_rank": forwards,
            "mas_launches": [r["mas_launches"] for r in ranks],
            "allreduce_ms": [r["allreduce_ms"] for r in ranks]}


def _slice(t: torch.Tensor, dim: Optional[int], model: int,
           index: int) -> torch.Tensor:
    """Model index ``index``'s slice of a whole tensor (``dim`` None: all)."""
    if dim is None:
        return t
    n = t.shape[dim] // model
    return t.narrow(dim, index * n, n)


def compare_tp(ref: dict, ranks: List[dict], forwards: int) -> dict:
    """Hold tensor-parallel ranks' results to one process's with JAX's
    bounds (module docstring); ``ref`` needs ``params`` (``job["with_params"]``)
    and ``forwards`` is the MAS calls each rank makes.  A gradient tensor
    past JAX's bound is excused within :data:`TP_KINK_TOL` of its own
    largest value while its network's gradient stays within
    :data:`TP_NORM_TOL` of its norm, and listed.  Returns the errors."""
    loss_err, grad_err, uv_err, param_err = 0.0, {}, 0.0, 0.0
    norm_err: Dict[str, float] = {}
    excused = []
    by_model_group: Dict[int, List[dict]] = {}
    by_model_index: Dict[int, List[dict]] = {}
    for res in ranks:
        data, model, di, mi = res["mesh"]
        by_model_group.setdefault(di, []).append(res)
        by_model_index.setdefault(mi, []).append(res)
        if set(res["metrics"]) != set(ref["metrics"]):
            raise AssertionError(f"rank {res['rank']}: other metrics")
        for n, w in ref["metrics"].items():
            err = abs(res["metrics"][n] - w)
            loss_err = max(loss_err, err / max(abs(w), 1.0))
            if err > TP_LOSS_TOL * (1.0 + abs(w)):
                raise AssertionError(
                    f"rank {res['rank']}: {n} {res['metrics'][n]} against {w} "
                    f"(bound {TP_LOSS_TOL} relative and absolute)")
        for net in ("g", "d"):
            want, got = ref[f"grads_{net}"], res[f"grads_{net}"]
            if set(got) != set(want):
                raise AssertionError(f"rank {res['rank']}: {net} gradient names")
            scale = max(max(float(w.abs().max()) for w in want.values()
                            if w is not None), 1.0)
            worst, diff_sq, want_sq, past = 0.0, 0.0, 0.0, []
            for n, w in want.items():
                if (w is None) != (got[n] is None):
                    raise AssertionError(f"rank {res['rank']}: {net} {n} None")
                if w is None:
                    continue
                w = _slice(w, res["specs"][net][n], model, mi)
                if got[n].shape != w.shape:
                    raise AssertionError(f"rank {res['rank']}: {net} {n} "
                                         f"{tuple(got[n].shape)} against "
                                         f"{tuple(w.shape)}")
                diff = (got[n] - w).abs()
                diff_sq += diff.double().square().sum().item()
                want_sq += w.double().square().sum().item()
                excess = (diff / (TP_RTOL * w.abs() + TP_ATOL * scale)
                          ).max().item()
                worst = max(worst, excess)
                if excess <= 1.0:
                    continue
                own = diff.max().item() / max(w.abs().max().item(), 1e-30)
                if own > TP_KINK_TOL:
                    raise AssertionError(
                        f"rank {res['rank']}: gradient {net}.{n} off by "
                        f"{excess:.3g}x its bound (rtol {TP_RTOL}, atol "
                        f"{TP_ATOL} x {scale:.3g}; {own:.3g} of its largest "
                        "value)")
                past.append({"rank": res["rank"], "tensor": f"{net}.{n}",
                             "excess": excess, "of_largest": own})
            rel = (diff_sq / max(want_sq, 1e-30)) ** 0.5
            norm_err[net] = max(norm_err.get(net, 0.0), rel)
            if past and rel > TP_NORM_TOL:
                raise AssertionError(
                    f"rank {res['rank']}: {net}'s gradient off by {rel:.3g} "
                    f"of its norm (bound {TP_NORM_TOL}) with {past}")
            excused += past
            grad_err[net] = max(grad_err.get(net, 0.0), worst)
            bound = TP_PARAM_LRS * res["lr"]
            for k, v in ref["params"][net].items():
                w = _slice(v, res["specs"][net][k], model, mi)
                if net == "d" and k in res["uv"]:
                    scale_uv = max(float(w.abs().max()), 1.0)
                    err = (res["uv"][k] - w).abs()
                    excess = (err / (TP_RTOL * w.abs() + TP_ATOL * scale_uv)
                              ).max().item()
                    uv_err = max(uv_err, excess)
                    if excess > 1.0:
                        raise AssertionError(f"rank {res['rank']}: {k} off by "
                                             f"{excess:.3g}x its bound")
                    continue
                if res.get("params"):
                    err = (res["params"][net][k] - w).abs().max().item()
                    param_err = max(param_err, err / bound)
                    if err > bound:
                        raise AssertionError(
                            f"rank {res['rank']}: {net}.{k} after the update "
                            f"off by {err:.3g} > {bound:.3g}")
        if res["mas_calls"] != forwards or res["mas_plain_equal"] is False:
            raise AssertionError(
                f"rank {res['rank']}: {res['mas_calls']} MAS calls (want "
                f"{forwards}), plain MAS equal: {res['mas_plain_equal']}")
    replicated = {f"{net}.{k}" for net in ("g", "d")
                  for k, dim in ranks[0]["specs"][net].items() if dim is None}
    # the losses of a model group's ranks come from their replicated
    # activations: bit for bit alike where every rank computed them alike
    metrics_equal = all(res["metrics"] == members[0]["metrics"]
                        for members in by_model_group.values()
                        for res in members)
    for members in by_model_group.values():
        first = members[0]["checksums"]
        for res in members[1:]:
            bad = [k for k in replicated if res["checksums"][k] != first[k]]
            if bad:
                raise AssertionError(
                    f"rank {res['rank']}: replicated tensors differ from its "
                    f"model group's after the update: {sorted(bad)[:6]}")
    for members in by_model_index.values():
        for res in members[1:]:
            if res["checksums"] != members[0]["checksums"]:
                raise AssertionError(f"rank {res['rank']}: tensors differ from "
                                     "its model index's on another data rank")
    sharded, total = ranks[0]["sharded_g"]
    return {"loss_err": loss_err, "grad_excess": grad_err,
            "grad_rel_err": norm_err, "excused": excused,
            "group_metrics_equal": metrics_equal,
            "uv_excess": uv_err, "param_err_lrs": param_err * TP_PARAM_LRS,
            "ranks": len(ranks), "mesh": ranks[0]["mesh"][:2],
            "sharded_g": sharded / max(total, 1),
            "mas_calls_per_rank": forwards,
            "mas_launches": [r["mas_launches"] for r in ranks],
            "memory": [r["memory"] for r in ranks],
            "step_ms": [r["step_ms"] for r in ranks],
            "allreduce_ms": [r["allreduce_ms"] for r in ranks]}


# the train step's geometry at full width (chip_smoke.py's phase 7 batch):
# global rows, frames and tokens
FULL_BATCH, FULL_FRAMES, FULL_TOKENS = 16, 400, 192


def synthetic_job(full_width: bool, nproc: int,
                  per_rank: Optional[int] = None, spectral: bool = False,
                  accum_steps: int = 1, seed: int = 0) -> dict:
    """Weights, a global batch (unequal text and frame lengths) and the
    step's draws, all from ``seed``, for ``nproc`` data ranks.  At full
    width the batch is :data:`FULL_BATCH` rows of up to :data:`FULL_FRAMES`
    frames and :data:`FULL_TOKENS` tokens, ``FULL_BATCH / nproc`` a data
    rank; else the tiny geometry with ``per_rank`` rows a data rank
    (default 2)."""
    from personalized_text_to_speech_tpu_torch.config import (
        default_model_config,
        tiny_model_config,
    )
    from personalized_text_to_speech_tpu_torch.models.discriminator import (
        MultiPeriodDiscriminator,
    )
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        SynthesizerTrn,
    )
    from personalized_text_to_speech_tpu_torch.train.step import (
        Batch,
        draw_samples,
    )

    if full_width:
        if per_rank is not None or FULL_BATCH % nproc:
            raise ValueError(f"at full width the {FULL_BATCH} rows split "
                             f"over the ranks: {nproc} ranks")
        hps = default_model_config(n_speakers=8)
        b, frames, tokens = FULL_BATCH, FULL_FRAMES, FULL_TOKENS
        shortest = frames // 2
    else:
        hps = tiny_model_config(n_speakers=4)
        hps.train.segment_size = 8 * hps.data.hop_length
        b, frames, tokens = nproc * (per_rank or 2), 24, 8
        shortest = hps.train.segment_size // hps.data.hop_length + 2
    hps.train.bf16_run = False
    hps.model.use_spectral_norm = spectral
    hop = hps.data.hop_length
    rng = np.random.default_rng(seed)
    t = np.arange(frames * hop) / hps.data.sampling_rate
    wav = np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(90, 300) * t)
                    + 0.01 * rng.normal(size=t.shape)
                    for _ in range(b)]).astype(np.float32)
    seg = hps.train.segment_size // hop
    arrays = dict(
        text=rng.integers(1, len(hps.symbols), size=(b, tokens)).astype(np.int32),
        text_lengths=rng.integers(tokens // 2, tokens + 1, size=b).astype(np.int32),
        wav=wav,
        wav_lengths=(rng.integers(shortest, frames + 1, size=b) * hop
                     ).astype(np.int32),
        sid=rng.integers(0, hps.data.n_speakers, size=b).astype(np.int32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = SynthesizerTrn.from_hparams(hps)
        d = MultiPeriodDiscriminator(use_spectral_norm=spectral)
    gen = torch.Generator().manual_seed(seed + 1)
    samples = draw_samples(Batch.from_numpy(arrays, "cpu"), hop, seg,
                           hps.model.inter_channels, True, gen)
    return make_job(hps, g.state_dict(), d.state_dict(), arrays, samples,
                    d_kwargs={"use_spectral_norm": spectral},
                    accum_steps=accum_steps)


def check_parallel(job: dict, nproc: int, device: str,
                   budget_s: float = BUDGET_S, say=print,
                   backend: str = "gloo", model: int = 1) -> dict:
    """The dry run's two stages on ``job``: one process's step on
    ``device``, then ``nproc`` ranks on a model axis of ``model`` over
    ``backend`` held to it (:func:`compare`, or :func:`compare_tp` with a
    model axis)."""
    if model > 1:
        job = {**job, "with_params": True}
    t0 = time.monotonic()
    ref = run_step(job, device)
    say(f"dryrun stage single-process step ({device}, batch "
        f"{job['batch']['wav'].shape[0]}): OK in {time.monotonic() - t0:.1f} s")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the card's memory to the ranks
    t0 = time.monotonic()
    ranks = spawn_ranks(job, nproc, device, budget_s, backend, model=model)
    forwards = ref["mas_calls"]  # one a fused step, 2k with accumulation
    if ref["mas_plain_equal"] is False:
        raise AssertionError("the single process's MAS differs from the "
                             "plain MAS")
    secs = time.monotonic() - t0
    layout = f"{nproc // model} data x {model} model"
    if model > 1:
        report = compare_tp(ref, ranks, forwards=forwards)
        say(f"dryrun stage tensor-parallel step ({layout} over {backend} on "
            f"{device}): OK in {secs:.1f} s of its {budget_s:.0f} s budget; "
            f"{100 * report['sharded_g']:.1f}% of G sharded; losses within "
            f"{report['loss_err']:.3g}; gradient slices at "
            f"{report['grad_excess']} of their bounds "
            f"({len(report['excused'])} past it, excused as slope flips), "
            f"{report['grad_rel_err']} of the norms, u/v at "
            f"{report['uv_excess']:.3g}; parameters after the update within "
            f"{report['param_err_lrs']:.3g} learning rates; replicated "
            f"tensors equal in every model group; MAS {forwards} call(s) a "
            "rank")
    else:
        report = compare(ref, ranks, forwards=forwards)
        say(f"dryrun stage data-parallel step ({layout} over {backend} on "
            f"{device}): OK in {secs:.1f} s of its {budget_s:.0f} s budget; "
            f"losses within {report['loss_rel_err']:.3g}, gradients within "
            f"{report['grad_rel_err']} of the norm, parameters and u/v equal "
            f"on every rank, MAS {forwards} call(s) a rank")
        report.update(memory=[r["memory"] for r in ranks],
                      step_ms=[r["step_ms"] for r in ranks])
    report.update(ref_metrics=ref["metrics"], ref_memory=ref["memory"],
                  ref_step_ms=ref["step_ms"], ranks_s=secs)
    return report


def _fp32() -> None:
    """fp32 means fp32: no TF32 in cuDNN convolutions or cuBLAS products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _worker(args) -> int:
    from personalized_text_to_speech_tpu_torch.utils import runtime

    torch.set_num_threads(RANK_THREADS)
    _fp32()
    device = args.device
    if torch.device(device).type == "cuda":
        index = args.rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = f"cuda:{index}"
    runtime.init_distributed(f"127.0.0.1:{args.port}", args.nproc, args.rank,
                             backend=args.backend, timeout_s=args.timeout)
    try:
        job = torch.load(args.worker, weights_only=True)
        result = (run_trainer(job, device) if args.task == "trainer"
                  else run_step(job, device, model=args.model))
        torch.save(result, args.out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {_MODULE}")
    parser.add_argument("--nproc", type=int, default=2,
                        help="ranks: data x model")
    parser.add_argument("--model", type=int, default=1,
                        help="the mesh's model axis (tensor parallelism); "
                        "1: data parallelism alone")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--full-width", action="store_true",
                        help="the production widths (else the tiny geometry)")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                        help="the ranks' backend (nccl: one card a rank)")
    # one rank of a run (spawn_ranks)
    parser.add_argument("--worker", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--task", type=str, default="step", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--timeout", type=float, default=BUDGET_S,
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", type=str, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return _worker(args)

    if args.model < 1 or args.nproc % args.model:
        parser.error(f"--nproc {args.nproc} is not a multiple of --model "
                     f"{args.model}")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but torch finds no card")
    _fp32()
    t_start = time.monotonic()
    data = args.nproc // args.model
    job = synthetic_job(args.full_width, data)
    job["timed_steps"] = TIMED_STEPS
    b, frames = job["batch"]["wav"].shape
    print(f"dryrun stage build ({'full' if args.full_width else 'tiny'} "
          f"width, {b} rows over {data} data x {args.model} model ranks, "
          f"{frames // job['hps']['data']['hop_length']} frames, "
          f"{job['batch']['text'].shape[1]} tokens): OK in "
          f"{time.monotonic() - t_start:.1f} s", flush=True)
    report = check_parallel(job, args.nproc, args.device,
                            say=lambda s: print(s, flush=True),
                            backend=args.backend, model=args.model)
    if args.model > 1 and args.full_width and report["sharded_g"] < MIN_SHARDED:
        raise AssertionError(f"only {100 * report['sharded_g']:.1f}% of G's "
                             f"parameters sharded (at least "
                             f"{100 * MIN_SHARDED:.0f}%)")
    print(f"dryrun: OK in {time.monotonic() - t_start:.1f} s", flush=True)
    keys = (("ranks", "mesh", "sharded_g", "loss_err", "grad_excess",
             "grad_rel_err", "excused", "group_metrics_equal", "uv_excess",
             "param_err_lrs")
            if args.model > 1 else
            ("ranks", "loss_rel_err", "grad_rel_err", "uv_rel_err"))
    print(json.dumps({"dryrun": "ok", "device": args.device,
                      "backend": args.backend, "model": args.model,
                      "full_width": args.full_width,
                      **{k: report[k] for k in keys + (
                          "mas_launches", "allreduce_ms", "memory",
                          "ref_memory", "step_ms", "ref_step_ms",
                          "ranks_s")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
