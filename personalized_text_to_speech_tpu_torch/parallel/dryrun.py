"""Data-parallel dry run: one GAN train step on n ranks against one process's
step on the global batch.

    python -m personalized_text_to_speech_tpu_torch.parallel.dryrun \\
        --nproc 2 --device cpu|cuda [--full-width] [--backend gloo|nccl]

Counterpart of the data-parallel stage of ``__graft_entry__.py::
dryrun_multichip``.  The parent draws the weights, a global batch with
unequal text and frame lengths, and the step's draws, all from seeds
(``--full-width``: the production widths of ``config.default_model_config``
at the train step's geometry, 16 rows of 400 frames and up to 192 tokens,
16 / ``nproc`` rows a rank; else the tiny test geometry, 2 rows a rank);
it runs one process's fused step on the whole batch (modules in
``eval()``, dropout off, no group), then spawns ``nproc`` ranks on 127.0.0.1 over gloo (the default; it
also takes CUDA tensors, so two ranks may share one card, which NCCL
refuses) or over NCCL (``--backend nccl``: one card a rank).  Each
rank takes its rows and the draws of its rows, runs the step in the group
(:mod:`..train.step`) and writes its losses,
gradients, a checksum of every parameter after the update, its ``u``/``v``
and its MAS calls, and on the card times ``allreduce_grads`` of G and of
D after the step.  The run fails unless every loss is within
:data:`LOSS_TOL` of the single process's, each network's gradient within
:data:`GRAD_TOL` of its norm, every rank holds the same gradients, the same
parameters and the same ``u``/``v``, and each rank ran MAS once a forward
(on the card each call's path must equal the plain MAS's on its scores,
checked on the rank that made it).  Every process computes in fp32 with
TF32 off.  Each stage prints one OK line with its wall-clock time and
budget; a rank past its budget is killed and the run fails.  The last line
is a JSON object with the errors and each rank's MAS launches.  No tensor- or sequence-parallel stage: the port has neither yet
(ROADMAP.md, Queue 1, items 8 and 9).

:func:`run_step`, :func:`spawn_ranks` and :func:`compare` are the pieces
the tests and ``chip_smoke.py`` use with their own batches and bounds.
"""

from __future__ import annotations

import argparse
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


def run_step(job: dict, device: str) -> dict:
    """One train step of ``job`` on ``device`` (modules in ``eval()``) on
    this process's rows: the whole batch without a process group, else
    this rank's share of it.  Returns the metrics, the gradients (CPU), a
    checksum of every parameter and buffer after the update, the ``u``/``v``
    buffers and the MAS calls; on the card in a group, also the median time
    of ``allreduce_grads`` of G and of D, and of its gradient-pattern check
    alone (``g_check``, ``d_check``), by CUDA events (10 calls after 2;
    they sum the gradients again, so they run after the gradients are
    copied out)."""
    from personalized_text_to_speech_tpu_torch.config import (
        load_hparams_from_dict,
    )
    from personalized_text_to_speech_tpu_torch.models import synthesizer
    from personalized_text_to_speech_tpu_torch.models.discriminator import (
        MultiPeriodDiscriminator,
    )
    from personalized_text_to_speech_tpu_torch.models.synthesizer import (
        SynthesizerTrn,
    )
    from personalized_text_to_speech_tpu_torch.ops import mas
    from personalized_text_to_speech_tpu_torch.train.state import (
        create_train_state,
    )
    from personalized_text_to_speech_tpu_torch.train.step import (
        Batch,
        Samples,
        make_train_step,
    )

    hps = load_hparams_from_dict(job["hps"])
    g = (SynthesizerTrn(**job["g_kwargs"]) if job["g_kwargs"]
         else SynthesizerTrn.from_hparams(hps))
    d = MultiPeriodDiscriminator(**job["d_kwargs"])
    g.load_state_dict(job["g_state"], strict=True)
    d.load_state_dict(job["d_state"], strict=True)
    g.to(device).eval()
    d.to(device).eval()
    parallel.broadcast_module(g)
    parallel.broadcast_module(d)
    g_state = create_train_state(g, hps, steps_per_epoch=4)
    d_state = create_train_state(d, hps, steps_per_epoch=4)

    world, rank = parallel.world_size(), parallel.rank()
    b = job["batch"]["wav"].shape[0]
    if b % world:
        raise ValueError(f"batch {b} not divisible by {world} ranks")
    rows = slice(rank * b // world, (rank + 1) * b // world)
    arrays = {k: v[rows].numpy() for k, v in job["batch"].items()}
    batch = Batch.from_numpy(arrays, device)
    samples = Samples(*(None if t is None else t[rows].to(device)
                        for t in job["samples"]))
    step = make_train_step(hps, debug_grads=True,
                           accum_steps=job["accum_steps"], remat=job["remat"])

    calls = []
    real = synthesizer.maximum_path

    def spy(neg_cent, x_len, y_len):
        path = real(neg_cent, x_len, y_len)
        if path.is_cuda:  # the kernel's path against the plain MAS, here
            plain = mas.maximum_path_plain(neg_cent.detach().float(), x_len,
                                           y_len)
            calls.append(bool(torch.equal(path, plain)))
        else:
            calls.append(None)
        return path

    launches = mas.maximum_path_cuda.launches
    synthesizer.maximum_path = spy
    try:
        m = step(g_state, d_state, batch, samples=samples)
    finally:
        synthesizer.maximum_path = real
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

    def grads(net):
        return {n: None if v is None else v.detach().cpu()
                for n, v in m[net].items()}

    result = {
        "rank": rank, "world": world, "rows": (rows.start, rows.stop),
        "metrics": {n: float(v) for n, v in m.items() if not n.startswith("_")},
        "grads_g": grads("_grads_g"), "grads_d": grads("_grads_d"),
        "checksums": {f"{net}.{k}": _checksum(v)
                      for net, mod in (("g", g), ("d", d))
                      for k, v in mod.state_dict().items()},
        "uv": {n: t.detach().cpu() for n, t in d.named_buffers()
               if n.endswith(("weight_u", "weight_v"))},
        "mas_calls": len(calls),
        "mas_launches": mas.maximum_path_cuda.launches - launches,
        "mas_plain_equal": None if None in calls else all(calls),
        "allreduce_ms": None,
    }
    if torch.distributed.is_initialized() and \
            torch.device(device).type == "cuda":
        from personalized_text_to_speech_tpu_torch.parallel import mesh

        result["allreduce_ms"] = {}
        for net, mod in (("g", g), ("d", d)):
            result["allreduce_ms"][net] = _cuda_median_ms(
                lambda: parallel.allreduce_grads(mod))
            result["allreduce_ms"][f"{net}_check"] = _cuda_median_ms(
                lambda: mesh._check_grad_pattern(
                    [p.grad for p in mod.parameters()], torch.device(device)))
    return result


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
                budget_s: float = BUDGET_S, backend: str = "gloo") -> List[dict]:
    """Run :func:`run_step` in a group of ``nproc`` fresh processes over ``backend``, each on ``device`` (``cuda`` ranks take the
    cards round robin; NCCL needs a card a rank); returns their results by
    rank.  Every rank is
    killed once ``budget_s`` has passed or as soon as one rank fails (its
    peers would wait for it until the group's timeout), and a failure
    raises with the tail of each failed rank's log."""
    if backend == "nccl" and (torch.device(device).type != "cuda"
                              or nproc > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs a card a rank: {nproc} ranks, "
                         f"{torch.cuda.device_count()} cards")
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
                 "--rank", str(r), "--nproc", str(nproc), "--port", str(port),
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
            raise RuntimeError(f"data-parallel ranks {failed} failed or ran "
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


# the train step's geometry at full width (chip_smoke.py's phase 7 batch):
# global rows, frames and tokens
FULL_BATCH, FULL_FRAMES, FULL_TOKENS = 16, 400, 192


def synthetic_job(full_width: bool, nproc: int,
                  per_rank: Optional[int] = None, spectral: bool = False,
                  accum_steps: int = 1, seed: int = 0) -> dict:
    """Weights, a global batch (unequal text and frame lengths) and the
    step's draws, all from ``seed``.  At full width the batch is
    :data:`FULL_BATCH` rows of up to :data:`FULL_FRAMES` frames and
    :data:`FULL_TOKENS` tokens, ``FULL_BATCH / nproc`` a rank; else the tiny
    geometry with ``per_rank`` rows a rank (default 2)."""
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


def check_data_parallel(job: dict, nproc: int, device: str,
                        budget_s: float = BUDGET_S, say=print,
                        backend: str = "gloo") -> dict:
    """The dry run's two stages on ``job``: one process's step on
    ``device``, then ``nproc`` ranks over ``backend`` held to it
    (:func:`compare`)."""
    t0 = time.monotonic()
    ref = run_step(job, device)
    say(f"dryrun stage single-process step ({device}, batch "
        f"{job['batch']['wav'].shape[0]}): OK in {time.monotonic() - t0:.1f} s")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the card's memory to the ranks
    t0 = time.monotonic()
    ranks = spawn_ranks(job, nproc, device, budget_s, backend)
    forwards = ref["mas_calls"]  # one a fused step, 2k with accumulation
    report = compare(ref, ranks, forwards=forwards)
    secs = time.monotonic() - t0
    say(f"dryrun stage data-parallel step ({nproc} ranks over {backend} on "
        f"{device}): OK in {secs:.1f} s of its {budget_s:.0f} s budget; "
        f"losses within {report['loss_rel_err']:.3g}, gradients within "
        f"{report['grad_rel_err']} of the norm, parameters and u/v equal on "
        f"every rank, MAS {forwards} call(s) a rank")
    report.update(ref_metrics=ref["metrics"], data_parallel_s=secs)
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
        result = run_step(job, device)
        torch.save(result, args.out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {_MODULE}")
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--full-width", action="store_true",
                        help="the production widths (else the tiny geometry)")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                        help="the ranks' backend (nccl: one card a rank)")
    # one rank of a run (spawn_ranks)
    parser.add_argument("--worker", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--timeout", type=float, default=BUDGET_S,
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", type=str, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return _worker(args)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda asked for, but torch finds no card")
    _fp32()
    t_start = time.monotonic()
    job = synthetic_job(args.full_width, args.nproc)
    b, frames = job["batch"]["wav"].shape
    print(f"dryrun stage build ({'full' if args.full_width else 'tiny'} "
          f"width, {b} rows over {args.nproc} ranks, "
          f"{frames // job['hps']['data']['hop_length']} frames, "
          f"{job['batch']['text'].shape[1]} tokens): OK in "
          f"{time.monotonic() - t_start:.1f} s", flush=True)
    report = check_data_parallel(job, args.nproc, args.device,
                                 say=lambda s: print(s, flush=True),
                                 backend=args.backend)
    print(f"dryrun: OK in {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"dryrun": "ok", "device": args.device,
                      "backend": args.backend,
                      "full_width": args.full_width, **{
                          k: report[k] for k in (
                              "ranks", "loss_rel_err", "grad_rel_err",
                              "uv_rel_err", "mas_launches", "allreduce_ms",
                              "data_parallel_s")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
