"""The train step on the card in a world-size-1 NCCL group against the same
step with no group, bit for bit; and two gloo ranks on the card with a model
axis of 2 against one process.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports nothing of JAX:

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda --noconftest

With W = 1 every weight of the step is exactly 1 (1/W, and Σmask_rank /
Σmask_global = x / x) and NCCL's sum over one rank is the identity, so the
step in the group must give the step's losses, gradients and updated
parameters without one bit for bit.  Both run in fp32 with TF32 off and
cuDNN's deterministic algorithms, and the step with no group is first run
twice to show that it repeats itself bit for bit.
"""

import pytest
import torch
import torch.distributed as dist

from personalized_text_to_speech_tpu_torch.parallel import dryrun
from personalized_text_to_speech_tpu_torch.utils import runtime


@pytest.fixture
def nccl_group():
    """Starts a world-size-1 NCCL group when called; the group is gone
    after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the MAS kernel have no "
                    "CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield lambda: runtime.init_distributed(
            f"127.0.0.1:{dryrun.free_port()}", 1, 0, backend="nccl",
            timeout_s=120)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("spectral,k", [(False, 1), (True, 1), (False, 2)],
                         ids=["fused", "spectral", "accum2"])
def test_world_one_nccl_step_is_the_plain_step(nccl_group, spectral, k):
    job = dryrun.synthetic_job(full_width=False, nproc=1, per_rank=4,
                               spectral=spectral, accum_steps=k)
    plain = [dryrun.run_step(job, "cuda") for _ in range(2)]
    nccl_group()
    dp = dryrun.run_step(job, "cuda")
    assert dist.get_backend() == "nccl" and dp["world"] == 1
    assert dp["allreduce_ms"] is not None
    for got in (plain[1], dp):
        assert got["metrics"] == plain[0]["metrics"]
        for net in ("grads_g", "grads_d"):
            for n, v in plain[0][net].items():
                assert (v is None and got[net][n] is None
                        or torch.equal(got[net][n], v)), (net, n)
        assert got["checksums"] == plain[0]["checksums"]
        assert all(torch.equal(got["uv"][n], v)
                   for n, v in plain[0]["uv"].items())
    forwards = 1 if k == 1 else 2 * k
    assert dp["mas_calls"] == dp["mas_launches"] == forwards
    assert dp["mas_plain_equal"] is True


@pytest.mark.cuda
def test_two_gloo_ranks_model_2_match_one_process():
    """Two gloo ranks on the card, data 1 × model 2, one tiny fused step
    against one process with the bounds of ``dryrun.compare_tp``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MAS kernel has no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        job = dryrun.synthetic_job(full_width=False, nproc=1, per_rank=4)
        report = dryrun.check_parallel(job, 2, "cuda", budget_s=240,
                                       model=2)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert report["mesh"] == (1, 2) and report["mas_launches"] == [1, 1]
    assert report["sharded_g"] > 0.25
