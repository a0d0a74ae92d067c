"""The port's measurement path on the card, at the tiny geometry.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_profiling_cuda.py -m cuda --noconftest

* ``cost_stats`` on the card: the same counts as on the CPU, and the peak
  memory the call needed beyond what was allocated before it.
* ``device_info``: the card's name, count and ``nvidia-smi`` power limit.
* ``profile_ops`` on a card trace: every kernel is attributed to an op row,
  the classes add up to the device time, and no op reads above its peak.
* ``bench_train``: one MAS launch on the card per step the tool runs.
"""

import pytest
import torch

from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.ops import mas
from personalized_text_to_speech_tpu_torch.tools import bench_train, profile_ops
from personalized_text_to_speech_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card's paths")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_cost_stats_on_the_card(cuda_device):
    a = torch.ones(256, 128, device=cuda_device)
    b = torch.ones(128, 64, device=cuda_device)
    stats = profiling.cost_stats(torch.matmul, a, b)
    assert stats["flops"] == 2 * 256 * 128 * 64
    assert stats["bytes_min"] == 4 * (256 * 128 + 128 * 64 + 256 * 64)
    assert stats["temp_size_bytes"] >= 4 * 256 * 64  # the output at least


@pytest.mark.cuda
def test_cost_analysis_counts_as_on_the_cpu(cuda_device):
    card = TTSEngine(tiny_model_config(), device="cuda").cost_analysis(
        2, t_bucket=32, f_bucket=64)
    cpu = TTSEngine(tiny_model_config(), device="cpu").cost_analysis(
        2, t_bucket=32, f_bucket=64)
    for stage in ("encode", "decode"):
        assert card[stage]["flops"] == cpu[stage]["flops"]
        assert card[stage]["temp_size_bytes"] > 0
        assert cpu[stage]["temp_size_bytes"] is None


@pytest.mark.cuda
def test_device_info_on_the_card(cuda_device):
    info = profiling.device_info("cuda")
    assert info["platform"] == "gpu"
    assert info["kind"] == torch.cuda.get_device_name(0)
    assert info["count"] == torch.cuda.device_count()
    assert info["power_limit"].startswith(info["kind"])
    assert info["tf32"] == {"cudnn": False, "matmul": False}


@pytest.mark.cuda
def test_profile_ops_on_a_card_trace(cuda_device, tmp_path):
    rows = profile_ops.main(["--tiny", "--stage", "decode", "--batch", "2",
                             "--dtype", "float32", "--json",
                             str(tmp_path / "ops.json"),
                             "--trace_dir", str(tmp_path / "trace")])
    row = rows[0]
    assert row["device"]["platform"] == "gpu"
    assert row["device_ms_per_rep"] > 0
    assert sum(row["by_class_ms_per_rep"].values()) == pytest.approx(
        row["device_ms_per_rep"])
    assert row["by_class_ms_per_rep"]["convolution"] > 0
    assert row["by_class_ms_per_rep"]["MAS"] == 0
    for op in row["top_ops"]:
        assert op["device_time_us"] is not None
        assert op["peak_share"] is None or op["peak_share"] <= 1.05
    kernel_us = sum(k["device_time_us"] for k in row["top_kernels"])
    assert kernel_us <= row["device_ms_per_rep"] * row["reps"] * 1e3 * 1.0001


@pytest.mark.cuda
def test_bench_train_launches_mas_every_step(cuda_device, monkeypatch):
    for k, v in dict(PTTS_BENCH_BATCH="2", PTTS_BENCH_FRAMES="64",
                     PTTS_BENCH_TOKENS="16", PTTS_BENCH_REPS="2",
                     PTTS_BENCH_DTYPE="float32").items():
        monkeypatch.setenv(k, v)
    mas.maximum_path_cuda.launches = 0
    rows = bench_train.main(["--tiny"])
    assert mas.maximum_path_cuda.launches == rows[0]["steps_run"] == 5
    assert 0 < rows[0]["mfu"] < 1
    assert rows[0]["audio_sec_per_wall_sec"] > 0
