"""The port's measurement modules on the CPU: ``utils/profiling.py``,
``utils/runtime.py``, ``TTSEngine.cost_analysis`` and the git-hash guard of
the port's ``Trainer``.

* ``StepTimer`` and ``check_git_hash``: the cases of ``tests/test_utils.py``
  on the port's copies.
* ``cost_stats``: FLOPs, bytes read and bytes written of small calls whose
  counts follow from their shapes, the backward included.
* ``cost_analysis`` against the JAX engine's at the tiny geometry (B=2, text
  bucket 32, frame bucket 64).  The two count different things: torch's
  ``FlopCounterMode`` counts matmuls and convolutions only, XLA also the
  elementwise work, which dominates the tiny encoder (attention softmax,
  the duration predictor's splines).  So the port's decode lies within
  [0.70, 1.00] of XLA's (0.837 measured) and its encode at most at XLA's
  (0.275 measured); both double exactly with the batch.
* ``device_info``, ``peak_flops``, ``require_card``, ``warmup_transfers``
  and ``trace`` on the CPU: no device figure comes from a CPU run.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.config import (
    tiny_model_config as jax_tiny_config,
)
from personalized_text_to_speech_tpu.infer import TTSEngine as JaxEngine
from personalized_text_to_speech_tpu.models.synthesizer import (
    SynthesizerTrn as JaxSynth,
)
from personalized_text_to_speech_tpu_torch.config import tiny_model_config
from personalized_text_to_speech_tpu_torch.data.audio import save_wav
from personalized_text_to_speech_tpu_torch.infer.engine import TTSEngine
from personalized_text_to_speech_tpu_torch.train.loop import Trainer
from personalized_text_to_speech_tpu_torch.utils import profiling, runtime


# --------------------------------------------------------------------------
# the cases of tests/test_utils.py on the port's copies
# --------------------------------------------------------------------------

def test_step_timer():
    t = profiling.StepTimer(warmup=1)
    for _ in range(4):
        t.start()
        time.sleep(0.01)
        t.stop()
    assert t.value is not None and t.value > 0.005
    assert t.steps_per_sec and t.steps_per_sec < 200


def test_check_git_hash(tmp_path):
    h = profiling.check_git_hash(str(tmp_path))
    if h is not None:  # the tree is a git checkout
        assert (tmp_path / "githash").read_text().strip() == h
        assert profiling.check_git_hash(str(tmp_path)) == h
    else:
        assert not (tmp_path / "githash").exists()


def test_trainer_records_git_hash(tmp_path):
    """The port's Trainer calls the guard as the JAX Trainer does: its run
    directory holds the commit where the tree is a git checkout, and no
    ``githash`` where it is not."""
    sr = 8000
    lines = []
    for i in range(2):
        t = np.arange(int(0.5 * sr)) / sr
        save_wav(str(tmp_path / f"w{i}.wav"), 0.3 * np.sin(2 * np.pi * 200 * t), sr)
        lines.append(f"{tmp_path / f'w{i}.wav'}|{i}|ab ko→ no↓ da to mi.")
    (tmp_path / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    hps = tiny_model_config()
    hps.data.training_files = str(tmp_path / "train.txt")
    model_dir = tmp_path / "run"
    Trainer(hps, str(model_dir), device="cpu")
    h = profiling.check_git_hash(str(tmp_path / "probe"))
    if h is not None:
        assert (model_dir / "githash").read_text().strip() == h
    else:
        assert not (model_dir / "githash").exists()


# --------------------------------------------------------------------------
# cost_stats
# --------------------------------------------------------------------------

def test_cost_stats_matmul():
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)
    stats = profiling.cost_stats(torch.matmul, a, b)
    assert stats["flops"] == 2 * 64 * 32 * 16
    assert stats["argument_size_bytes"] == 4 * (64 * 32 + 32 * 16)
    assert stats["bytes_min"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert stats["temp_size_bytes"] is None


def test_cost_stats_counts_parameters_once_and_intermediates_never():
    lin = torch.nn.Linear(16, 16, bias=False)
    x = torch.ones(4, 16)
    stats = profiling.cost_stats(lambda: lin(torch.relu(lin(x))))
    # x and the weight, read twice, count once; the hidden layer not at all
    assert stats["argument_size_bytes"] == 4 * (4 * 16 + 16 * 16)
    assert stats["bytes_min"] == stats["argument_size_bytes"] + 4 * 4 * 16
    assert stats["flops"] == 2 * (2 * 4 * 16 * 16)


def test_cost_stats_counts_the_backward():
    """A convolution's backward (input and weight gradients) is twice its
    forward: a count without it would equal the forward's."""
    conv = torch.nn.Conv1d(8, 16, 5, bias=False)
    x = torch.randn(2, 8, 40, requires_grad=True)
    fwd = profiling.cost_stats(conv, x)["flops"]
    both = profiling.cost_stats(lambda: conv(x).sum().backward())["flops"]
    assert fwd == 2 * 2 * 36 * 5 * 16 * 8
    assert both == 3 * fwd


# --------------------------------------------------------------------------
# cost_analysis against the JAX engine
# --------------------------------------------------------------------------

def _zero_variables(hps):
    """The JAX model's variables as zeros, shaped by ``jax.eval_shape`` (an
    eager flax init costs ~20 s; the counts depend on shapes alone)."""
    model = JaxSynth.from_hparams(hps)
    key = jax.random.PRNGKey(0)
    ts = max(model.segment_size + 1, 16)
    shapes = jax.eval_shape(
        model.init, {"params": key, "noise": key, "slice": key, "dropout": key},
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, ts, model.spec_channels)), jnp.array([ts]),
        jnp.array([0]),
    )
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def costs():
    port = TTSEngine(tiny_model_config(), device="cpu")
    hps = jax_tiny_config()
    jax_engine = JaxEngine(hps, params=_zero_variables(hps))
    return {
        "port": port.cost_analysis(2, t_bucket=32, f_bucket=64),
        "port_b4": port.cost_analysis(4, t_bucket=32, f_bucket=64),
        "jax": jax_engine.cost_analysis(2, t_bucket=32, f_bucket=64),
    }


def test_cost_analysis_shape_of_result(costs):
    port, jax_cost = costs["port"], costs["jax"]
    assert port["buckets"] == jax_cost["buckets"] == {"text": 32.0, "frames": 64.0}
    for stage in ("encode", "decode"):
        stats = port[stage]
        assert set(stats) == {"flops", "argument_size_bytes", "bytes_min",
                              "temp_size_bytes"}
        assert stats["flops"] > 0
        assert stats["bytes_min"] > stats["argument_size_bytes"] > 0
        assert stats["temp_size_bytes"] is None  # a CPU run


def test_cost_analysis_decode_against_xla(costs):
    ratio = costs["port"]["decode"]["flops"] / costs["jax"]["decode"]["flops"]
    assert 0.70 <= ratio <= 1.00, ratio


def test_cost_analysis_encode_at_most_xla(costs):
    assert costs["port"]["encode"]["flops"] <= costs["jax"]["encode"]["flops"]


def test_cost_analysis_arguments_against_xla(costs):
    """The bytes of the parameters and inputs each stage reads agree with
    XLA's ``argument_size_bytes`` within 5 % (the two sides pass a few
    small inputs in other dtypes)."""
    for stage in ("encode", "decode"):
        port = costs["port"][stage]["argument_size_bytes"]
        xla = costs["jax"][stage]["argument_size_bytes"]
        assert abs(port - xla) <= 0.05 * xla, (stage, port, xla)


@pytest.mark.parametrize("stage", ["encode", "decode"])
def test_cost_analysis_flops_double_with_the_batch(costs, stage):
    assert costs["port_b4"][stage]["flops"] == 2 * costs["port"][stage]["flops"]


# --------------------------------------------------------------------------
# what every measurement carries; no device figure from the CPU
# --------------------------------------------------------------------------

def test_device_info_on_the_cpu():
    info = profiling.device_info("cpu")
    assert info["platform"] == "cpu"
    assert info["power_limit"] is None
    assert set(info["tf32"]) == {"cudnn", "matmul"}
    assert not profiling.on_card("cpu")
    assert profiling.on_card("cuda:0")


def test_peak_flops():
    assert profiling.peak_flops("bfloat16", tf32=False) == 989e12
    assert profiling.peak_flops(torch.bfloat16, tf32=True) == 989e12
    assert profiling.peak_flops("float32", tf32=True) == 495e12
    assert profiling.peak_flops("float32", tf32=False) == 67e12
    assert profiling.PEAK_HBM_BYTES_PER_S == 3.35e12
    with pytest.raises(ValueError):
        profiling.peak_flops("int8", tf32=False)


def test_require_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        runtime.require_card("cuda")
    runtime.require_card("cpu")


def test_warmup_transfers_on_the_cpu():
    assert runtime.warmup_transfers("cpu") >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path), record_shapes=True) as prof:
        (x @ x).sum()
    names = [e.key for e in prof.key_averages()]
    assert "aten::mm" in names or "aten::matmul" in names
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" and "Input Dims" in e.get("args", {})
               for e in events)
