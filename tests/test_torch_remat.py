"""Remat of the generator forward in the port's train step, and the memory
audit that measures it (``tools/bench_mem.py``).

``remat`` changes what the backward keeps, not the math: with ``dots``
(selective checkpointing: convolution and matmul outputs kept) and ``full``
(non-reentrant ``torch.utils.checkpoint``) one step gives the un-remat
step's metrics and gradients to the JAX remat test's bounds
(``tests/test_train_remat.py``: scalars 1e-5 relative, gradients rtol 1e-4,
atol 1e-6 × the largest), and ``dots`` composes with ``accum_steps=2``
(G's gradients then to ``tests/test_torch_accum.py``'s bound, for the
reason given there).  The recompute runs the forward again, MAS included:
two MAS calls a rematerialised forward.  With dropout on, the checkpoint
replays the masks.  The weights, batch and draws are
``tests/test_torch_accum.py``'s (the un-remat step is held against JAX
there and in ``tests/test_torch_train.py``).
"""

import json

import pytest
import torch

from personalized_text_to_speech_tpu_torch.tools import bench_mem
from personalized_text_to_speech_tpu_torch.train.step import (
    REMAT_POLICIES,
    Batch,
    make_train_step,
)
from tests.test_torch_accum import (
    B,
    TS,
    TT,
    Setup,
    assert_grads_close,
    assert_grads_match,
    assert_scalars_match,
    scalars,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    return Setup(spectral=False)


@pytest.fixture(scope="module")
def plain(setup):
    return setup.port_step(1, "none")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_matches_plain_step(setup, plain, remat):
    m0, _, calls0 = plain
    m1, _, calls1 = setup.port_step(1, remat)
    assert_scalars_match(scalars(m0), scalars(m1))
    for net in ("_grads_g", "_grads_d"):
        assert_grads_match(m0[net], m1[net])
    assert calls0 == [(B, TS, TT)]
    assert calls1 == [(B, TS, TT)] * 2  # the forward, then the recompute


def test_remat_composes_with_accumulation(setup, plain):
    m0, _, _ = plain
    m1, _, calls = setup.port_step(2, "dots")
    assert_scalars_match(scalars(m0), scalars(m1))
    assert_grads_match(m0["_grads_d"], m1["_grads_d"])
    assert_grads_close(m0["_grads_g"], m1["_grads_g"])
    # phase 1: 2 forwards without a graph; phase 2: 2 forwards + 2 recomputes
    assert calls == [(B // 2, TS, TT)] * 6


def test_remat_replays_dropout_masks(setup):
    """Dropout on: the recompute draws the forward's masks again, so the
    gradients are the un-remat step's from the same generator state."""
    out = {}
    for remat in ("none", "full"):
        g_state, d_state = setup.port_states()
        g_state.module.train()
        torch.manual_seed(0)
        step = make_train_step(setup.p_hps, debug_grads=True, remat=remat)
        out[remat] = step(g_state, d_state,
                          Batch.from_numpy(setup.arrays, "cpu"),
                          samples=setup.samples)
    assert_scalars_match(scalars(out["none"]), scalars(out["full"]))
    assert_grads_match(out["none"]["_grads_g"], out["full"]["_grads_g"])


def test_unknown_policy_raises(setup):
    assert REMAT_POLICIES == ("none", "dots", "full")
    with pytest.raises(ValueError, match="remat"):
        make_train_step(setup.p_hps, remat="bogus")


def test_bench_mem_prints_one_line_per_combination(capsys):
    combos = ["1:none", "2:dots"]
    rows = bench_mem.main(["--device", "cpu", "--tiny", "--batch", "2",
                           "--frames", "64", "--text", "16", "--combos",
                           *combos])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == rows and len(rows) == len(combos)
    for row, combo in zip(rows, combos):
        assert f"{row['accum_steps']}:{row['remat']}" == combo
        assert row["metric"] == "train-step device memory"
        assert (row["batch"], row["frames"], row["text"]) == (2, 64, 16)
        assert row["widths"] == "tiny"
        # device figures: none from the CPU
        for key in bench_mem.BYTES:
            assert key in row and row[key] is None, key
        assert row["step_ms"] > 0 and row["loss_g"] == row["loss_g"]
        assert row["device"]["platform"] == "cpu"
        assert row["dtype"] == "float32" and "tf32" in row
