"""Monotonic Alignment Search of the PyTorch port against the JAX package.

The port's plain MAS (``ops/mas.py::maximum_path_plain``, and the
dispatcher ``maximum_path`` on a CPU tensor) must give paths bit-identical
to the numpy oracle ``maximum_path_numpy`` and to the Pallas kernel run in
interpret mode.  The Hopper kernel (``csrc/mas.cu``) is held against the
plain version on the card in ``test_torch_mas_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu.ops.mas import maximum_path_numpy
from personalized_text_to_speech_tpu.ops.mas_pallas import maximum_path_pallas
from personalized_text_to_speech_tpu_torch.ops import mas as port_mas

torch.set_num_threads(2)


def _random_case(seed, b=3, t_y=37, t_x=11):
    """The random geometry of ``tests/test_ops.py::TestMAS``."""
    rng = np.random.default_rng(seed)
    neg = rng.normal(size=(b, t_y, t_x)).astype(np.float32)
    spec_lens = rng.integers(t_x, t_y + 1, size=b).astype(np.int32)
    text_lens = np.minimum(rng.integers(2, t_x + 1, size=b), spec_lens).astype(
        np.int32
    )
    spec_lens[0], text_lens[0] = t_y, t_x  # one full-size case
    return neg, text_lens, spec_lens


def _pallas_case(seed, b=4, t_y=37, t_x=11):
    """The random geometry of ``tests/test_ops.py::TestPallasMAS``."""
    rng = np.random.default_rng(seed)
    neg = rng.normal(size=(b, t_y, t_x)).astype(np.float32)
    sl = rng.integers(t_x, t_y + 1, size=b).astype(np.int32)
    tl = np.minimum(rng.integers(2, t_x + 1, size=b), sl).astype(np.int32)
    return neg, tl, sl


def _edge_case(name):
    rng = np.random.default_rng(11)
    if name == "t_x_1":  # one token: every frame on column 0
        neg = rng.normal(size=(2, 9, 1)).astype(np.float32)
        return neg, np.array([1, 1], np.int32), np.array([9, 4], np.int32)
    if name == "t_y_eq_t_x":  # square: the only path is the diagonal
        neg = rng.normal(size=(2, 8, 8)).astype(np.float32)
        return neg, np.array([8, 5], np.int32), np.array([8, 5], np.int32)
    if name == "padded":  # text_len < T_x and spec_len < T_y in every row
        neg = rng.normal(size=(3, 30, 12)).astype(np.float32)
        return (neg, np.array([7, 3, 11], np.int32),
                np.array([20, 3, 29], np.int32))
    if name == "ties":  # integer scores: many equal predecessors
        neg = rng.integers(-2, 2, size=(2, 25, 9)).astype(np.float32)
        return neg, np.array([9, 6], np.int32), np.array([25, 17], np.int32)
    raise ValueError(name)


CASES = (
    [pytest.param(_random_case, s, id=f"ops-random-{s}") for s in range(5)]
    + [pytest.param(_pallas_case, s, id=f"pallas-random-{s}") for s in range(3)]
    + [pytest.param(_edge_case, n, id=f"edge-{n}")
       for n in ("t_x_1", "t_y_eq_t_x", "padded", "ties")]
)


def _port_plain(neg, tl, sl):
    return port_mas.maximum_path_plain(
        torch.from_numpy(neg), torch.from_numpy(tl), torch.from_numpy(sl)
    ).numpy()


@pytest.mark.parametrize("make,arg", CASES)
def test_plain_matches_numpy_oracle(make, arg):
    neg, tl, sl = make(arg)
    np.testing.assert_array_equal(_port_plain(neg, tl, sl),
                                  maximum_path_numpy(neg, tl, sl))


@pytest.mark.parametrize("make,arg", CASES)
def test_plain_matches_pallas_interpret(make, arg):
    neg, tl, sl = make(arg)
    want = np.asarray(maximum_path_pallas(
        jnp.asarray(neg), jnp.asarray(tl), jnp.asarray(sl), interpret=True
    ))
    np.testing.assert_array_equal(_port_plain(neg, tl, sl), want)


@pytest.mark.parametrize("make,arg", CASES[:1] + CASES[-2:])
def test_dispatcher_on_cpu_runs_plain_version(make, arg):
    neg, tl, sl = make(arg)
    before = port_mas.maximum_path_cuda.launches
    got = port_mas.maximum_path(
        torch.from_numpy(neg).double(),  # any float type; computed in f32
        torch.from_numpy(tl).long(), torch.from_numpy(sl).long(),
    )
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), maximum_path_numpy(neg, tl, sl))
    assert port_mas.maximum_path_cuda.launches == before


def test_path_is_monotonic_and_covers_each_frame():
    neg, tl, sl = _random_case(3, b=4, t_y=60, t_x=17)
    path = _port_plain(neg, tl, sl)
    for b in range(path.shape[0]):
        p = path[b, : sl[b], : tl[b]]
        assert (p.sum(axis=1) == 1).all()  # one token per frame
        cols = p.argmax(axis=1)
        steps = np.diff(cols)
        assert ((steps == 0) | (steps == 1)).all()
        assert cols[0] == 0 and cols[-1] == tl[b] - 1
        assert path[b, sl[b]:].sum() == 0 and path[b, :, tl[b]:].sum() == 0


@pytest.mark.parametrize("make,arg", CASES)
def test_path_depends_only_on_bound_cells(make, arg):
    """``chip_smoke.py`` counts only the cells of ``mas_needed_cells`` in
    the kernel's bound: scores anywhere else must not move the path."""
    from chip_smoke import mas_needed_cells

    neg, tl, sl = make(arg)
    needed = mas_needed_cells(torch.from_numpy(tl), torch.from_numpy(sl),
                              *neg.shape[1:]).numpy()
    other = np.random.default_rng(5).normal(scale=100.0, size=neg.shape)
    moved = np.where(needed, neg, other.astype(np.float32))
    assert (~needed).any()
    np.testing.assert_array_equal(_port_plain(moved, tl, sl),
                                  _port_plain(neg, tl, sl))


def test_kernel_wrapper_refuses_cpu_tensor():
    neg, tl, sl = _random_case(0)
    with pytest.raises(ValueError, match="CUDA"):
        port_mas.maximum_path_cuda(
            torch.from_numpy(neg), torch.from_numpy(tl), torch.from_numpy(sl)
        )
