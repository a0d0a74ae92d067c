"""The Hopper MAS kernel (``csrc/mas.cu``) against its plain PyTorch
version, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device: a CUDA kernel has no CPU mode.  The file imports nothing of JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_mas_cuda.py -m cuda --noconftest

The plain version is held against the numpy oracle and the Pallas kernel
in ``test_torch_mas.py``; here the kernel must equal it exactly.
"""

import numpy as np
import pytest
import torch

from personalized_text_to_speech_tpu_torch.ops import mas


def _random_case(seed, b, t_y, t_x):
    rng = np.random.default_rng(seed)
    neg = rng.normal(size=(b, t_y, t_x)).astype(np.float32)
    sl = rng.integers(t_x, t_y + 1, size=b).astype(np.int32)
    tl = np.minimum(rng.integers(2, t_x + 1, size=b), sl).astype(np.int32)
    sl[0], tl[0] = t_y, t_x  # one full-size case
    return neg, tl, sl


def _case(name):
    rng = np.random.default_rng(11)
    if name.startswith("random-"):
        return _random_case(int(name[-1]), 3, 37, 11)
    if name == "t_x_1":
        return (rng.normal(size=(2, 9, 1)).astype(np.float32),
                np.array([1, 1], np.int32), np.array([9, 4], np.int32))
    if name == "t_y_eq_t_x":
        return (rng.normal(size=(2, 8, 8)).astype(np.float32),
                np.array([8, 5], np.int32), np.array([8, 5], np.int32))
    if name == "padded":
        return (rng.normal(size=(3, 30, 12)).astype(np.float32),
                np.array([7, 3, 11], np.int32), np.array([20, 3, 29], np.int32))
    if name == "ties":
        return (rng.integers(-2, 2, size=(2, 25, 9)).astype(np.float32),
                np.array([9, 6], np.int32), np.array([25, 17], np.int32))
    if name == "wide-t_x-1500":  # more columns than threads in a block
        return _random_case(5, 2, 1600, 1500)
    if name == "full-16x400x192":  # the aligning forward's geometry
        return _random_case(0, 16, 400, 192)
    raise ValueError(name)


CASES = [f"random-{s}" for s in range(5)] + [
    "t_x_1", "t_y_eq_t_x", "padded", "ties", "wide-t_x-1500", "full-16x400x192",
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MAS kernel has no CPU mode")
    return torch.device("cuda")


def _on(device, neg, tl, sl):
    return (torch.from_numpy(neg).to(device), torch.from_numpy(tl).to(device),
            torch.from_numpy(sl).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(cuda_device, name):
    neg, tl, sl = _on(cuda_device, *_case(name))
    before = mas.maximum_path_cuda.launches
    got = mas.maximum_path(neg, tl, sl)  # the dispatcher takes the kernel
    torch.cuda.synchronize()
    assert mas.maximum_path_cuda.launches == before + 1
    assert torch.equal(got, mas.maximum_path_plain(neg, tl, sl))


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_it_cannot_take(cuda_device):
    neg, tl, sl = _on(cuda_device, *_case("random-0"))
    with pytest.raises(ValueError, match="float32"):
        mas.maximum_path_cuda(neg.double(), tl, sl)
    with pytest.raises(ValueError, match="contiguous"):
        mas.maximum_path_cuda(neg.transpose(1, 2).contiguous().transpose(1, 2),
                              tl, sl)
    with pytest.raises(ValueError, match="int32"):
        mas.maximum_path_cuda(neg, tl.long(), sl)
    with pytest.raises(ValueError, match="shared memory"):
        mas.maximum_path_cuda(torch.zeros(1, 60000, 4, device=cuda_device),
                              tl[:1], sl[:1])
