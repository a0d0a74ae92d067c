"""Monotonic rational-quadratic spline transforms (neural spline flows).

Counterpart of ``personalized_text_to_speech_tpu/ops/spline.py`` (reference
``transforms.py:12-193``), in the same branch-free form: inside and outside
the interval are both computed and merged with ``where``, so shapes never
depend on the data.

Shapes: ``inputs [...]``, ``unnormalized_{widths,heights} [..., K]``,
``unnormalized_derivatives [..., K-1]`` (interior knots; linear tails add the
two boundary derivatives).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(
    bin_locations: torch.Tensor, inputs: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Index of the bin each input falls into (reference ``transforms.py:47-52``)."""
    locs = bin_locations.clone()
    locs[..., -1] += eps
    return torch.sum((inputs[..., None] >= locs).long(), dim=-1) - 1


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _knots(
    unnormalized: torch.Tensor, lo: float, hi: float, min_bin: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax bin sizes → (cumulative knots with pinned endpoints, sizes)."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat(
        [torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
         torch.full_like(cum[..., -1:], hi)],
        dim=-1,
    )
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Core monotonic RQS on the interval; returns (outputs, logabsdet)."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _knots(unnormalized_widths, left, right, min_bin_width)
    cumheights, heights = _knots(unnormalized_heights, bottom, top, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = bin_idx.clamp(0, num_bins - 1)

    input_cumwidths = _gather_last(cumwidths, bin_idx)
    input_bin_widths = _gather_last(widths, bin_idx)
    input_cumheights = _gather_last(cumheights, bin_idx)
    input_delta = _gather_last(heights / widths, bin_idx)
    input_derivatives = _gather_last(derivatives, bin_idx)
    input_derivatives_p1 = _gather_last(derivatives[..., 1:], bin_idx)
    input_heights = _gather_last(heights, bin_idx)

    d_sum = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        shifted = inputs - input_cumheights
        a = shifted * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - shifted * d_sum
        c = -input_delta * shifted
        discriminant = b ** 2 - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(torch.clamp(discriminant, min=0.0)))
        outputs = root * input_bin_widths + input_cumwidths
        theta = root
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + d_sum * theta_one_minus_theta
    if not inverse:
        numerator = input_heights * (
            input_delta * theta ** 2 + input_derivatives * theta_one_minus_theta
        )
        outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_p1 * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, (-logabsdet if inverse else logabsdet)


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQS with identity linear tails outside ``[-tail_bound, tail_bound]``
    (reference ``transforms.py:55-94``); inputs are clipped into the
    interval before the spline so the math stays finite everywhere."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    derivs = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    spline_out, spline_logdet = rational_quadratic_spline(
        inputs.clamp(-tail_bound, tail_bound),
        unnormalized_widths,
        unnormalized_heights,
        derivs,
        inverse=inverse,
        left=-tail_bound,
        right=tail_bound,
        bottom=-tail_bound,
        top=tail_bound,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height,
        min_derivative=min_derivative,
    )
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_logdet, torch.zeros_like(inputs))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: Optional[str] = None,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch wrapper (reference ``transforms.py:12-44``)."""
    kw = dict(inverse=inverse, min_bin_width=min_bin_width,
              min_bin_height=min_bin_height, min_derivative=min_derivative)
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, **kw,
        )
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, tail_bound=tail_bound, **kw,
    )
