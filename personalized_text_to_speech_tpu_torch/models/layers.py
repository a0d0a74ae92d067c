"""NN building blocks: convs (incl. weight and spectral norm), channel
LayerNorm, DDSConv,
WaveNet stack, HiFi-GAN residual blocks, conv-FFN.

Counterpart of ``personalized_text_to_speech_tpu/models/layers.py``
(reference ``modules.py:20-256``, ``attentions.py:257-303``).  Modules run
``[B, C, T]``; masks are ``[B, 1, T]``.

Weight norm is the legacy ``torch.nn.utils.weight_norm`` (dim 0), so
state-dict keys are ``weight_g``/``weight_v`` as in reference ``.pth`` files
and in ``utils/torch_compat.py``.  The JAX package adds 1e-12 under the
square root of the norm (``layers.py:141-145``, ``:209-215``); torch's norm
has no such term.  The term is below fp32 resolution for every weight these
models hold (the smallest ‖v‖² is ~1e-3), so the two agree to rounding.

Spectral norm (the discriminators' ``use_spectral_norm``, JAX
``layers.py:49-100``) is a module of this file's own,
:class:`SpectralNormConv1d`/:class:`SpectralNormConv2d`, not the legacy
``torch.nn.utils.spectral_norm`` hook, for two reasons: the hook iterates
whenever ``module.training`` is set, where the JAX package iterates only
when the caller marks the ``spectral`` collection mutable (here the
explicit :func:`power_iteration` switch, so ``.eval()``, which turns dropout
off, leaves the iteration alone); and under CUDA's bf16 autocast the hook's
``torch.mv`` would run in bf16, where JAX iterates on the fp32 weight.  The
keys and the math are the hook's: the ``weight_orig`` parameter and the
``weight_u``/``weight_v`` buffers over ``weight.reshape(C_out, -1)``; one
iteration ``v = normalize(Wᵀu)``, ``u = normalize(W v)`` (eps 1e-12,
without gradient), then ``σ = u·(W v)`` and ``W/σ``, all in fp32 with
autocast off; ``u``/``v`` are drawn as the hook draws them, after the
conv's own init.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
SPECTRAL_EPS = 1e-12


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(module: nn.Module) -> nn.Module:
    # the legacy API is deprecated in favour of parametrizations, whose keys
    # (parametrizations.weight.original0/1) no reference checkpoint uses
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return nn.utils.weight_norm(module)


class _SpectralNorm:
    """The spectral-norm half of :class:`SpectralNormConv1d` and
    :class:`SpectralNormConv2d` (module docstring)."""

    def _spectral_init(self) -> None:
        weight = self._parameters.pop("weight")
        self.weight_orig = nn.Parameter(weight.detach())
        with torch.no_grad():
            mat = weight.reshape(weight.shape[0], -1)
            u = mat.new_empty(mat.shape[0]).normal_(0, 1)
            v = mat.new_empty(mat.shape[1]).normal_(0, 1)
        self.register_buffer("weight_u", F.normalize(u, dim=0, eps=SPECTRAL_EPS))
        self.register_buffer("weight_v", F.normalize(v, dim=0, eps=SPECTRAL_EPS))
        self.power_iteration = False

    def spectral_weight(self) -> torch.Tensor:
        """``weight_orig / σ``; first one power iteration, stored in the
        buffers, when :func:`power_iteration` is on."""
        w = self.weight_orig
        with torch.autocast(device_type=w.device.type, enabled=False):
            mat = w.float().reshape(w.shape[0], -1)
            u, v = self.weight_u, self.weight_v
            if self.power_iteration:
                with torch.no_grad():
                    v = F.normalize(torch.mv(mat.t(), u), dim=0, eps=SPECTRAL_EPS)
                    u = F.normalize(torch.mv(mat, v), dim=0, eps=SPECTRAL_EPS)
                    self.weight_u.copy_(u)
                    self.weight_v.copy_(v)
                # σ keeps these fresh tensors for its backward, so the next
                # forward (fake after real) may update the buffers in place
            sigma = torch.dot(u, torch.mv(mat, v))
            return (w.float() / sigma).to(w.dtype)


class SpectralNormConv1d(_SpectralNorm, nn.Conv1d):
    """``nn.Conv1d`` whose weight is spectrally normalised (module
    docstring); state-dict keys ``weight_orig``, ``weight_u``, ``weight_v``,
    ``bias``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._spectral_init()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.spectral_weight(), self.bias)


class SpectralNormConv2d(_SpectralNorm, nn.Conv2d):
    """``nn.Conv2d`` counterpart of :class:`SpectralNormConv1d`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._spectral_init()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.spectral_weight(), self.bias)


@contextlib.contextmanager
def power_iteration(module: nn.Module) -> Iterator[None]:
    """Within the block, every spectral-norm conv of ``module`` runs one
    power iteration per forward, as the JAX package's apply with the
    ``spectral`` collection mutable does; outside it the estimates are
    frozen, whatever ``module.training`` says."""
    convs = [m for m in module.modules() if isinstance(m, _SpectralNorm)]
    for m in convs:
        m.power_iteration = True
    try:
        yield
    finally:
        for m in convs:
            m.power_iteration = False


def conv1d(
    in_channels: int,
    out_channels: int,
    kernel_size: int,
    dilation: int = 1,
    groups: int = 1,
    padding: Optional[int] = None,
    bias: bool = True,
    weight_norm: bool = False,
    init_std: Optional[float] = None,
    stride: int = 1,
    spectral_norm: bool = False,
) -> nn.Conv1d:
    """``nn.Conv1d`` with torch-style symmetric "same" padding by default.
    ``init_std`` draws the weight from N(0, std) (0 → zeros), as the JAX
    package's ``kernel_init`` does for the HiFi-GAN and coupling layers.
    ``spectral_norm`` gives a :class:`SpectralNormConv1d` (default init)."""
    if padding is None:
        padding = get_padding(kernel_size, dilation)
    if spectral_norm:
        return SpectralNormConv1d(in_channels, out_channels, kernel_size,
                                  stride=stride, dilation=dilation,
                                  groups=groups, padding=padding, bias=bias)
    conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                     dilation=dilation, groups=groups, padding=padding, bias=bias)
    if init_std == 0.0:
        nn.init.zeros_(conv.weight)
    elif init_std is not None:
        nn.init.normal_(conv.weight, 0.0, init_std)
    return _weight_norm(conv) if weight_norm else conv


def conv2d(
    in_channels: int,
    out_channels: int,
    kernel_size: Tuple[int, int],
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (0, 0),
    spectral_norm: bool = False,
) -> nn.Conv2d:
    """``nn.Conv2d`` of the period discriminators, the counterpart of the
    JAX package's ``Conv2d`` (``layers.py:242-310``): weight-normed (its
    ``weight_g`` is ``[C_out, 1, 1, 1]``), or a :class:`SpectralNormConv2d`
    with ``spectral_norm``."""
    if spectral_norm:
        return SpectralNormConv2d(in_channels, out_channels, kernel_size,
                                  stride=stride, padding=padding)
    return _weight_norm(nn.Conv2d(in_channels, out_channels, kernel_size,
                                  stride=stride, padding=padding))


def conv_transpose1d(
    in_channels: int, out_channels: int, kernel_size: int, stride: int,
    padding: int, init_std: float = 0.01,
) -> nn.ConvTranspose1d:
    """Weight-normed ``nn.ConvTranspose1d``; its ``weight_g`` is per INPUT
    channel (dim 0 of the ``[C_in, C_out, K]`` weight), as in the JAX
    package's ConvTranspose1d."""
    conv = nn.ConvTranspose1d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding)
    nn.init.normal_(conv.weight, 0.0, init_std)
    return _weight_norm(conv)


class LayerNorm(nn.Module):
    """Channel LayerNorm over dim 1 of ``[B, C, T]`` with fp32 statistics
    (reference ``modules.py:20-32``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float().transpose(1, -1), (self.channels,),
                         self.gamma.float(), self.beta.float(), self.eps)
        return y.transpose(1, -1).to(x.dtype)


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (reference ``modules.py:70-108``):
    n layers of [depthwise conv (dilation kⁱ) → LN → GELU → 1×1 → LN → GELU →
    dropout] with residual."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.drop = nn.Dropout(p_dropout)
        self.convs_sep = nn.ModuleList(
            conv1d(channels, channels, kernel_size, dilation=kernel_size ** i,
                   groups=channels)
            for i in range(n_layers)
        )
        self.convs_1x1 = nn.ModuleList(
            conv1d(channels, channels, 1) for _ in range(n_layers)
        )
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))

    def forward(self, x, x_mask, g=None):
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = self.convs_sep[i](x * x_mask)
            y = F.gelu(self.norms_1[i](y))
            y = self.convs_1x1[i](y)
            y = F.gelu(self.norms_2[i](y))
            x = x + self.drop(y)
        return x * x_mask


class WN(nn.Module):
    """WaveNet residual stack with gated-tanh units and global conditioning
    (reference ``modules.py:111-176``)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        self.drop = nn.Dropout(p_dropout)
        h = hidden_channels
        if gin_channels:
            self.cond_layer = conv1d(gin_channels, 2 * h * n_layers, 1,
                                     weight_norm=True)
        self.in_layers = nn.ModuleList(
            conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i,
                   weight_norm=True)
            for i in range(n_layers)
        )
        self.res_skip_layers = nn.ModuleList(
            conv1d(h, 2 * h if i < n_layers - 1 else h, 1, weight_norm=True)
            for i in range(n_layers)
        )

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        if g is not None:
            g = self.cond_layer(g)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g is not None:
                x_in = x_in + g[:, i * 2 * h:(i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = self.res_skip_layers[i](self.drop(acts))
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class ResBlock1(nn.Module):
    """HiFi-GAN MRF block, 3×(dilated + plain) conv pairs
    (reference ``modules.py:187-229``); the mask follows every activation."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            conv1d(channels, channels, kernel_size, dilation=d, weight_norm=True,
                   init_std=0.01)
            for d in dilation
        )
        self.convs2 = nn.ModuleList(
            conv1d(channels, channels, kernel_size, weight_norm=True, init_std=0.01)
            for _ in dilation
        )

    def forward(self, x, x_mask=None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            xt = F.leaky_relu(c1(xt), LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c2(xt) + x
        if x_mask is not None:
            x = x * x_mask
        return x


class ResBlock2(nn.Module):
    """HiFi-GAN light MRF block, 2 dilated convs (reference
    ``modules.py:232-256``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            conv1d(channels, channels, kernel_size, dilation=d, weight_norm=True,
                   init_std=0.01)
            for d in dilation
        )

    def forward(self, x, x_mask=None):
        for c in self.convs:
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c(xt) + x
        if x_mask is not None:
            x = x * x_mask
        return x


class FFN(nn.Module):
    """Conv feed-forward block of the text encoder (reference
    ``attentions.py:257-303``): torch-asymmetric same padding
    ((k−1)//2 left, k//2 right); its "gelu" is ``x·σ(1.702x)``."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 activation: Optional[str] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.activation = activation
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = conv1d(in_channels, filter_channels, kernel_size, padding=0)
        self.conv_2 = conv1d(filter_channels, out_channels, kernel_size, padding=0)

    def _pad(self, x):
        k = self.kernel_size
        return x if k == 1 else F.pad(x, ((k - 1) // 2, k // 2))

    def forward(self, x, x_mask):
        y = self.conv_1(self._pad(x * x_mask))
        if self.activation == "gelu":
            y = y * torch.sigmoid(1.702 * y)
        else:
            y = torch.relu(y)
        y = self.conv_2(self._pad(self.drop(y) * x_mask))
        return y * x_mask
