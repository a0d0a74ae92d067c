"""Weights across: the JAX package's flax params → this port's state dict,
and reference ``G_*.pth`` files → the same.

Counterpart of ``personalized_text_to_speech_tpu/utils/torch_compat.py``
(``_module_path_to_torch`` at ``:47``, ``_from_flax_tensor`` at ``:134``,
``flax_to_torch`` at ``:250``), written without flax: the params come in as
a nested dict of numpy arrays (``{"params": {...}}`` or the inner tree).

* Names: flax module names like ``attn_layers_0/conv_q/kernel`` become
  ``attn_layers.0.conv_q.weight``; flow containers interleave
  parameterless ``Flip`` modules, so ``coupling_{i}`` ↔ ``flow.flows.{2i}``
  and ``flows_conv_{i}`` ↔ ``dp.flows.{1+2i}`` (likewise ``post_flows``).
* Layouts: Conv1d ``[k,in,out] → [out,in,k]``; ConvTranspose1d
  ``[k,in,out] → [in,out,k]`` with the weight-norm ``g`` per INPUT
  channel; ``g`` → ``[c,1,1]``; ElementwiseAffine ``[c] → [c,1]``.

The discriminators' names and spectral-norm buffers join when the
discriminators are ported.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_TRAILING_INDEX = re.compile(r"^(.*)_(\d+)$")

# module names whose trailing _<digit> is literal in the reference, not a
# ModuleList index (FFN's conv_1/conv_2, attentions.py:273-274;
# DurationPredictor's norm_1/norm_2, models.py:110-112)
_LITERAL_NAMES = {"conv_1", "conv_2", "norm_1", "norm_2"}

_LEAF_NAMES = {
    "kernel": "weight",
    "v": "weight_v",
    "g": "weight_g",
    "emb": "emb.weight",
    "embedding": "weight",
}


def _module_path_to_torch(parts: Tuple[str, ...]) -> str:
    """Map a flax param path (module names + leaf) to a state-dict key."""
    out = []
    for part in parts[:-1]:
        if part.startswith("coupling_"):
            out.append(f"flows.{2 * int(part.split('_')[-1])}")
        elif part == "flows_pre":
            out.append("flows.0")
        elif part.startswith("flows_conv_"):
            out.append(f"flows.{1 + 2 * int(part.split('_')[-1])}")
        elif part == "post_flows_pre":
            out.append("post_flows.0")
        elif part.startswith("post_flows_conv_"):
            out.append(f"post_flows.{1 + 2 * int(part.split('_')[-1])}")
        elif part in _LITERAL_NAMES:
            out.append(part)
        else:
            m = _TRAILING_INDEX.match(part)
            out.append(f"{m.group(1)}.{m.group(2)}" if m else part)
    leaf = parts[-1]
    return ".".join(out + [_LEAF_NAMES.get(leaf, leaf)])


def _from_flax_tensor(parts: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    """Layout transform flax → torch for one leaf."""
    leaf = parts[-1]
    if leaf in ("kernel", "v") and a.ndim == 3:
        if any(p.startswith("ups_") for p in parts):
            return a.transpose(1, 2, 0)  # [k,in,out] → [in,out,k]
        return a.transpose(2, 1, 0)  # [k,in,out] → [out,in,k]
    if leaf == "g":
        return a.reshape(-1, 1, 1)
    if leaf in ("m", "logs") and a.ndim == 1:
        return a.reshape(-1, 1)
    return a


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict of arrays) → this port's state dict."""
    tree = params["params"] if "params" in params else params
    return {
        _module_path_to_torch(parts): torch.from_numpy(
            np.array(_from_flax_tensor(parts, np.asarray(value)), copy=True)
        )
        for parts, value in _flatten(tree)
    }


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read a reference-layout ``.pth`` (``{model, iteration, optimizer,
    learning_rate}``, reference ``utils.py:183-193``) → (state dict, meta).
    Tensors and plain containers only (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    meta = {k: ckpt.get(k) for k in ("iteration", "learning_rate")} \
        if isinstance(ckpt, dict) else {}
    return dict(state), meta
