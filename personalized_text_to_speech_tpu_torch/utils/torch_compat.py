"""Weights across: the JAX package's flax params → this port's state dict,
and reference ``G_*.pth``/``D_*.pth`` files → the port's modules and back.

Counterpart of ``personalized_text_to_speech_tpu/utils/torch_compat.py``
(``_module_path_to_torch`` at ``:47``, ``_from_flax_tensor`` at ``:134``,
``torch_to_flax`` at ``:168``, ``flax_to_torch`` at ``:250``,
``save_torch_checkpoint`` at ``:272``), written without flax: the params come
in as a nested dict of numpy arrays (``{"params": {...}}`` or the inner tree).

* Names: flax module names like ``attn_layers_0/conv_q/kernel`` become
  ``attn_layers.0.conv_q.weight``; flow containers interleave
  parameterless ``Flip`` modules, so ``coupling_{i}`` ↔ ``flow.flows.{2i}``
  and ``flows_conv_{i}`` ↔ ``dp.flows.{1+2i}`` (likewise ``post_flows``);
  the discriminators ``disc_s`` and ``disc_p{2,3,5,7,11}`` are
  ``discriminators.0`` and ``discriminators.1..5``.
* Layouts: Conv1d ``[k,in,out] → [out,in,k]``; ConvTranspose1d
  ``[k,in,out] → [in,out,k]`` with the weight-norm ``g`` per INPUT
  channel; Conv2d ``[kh,kw,in,out] → [out,in,kh,kw]``; ``g`` takes its
  weight's rank (``[c,1,1]``, or ``[c,1,1,1]`` beside a Conv2d);
  ElementwiseAffine ``[c] → [c,1]``.
* Reference checkpoints load as the JAX package's ``torch_to_flax`` loads
  them (:func:`load_partial_state_dict`): keys the file lacks keep their
  fresh values and are logged, and the speaker table loads row by row
  whatever the two speaker counts.
* The spectral-norm discriminator: the ``w_orig`` param is
  ``weight_orig`` (a kernel's layout), and the ``spectral`` collection's
  ``u``/``v`` leaves are the ``weight_u``/``weight_v`` buffers, already in
  torch's ``weight.reshape(C_out, -1)`` column order (JAX ``:93-106``).
  The other way is the port's own state dict: its keys are the reference's,
  so a port ``D_*.pth`` loads into the JAX package's ``torch_to_flax``.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_TRAILING_INDEX = re.compile(r"^(.*)_(\d+)$")

# module names whose trailing _<digit> is literal in the reference, not a
# ModuleList index (FFN's conv_1/conv_2, attentions.py:273-274;
# DurationPredictor's norm_1/norm_2, models.py:110-112)
_LITERAL_NAMES = {"conv_1", "conv_2", "norm_1", "norm_2"}

_PERIOD_INDEX = {2: 1, 3: 2, 5: 3, 7: 4, 11: 5}

_LEAF_NAMES = {
    "kernel": "weight",
    "w_orig": "weight_orig",
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
        elif part == "disc_s":
            out.append("discriminators.0")
        elif part.startswith("disc_p"):
            # period order (2,3,5,7,11) → discriminators.1..5
            period = int(part[len("disc_p"):])
            out.append(f"discriminators.{_PERIOD_INDEX[period]}")
        elif part in _LITERAL_NAMES:
            out.append(part)
        else:
            m = _TRAILING_INDEX.match(part)
            out.append(f"{m.group(1)}.{m.group(2)}" if m else part)
    leaf = parts[-1]
    return ".".join(out + [_LEAF_NAMES.get(leaf, leaf)])


def _from_flax_tensor(parts: Tuple[str, ...], a: np.ndarray,
                      weight_rank: int = 3) -> np.ndarray:
    """Layout transform flax → torch for one leaf; ``weight_rank`` is the
    rank of the weight a ``g`` belongs to."""
    leaf = parts[-1]
    if leaf in ("kernel", "v", "w_orig") and a.ndim == 3:
        if any(p.startswith("ups_") for p in parts):
            return a.transpose(1, 2, 0)  # [k,in,out] → [in,out,k]
        return a.transpose(2, 1, 0)  # [k,in,out] → [out,in,k]
    if leaf in ("kernel", "v", "w_orig") and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # [kh,kw,in,out] → [out,in,kh,kw]
    if leaf == "g":
        return a.reshape((-1,) + (1,) * (weight_rank - 1))
    if leaf in ("m", "logs") and a.ndim == 1:
        return a.reshape(-1, 1)
    return a


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict of arrays) → this port's state dict.  Works
    for any tree of the params' structure, gradients among them; a
    ``spectral`` collection beside ``params`` becomes the
    ``weight_u``/``weight_v`` buffers."""
    tree = params["params"] if "params" in params else params
    flat = dict(_flatten(tree))
    out = {}
    for parts, value in flat.items():
        v = flat.get(parts[:-1] + ("v",))
        rank = np.ndim(v) if v is not None else 3
        a = _from_flax_tensor(parts, np.asarray(value), rank)
        out[_module_path_to_torch(parts)] = _tensor(a)
    for parts, value in _flatten(params.get("spectral", {})):
        # the module's path, then weight_u / weight_v
        prefix = _module_path_to_torch(parts[:-1] + ("bias",))[: -len("bias")]
        out[f"{prefix}weight_{parts[-1]}"] = _tensor(np.asarray(value))
    return out


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read a reference-layout ``.pth`` (``{model, iteration, optimizer,
    learning_rate}``, reference ``utils.py:183-193``) → (state dict, meta).
    Tensors and plain containers only (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    meta = {k: ckpt.get(k) for k in ("iteration", "learning_rate")} \
        if isinstance(ckpt, dict) else {}
    return dict(state), meta


def load_partial_state_dict(
    module: torch.nn.Module,
    state: Mapping[str, torch.Tensor],
    drop_speaker_embed: bool = False,
) -> List[str]:
    """Load a reference-layout state dict into ``module`` the way the JAX
    package's ``torch_to_flax`` loads a ``.pth`` (reference
    ``utils.py:160-173``); returns the keys that kept their fresh values.

    Keys the file lacks keep the module's values and are logged; the
    speaker table ``emb_g.weight`` loads as many rows as both tables have,
    so a 999-speaker model fine-tunes onto a few speakers and back;
    ``drop_speaker_embed`` keeps every fresh speaker row; any other shape
    mismatch keeps the fresh tensor with a warning.
    """
    merged = dict(module.state_dict())
    fresh = []
    for key, mine in merged.items():
        if drop_speaker_embed and key == "emb_g.weight":
            fresh.append(key)
            continue
        if key not in state:
            logger.info("%s is not in the checkpoint", key)
            fresh.append(key)
            continue
        theirs = state[key].to(mine.dtype)
        if theirs.shape != mine.shape:
            if key == "emb_g.weight":
                n = min(theirs.shape[0], mine.shape[0])
                rows = mine.clone()
                rows[:n] = theirs[:n]
                theirs = rows
                logger.info("partial speaker-embedding load: %d of %d rows",
                            n, mine.shape[0])
            else:
                logger.warning("shape mismatch for %s: checkpoint %s, model %s "
                               "- keeping fresh init", key,
                               tuple(theirs.shape), tuple(mine.shape))
                fresh.append(key)
                continue
        merged[key] = theirs
    unused = sorted(set(state) - set(merged))
    if unused:
        logger.info("unused checkpoint keys: %s", unused[:10])
    module.load_state_dict(merged, strict=True)
    return fresh


def save_torch_checkpoint(
    state_dict: Mapping[str, torch.Tensor],
    path: str,
    iteration: int = 0,
    learning_rate: float = 2e-4,
) -> None:
    """Write a reference-layout ``.pth`` (reference ``utils.py:183-193``):
    ``{model, iteration, optimizer: None, learning_rate}``, tensors on the
    CPU."""
    torch.save(
        {
            "model": {k: v.detach().cpu() for k, v in state_dict.items()},
            "iteration": iteration,
            "optimizer": None,
            "learning_rate": learning_rate,
        },
        path,
    )
