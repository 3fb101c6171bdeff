"""Carry the JAX package's parameters across into the port's state dicts.

The input is a JAX model's ``model.params`` pytree (``{"params": ...}``,
plus ``"batch_stats"`` for WeSpeaker) whose leaves the caller has already
turned into numpy arrays; this module never sees JAX. The output is the
reference torch state-dict layout, i.e. exactly what the JAX model's
``export_torch_state_dict`` emits (the inverse of its
``convert_torch_state_dict``), ready for the port's
``load_reference_state_dict``. ``write_reference_checkpoint`` writes
such a state dict as a reference-layout ``pytorch_model.bin``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def pyannet_state_dict(params_np: Mapping, hparams: Mapping
                       ) -> Dict[str, np.ndarray]:
    """PyanNet params + its ``hparams`` ({"lstm": {"num_layers",
    "bidirectional"}, "linear": {"num_layers"}}) -> ``sincnet.*``,
    ``lstm.*``, ``linear.*``, ``classifier.*`` keys."""
    p = params_np["params"]
    sn = p["sincnet"]
    state = {
        "sincnet.wav_norm1d.weight": _f32(sn["wav_norm1d"]["scale"]),
        "sincnet.wav_norm1d.bias": _f32(sn["wav_norm1d"]["bias"]),
        "sincnet.conv1d.0.filterbank.low_hz_":
            _f32(sn["sinc_conv"]["low_hz"]).reshape(-1, 1),
        "sincnet.conv1d.0.filterbank.band_hz_":
            _f32(sn["sinc_conv"]["band_hz"]).reshape(-1, 1),
    }
    for i in (0, 1, 2):
        state[f"sincnet.norm1d.{i}.weight"] = _f32(sn[f"norm1d_{i}"]["scale"])
        state[f"sincnet.norm1d.{i}.bias"] = _f32(sn[f"norm1d_{i}"]["bias"])
    for i in (1, 2):
        # flax conv kernel (k, in, out) -> torch (out, in, k)
        state[f"sincnet.conv1d.{i}.weight"] = \
            _f32(sn[f"conv1d_{i}"]["kernel"]).transpose(2, 1, 0)
        state[f"sincnet.conv1d.{i}.bias"] = _f32(sn[f"conv1d_{i}"]["bias"])
    suffixes = ("", "_reverse") if hparams["lstm"]["bidirectional"] \
        else ("",)
    for i in range(hparams["lstm"]["num_layers"]):
        for suffix in suffixes:
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                state[f"lstm.{theirs}_l{i}{suffix}"] = \
                    _f32(p["lstm"][f"{ours}_l{i}{suffix}"])
    for i in range(hparams["linear"]["num_layers"]):
        # flax dense kernel (in, out) -> torch (out, in)
        state[f"linear.{i}.weight"] = _f32(p[f"linear_{i}"]["kernel"]).T
        state[f"linear.{i}.bias"] = _f32(p[f"linear_{i}"]["bias"])
    state["classifier.weight"] = _f32(p["classifier"]["kernel"]).T
    state["classifier.bias"] = _f32(p["classifier"]["bias"])
    return state


def wespeaker_state_dict(variables_np: Mapping) -> Dict[str, np.ndarray]:
    """WeSpeaker ResNet {"params", "batch_stats"} -> ``resnet.*`` keys,
    BatchNorm running statistics included."""
    params = variables_np["params"]["trunk"]
    stats = variables_np["batch_stats"]["trunk"]
    state: Dict[str, np.ndarray] = {}

    def put_conv(prefix, p):
        # kernel (time, freq, in, out) -> torch (out, in, freq, time)
        state[f"{prefix}.weight"] = _f32(p["kernel"]).transpose(3, 2, 1, 0)

    def put_bn(prefix, p, s):
        state[f"{prefix}.weight"] = _f32(p["scale"])
        state[f"{prefix}.bias"] = _f32(p["bias"])
        state[f"{prefix}.running_mean"] = _f32(s["mean"])
        state[f"{prefix}.running_var"] = _f32(s["var"])
        state[f"{prefix}.num_batches_tracked"] = np.asarray(0,
                                                            dtype=np.int64)

    put_conv("resnet.conv1", params["conv1"])
    put_bn("resnet.bn1", params["bn1"], stats["bn1"])
    blocks = sorted((tuple(int(g) for g in m.groups()), name)
                    for name in params
                    if (m := re.fullmatch(r"layer(\d+)_(\d+)", name)))
    for (stage, i), name in blocks:
        prefix = f"resnet.layer{stage}.{i}"
        block, block_stats = params[name], stats[name]
        c = 1
        while f"conv{c}" in block:
            put_conv(f"{prefix}.conv{c}", block[f"conv{c}"])
            put_bn(f"{prefix}.bn{c}", block[f"bn{c}"], block_stats[f"bn{c}"])
            c += 1
        if "shortcut_conv" in block:
            put_conv(f"{prefix}.shortcut.0", block["shortcut_conv"])
            put_bn(f"{prefix}.shortcut.1", block["shortcut_bn"],
                   block_stats["shortcut_bn"])
    seg_1 = variables_np["params"]["seg_1"]
    state["resnet.seg_1.weight"] = _f32(seg_1["kernel"]).T
    state["resnet.seg_1.bias"] = _f32(seg_1["bias"])
    return state


def write_reference_checkpoint(state_dict: Mapping, architecture: str,
                               hparams: Mapping, specifications,
                               path) -> Path:
    """Write a reference-layout ``pytorch_model.bin`` that this package's
    ``Model.from_pretrained`` and the JAX package's both read.

    ``path`` is the file, or a directory to hold ``pytorch_model.bin``.
    The checkpoint is ``{"state_dict": float32 tensors,
    "hyper_parameters": hparams, "pyannote.audio": {"architecture":
    {"module", "class"}, "specifications": a plain dict}}``: it pickles
    no class of either package. ``specifications`` is the port's
    ``Specifications``, a dict in its ``to_dict`` layout, or None.
    """
    import torch
    path = Path(path)
    if path.suffix != ".bin":
        path = path / "pytorch_model.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    if specifications is not None and not isinstance(specifications,
                                                     Mapping):
        specifications = specifications.to_dict()
    vendor = {"architecture": {"module": "pyannote.audio",
                               "class": architecture}}
    if specifications is not None:
        vendor["specifications"] = dict(specifications)
    checkpoint = {
        "state_dict": {k: v.detach().cpu().clone()
                       if isinstance(v, torch.Tensor)
                       else torch.from_numpy(np.array(v))
                       for k, v in state_dict.items()},
        "hyper_parameters": dict(hparams),
        "pyannote.audio": vendor,
    }
    torch.save(checkpoint, path)
    return path
