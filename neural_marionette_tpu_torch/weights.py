"""Weights: the JAX package's parameter tree -> the port's ``state_dict``,
a reference ``.pth`` -> the port's detector or whole model, and random
initialisation from a seed.

The port's module tree uses the reference's ``state_dict`` key names, the
ones the JAX package's ``utils/torch_convert.py`` maps. This module holds
the port's own copy of those tables and runs them the other way:

* conv kernels ``(D, H, W, I, O)`` -> ``(O, I, D, H, W)``;
* a ConvTranspose kernel is flipped spatially back -> ``(I, O, D, H, W)``;
* linears and the GRU are transposed;
* the ``Upsample3DBlock`` bias moves back into its ConvTranspose;
* GroupNorm ``scale`` -> ``weight``.

:func:`state_dict_from_jax` is the inverse of ``convert_reference_state_dict``.
The reference's own ``network.state_dict()`` needs no table:
:func:`load_reference_detector` copies its ``kypt_detector.`` entries
straight into the port's detector, :func:`load_reference_checkpoint` all
of it into the whole model.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
import torch.nn as nn


def _conv_w(k):
    return np.transpose(k, (4, 3, 0, 1, 2))


def _convT_w(k):
    return np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


def _linear_w(w):
    return np.transpose(w)


# flax child -> reference Sequential entry, per block type
_BASIC = {"Conv_0": "block.0", "GroupNorm_0": "block.1"}
_POOL = {"Conv_0": "stride_conv.0", "GroupNorm_0": "stride_conv.1"}
_RES = {"Conv_0": "res_branch.0", "GroupNorm_0": "res_branch.1",
        "Conv_1": "res_branch.3", "GroupNorm_1": "res_branch.4",
        "Conv_2": "skip_con.0", "GroupNorm_2": "skip_con.1"}
_UP = {"ConvTranspose_0": "block.0", "GroupNorm_0": "block.1"}

# flax hourglass child -> (reference attribute, block table)
_HG = {
    "Res3DBlock_0": ("skip_res1", _RES),
    "Pool3DBlock_0": ("encoder_pool1", _POOL),
    "Res3DBlock_1": ("encoder_res1", _RES),
    "Res3DBlock_2": ("skip_res2", _RES),
    "Pool3DBlock_1": ("encoder_pool2", _POOL),
    "Res3DBlock_3": ("encoder_res2", _RES),
    "Res3DBlock_4": ("skip_res3", _RES),
    "Pool3DBlock_2": ("encoder_pool3", _POOL),
    "Res3DBlock_5": ("encoder_res3", _RES),
    "Res3DBlock_6": ("decoder_res3", _RES),
    "Upsample3DBlock_0": ("decoder_upsample3", _UP),
    "Res3DBlock_7": ("decoder_res2", _RES),
    "Upsample3DBlock_1": ("decoder_upsample2", _UP),
    "Res3DBlock_8": ("decoder_res1", _RES),
    "Upsample3DBlock_2": ("decoder_upsample1", _UP),
}

# flax feature-net child -> (reference Sequential index, block table)
_FEATURE_NET = {
    "Basic3DBlock_0": ("0", _BASIC),
    "Pool3DBlock_0": ("1", _POOL),
    "Res3DBlock_0": ("2", _RES),
    "Pool3DBlock_1": ("3", _POOL),
    "Hourglass_0": ("4", _HG),
    "Res3DBlock_1": ("5", _RES),
}

# flax VoxelDecoder child -> reference Sequential index
_DECODER = {"Conv_0": "1", "GroupNorm_0": "2", "Conv_1": "4",
            "GroupNorm_1": "5", "Conv_2": "8", "GroupNorm_2": "9",
            "Conv_3": "11", "GroupNorm_3": "12", "Conv_4": "14"}

_DYNA_LINEAR = {
    "post_l1": "extract_post_dist.0", "post_l2": "extract_post_dist.2",
    "prior_l1": "extract_prior_dist.0", "prior_l2": "extract_prior_dist.2",
    "root_l1": "root_intensity_decoder.0",
    "root_l2": "root_intensity_decoder.2",
    "joint_l1": "joint_matrix_decoder.0",
    "joint_l2": "joint_matrix_decoder.2",
}

_GRU = {"gru_w_ih": "weight_ih", "gru_w_hh": "weight_hh",
        "gru_b_ih": "bias_ih", "gru_b_hh": "bias_hh"}

Entry = Iterator[tuple[str, np.ndarray]]


def _layer(prefix: str, leaves: Mapping, conv_w: Callable = _conv_w) -> Entry:
    """One flax Conv / ConvTranspose / GroupNorm -> weight and bias."""
    for leaf, value in leaves.items():
        if leaf == "kernel":
            yield f"{prefix}.weight", conv_w(value)
        elif leaf == "scale":
            yield f"{prefix}.weight", value
        elif leaf == "bias":
            yield f"{prefix}.bias", value
        else:
            raise KeyError(f"unmapped leaf {prefix}/{leaf}")


def _block(prefix: str, params: Mapping, table: Mapping) -> Entry:
    """A Basic/Pool/Res/Upsample block, or an hourglass of them."""
    for child, value in params.items():
        if table is _HG or table is _FEATURE_NET:
            name, sub = table[child]
            yield from _block(f"{prefix}.{name}", value, sub)
        elif table is _UP and child == "bias":
            # the block-level bias (output-padding aware) is the
            # ConvTranspose's own bias in the reference tree
            yield f"{prefix}.block.0.bias", value
        elif child == "ConvTranspose_0":
            yield from _layer(f"{prefix}.{table[child]}", value, _convT_w)
        else:
            yield from _layer(f"{prefix}.{table[child]}", value)


def _detector(params: Mapping) -> Entry:
    base = "kypt_detector"
    for name, value in params.items():
        if name == "affinity_params":
            yield f"{base}.affinity_params", value
        elif name == "vox_to_kypt":
            yield from _vox_to_kypt(f"{base}.vox_to_kypt", value)
        elif name == "kypt_to_vox":
            yield from _kypt_to_vox(f"{base}.kypt_to_vox", value)
        else:
            raise KeyError(f"unmapped detector param {name}")


def _vox_to_kypt(prefix: str, params: Mapping) -> Entry:
    heads = {"extract_heatmaps": "extract_heatmaps_from_features",
             "extract_st_heatmaps":
                 "extract_spatio_temporal_heatmaps_from_features"}
    nets = {"extract_features": "extract_features",
            "extract_st_features": "extract_spatio_temporal_features"}
    for name, value in params.items():
        if name in nets:
            yield from _block(f"{prefix}.{nets[name]}", value, _FEATURE_NET)
        elif name in heads:
            yield from _layer(f"{prefix}.{heads[name]}.0", value["Conv_0"])
        elif name == "propagate_kernel":
            yield f"{prefix}.propagate_heatmaps.0.weight", _conv_w(value)
        elif name == "propagate_bias":
            yield f"{prefix}.propagate_heatmaps.0.bias", value
        elif name == "initial_heatmaps":
            # (g, g, g, K) -> the reference's (K, g, g, g)
            yield f"{prefix}.initial_heatmaps", np.transpose(
                np.asarray(value), (3, 0, 1, 2))
        elif name == "sigmas":
            yield f"{prefix}.sigmas", value
        else:
            raise KeyError(f"unmapped vox_to_kypt param {name}")


def _kypt_to_vox(prefix: str, params: Mapping) -> Entry:
    for name, value in params.items():
        if name == "Conv_0":
            yield from _layer(f"{prefix}.adjust_combined_representation.0",
                              value)
        elif name in ("VoxelDecoder_0", "CheckpointVoxelDecoder_0"):
            # the JAX package's decoder takes the second name under
            # nn.remat (cfg.remat >= 1); its children keep theirs
            for child, leaves in value.items():
                yield from _layer(
                    f"{prefix}.decode_voxel_from_combined_representation."
                    f"{_DECODER[child]}", leaves)
        else:
            raise KeyError(f"unmapped kypt_to_vox param {name}")


def _dynamics(params: Mapping) -> Entry:
    base = "dyna_module"
    for name, value in params.items():
        layer, _, leaf = name.rpartition("_")
        if layer in _DYNA_LINEAR:
            ref = f"{base}.{_DYNA_LINEAR[layer]}"
            if leaf == "w":
                yield f"{ref}.weight", _linear_w(value)
            else:
                yield f"{ref}.bias", value
        elif name in _GRU:
            w = _linear_w(value) if name.startswith("gru_w") else value
            yield f"{base}.kypt_rnn_cell.{_GRU[name]}", w
        elif name in ("init_kypt_rnn_state", "offset_param"):
            yield f"{base}.{name}", value
        else:
            raise KeyError(f"unmapped dyna param {name}")


def _tensor(arr) -> torch.Tensor:
    """A float32 tensor that owns a copy of ``arr``."""
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree (leaves as numpy arrays or
    anything ``np.asarray`` takes) -> the port's ``state_dict``."""
    tree = params["params"]
    out: dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name == "kypt_detector":
            entries = _detector(value)
        elif name == "dyna_module":
            entries = _dynamics(value)
        else:
            raise KeyError(f"unmapped top-level param {name}")
        for key, arr in entries:
            out[key] = _tensor(arr)
    return out


def block_state_dict(params: Mapping[str, Any], kind: str) -> dict:
    """One JAX block's params (``Basic3DBlock``, ``Pool3DBlock``,
    ``Res3DBlock``, ``Upsample3DBlock`` or ``Hourglass``) -> the state_dict
    of the port's block of the same name."""
    table = {"Basic3DBlock": _BASIC, "Pool3DBlock": _POOL,
             "Res3DBlock": _RES, "Upsample3DBlock": _UP,
             "Hourglass": _HG}[kind]
    return {k[1:]: _tensor(v) for k, v in _block("", params, table)}


# ------------------------------------------------------- pretrained detector
DETECTOR_PREFIX = "kypt_detector."


@torch.no_grad()
def _copy_checked(own: Mapping[str, torch.Tensor], given: Mapping[str, Any],
                  what: str, source: str) -> None:
    """Copy ``given`` into the tensors ``own`` in place. Raises ``KeyError``
    on a key of ``own`` that ``given`` lacks or a key of ``given`` that
    ``own`` lacks, ``ValueError`` on a shape that differs."""
    missing = sorted(own.keys() - given.keys())
    unmapped = sorted(given.keys() - own.keys())
    if missing or unmapped:
        raise KeyError(f"{source}: {what} keys missing {missing[:4]} "
                       f"({len(missing)}), unmapped {unmapped[:4]} "
                       f"({len(unmapped)})")
    for k, dst in own.items():
        src = torch.as_tensor(given[k])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{source}: {k} has shape {tuple(src.shape)}, "
                             f"the model {tuple(dst.shape)}")
        dst.copy_(src)


def load_detector_state(model: nn.Module, state: Mapping[str, Any],
                        source: str = "state dict") -> None:
    """Copy the ``kypt_detector.`` entries of ``state`` (reference key names,
    the port's own) into ``model``'s detector in place; other entries are
    ignored. Raises ``KeyError`` on a detector key that ``state`` lacks or
    that the model does not have, ``ValueError`` on a shape that differs."""
    own = {k: v for k, v in model.state_dict(keep_vars=True).items()
           if k.startswith(DETECTOR_PREFIX)}
    given = {k: v for k, v in state.items() if k.startswith(DETECTOR_PREFIX)}
    _copy_checked(own, given, "detector", source)


def load_reference_detector(path: str, model: nn.Module) -> None:
    """Load the detector of a reference-layout ``.pth`` (a
    ``network.state_dict()``) into ``model``; its other keys are ignored.
    Counterpart of ``load_torch_detector`` of the JAX package's
    ``utils/torch_convert.py``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    load_detector_state(model, state, source=path)


def load_reference_checkpoint(path: str, model: nn.Module) -> None:
    """Load a whole reference-layout ``.pth`` (``network.state_dict()``:
    detector and dynamics) into ``model`` in place. Counterpart of
    ``load_reference_checkpoint`` of the JAX package's
    ``utils/torch_convert.py``, whose converter drops no key on purpose: it
    maps every key of the reference's tree and raises on any other. So this
    loader is strict on every key, detector and dynamics alike: a key the
    model has and the file lacks, or one the file has and the model lacks,
    raises ``KeyError``; a shape that differs ``ValueError``. Which keys a
    model has follows its configuration, as the reference's tree does:
    ``kypt_detector.vox_to_kypt.sigmas`` with ``fixed_sigma=0``,
    ``.initial_heatmaps`` with ``const_intensity=1``, the spatio-temporal
    net with ``const_intensity`` 2-4, ``.propagate_heatmaps`` unless it is
    0, ``kypt_detector.affinity_params`` with ``keypoints_graph=
    "affinity_params"``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    _copy_checked(model.state_dict(keep_vars=True), state, "network", path)


# ------------------------------------------------------------- random init
BLOCK_CONV_STD = 0.001  # convs inside the *Block modules (reference weights_init)
PLAIN_CONV_STD = 0.02   # the other convs


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's initial distributions: block
    convs N(0, 0.001), other convs N(0, 0.02), conv biases 0, GroupNorm
    (1, 0), affinity params N(0, 1) with ``graph_random_init``, else 0 for
    ``affinity_ver`` < 3 and 1 from 3 on, linears and the GRU
    uniform(+-1/sqrt(fan_in)) (torch's defaults), the initial GRU state,
    the offset directions, the learned sigmas and the initial heatmaps
    N(0, 1). Draws on the CPU from ``generator``, so a seed gives the same
    weights on every device."""
    from .models.blocks import (Basic3DBlock, Pool3DBlock, Res3DBlock,
                                Upsample3DBlock)
    block_types = (Basic3DBlock, Pool3DBlock, Res3DBlock, Upsample3DBlock)
    in_block = set()
    for m in model.modules():
        if isinstance(m, block_types):
            in_block.update(id(c) for c in m.modules())

    def put(p, value):
        p.copy_(value.to(p.device))

    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            std = BLOCK_CONV_STD if id(m) in in_block else PLAIN_CONV_STD
            put(m.weight, torch.randn(m.weight.shape, generator=generator)
                * std)
            put(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.GroupNorm):
            put(m.weight, torch.ones(m.weight.shape))
            put(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                put(p, (torch.rand(p.shape, generator=generator) * 2 - 1)
                    * bound)
        elif isinstance(m, nn.GRUCell):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                put(p, (torch.rand(p.shape, generator=generator) * 2 - 1)
                    * bound)
    cfg = getattr(model, "cfg", None)   # a detector's or a whole model's
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf == "affinity_params":
            if cfg.graph_random_init:
                put(p, torch.randn(p.shape, generator=generator))
            else:
                put(p, torch.full(p.shape, 0.0 if cfg.affinity_ver < 3
                                  else 1.0))
        elif leaf in ("init_kypt_rnn_state", "offset_param", "sigmas",
                      "initial_heatmaps"):
            put(p, torch.randn(p.shape, generator=generator))
