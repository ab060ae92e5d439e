"""The port's configuration, skeleton extraction and weight bridge against
the JAX package's. Everything here is exact: configurations and skeletons
are equal, and the weights survive the round trip JAX -> port -> JAX to
the bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from neural_marionette_tpu import config as JC
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.utils.torch_convert import \
    convert_reference_state_dict

from neural_marionette_tpu_torch import config as PC
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.skeleton import extract_skeleton
from neural_marionette_tpu_torch.weights import (init_weights,
                                                 state_dict_from_jax)

from _torch_port import jax_params

DATASETS = ("dfaust", "aist", "animals", "panda", "hanco", "hands",
            "humanoids", "synthetic")


def test_config_defaults_equal():
    assert dataclasses.asdict(PC.MarionetteConfig()) == \
        dataclasses.asdict(JC.MarionetteConfig())


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("pretrained_mode", [0, 1])
def test_adjust_config_equal(dataset, pretrained_mode):
    kw = dict(dataset=dataset, pretrained_mode=pretrained_mode)
    assert dataclasses.asdict(PC.adjust_config(PC.MarionetteConfig(**kw))) \
        == dataclasses.asdict(JC.adjust_config(JC.MarionetteConfig(**kw)))


def test_adjust_config_rejects_unknown_dataset():
    for mod in (PC, JC):
        with pytest.raises(ValueError):
            mod.adjust_config(mod.MarionetteConfig(dataset="nope"))


def test_aist_preset_is_the_supported_configuration():
    cfg = PC.adjust_config(PC.MarionetteConfig(dataset="aist"))
    PC.check_supported(cfg)
    assert (cfg.grid_size, cfg.nkeypoints, cfg.feat_dim, cfg.Ttot) == \
        (64, 24, 128, 10)
    for name, value in (("keypoints_graph", "none"), ("fixed_sigma", 0)):
        with pytest.raises(NotImplementedError, match=name):
            PC.check_supported(dataclasses.replace(cfg, **{name: value}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skeleton_extraction_equal(seed):
    """The port's copy of the host extraction gives the JAX package's
    skeleton exactly, on random and on tie-heavy affinities."""
    g = np.random.default_rng(seed)
    K = 24
    aff = g.uniform(0, 1, (2, K, K, 1)).astype(np.float32)
    if seed == 2:
        aff = np.round(aff * 3) / 3  # many exactly equal entries
    for a, b in zip(extract_skeleton(aff), jax_skeleton(aff)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def aist_weights():
    """Random JAX parameters at the AIST preset's full width, and the
    port's state dict made from them."""
    jcfg = JC.adjust_config(JC.MarionetteConfig(dataset="aist"))
    _, params = jax_params(jcfg, seed=4)
    cfg = PC.MarionetteConfig(**dataclasses.asdict(jcfg))
    return cfg, params, state_dict_from_jax(params)


def test_state_dict_from_jax_loads_strict(aist_weights):
    cfg, _, sd = aist_weights
    model = NeuralMarionette(cfg)
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k


def test_state_dict_round_trips_to_every_jax_leaf(aist_weights):
    """Port state dict -> the JAX package's ``convert_reference_state_dict``
    -> the original tree, every leaf exactly. A wrong ConvTranspose flip, a
    missing transpose or a misplaced Upsample3DBlock bias fails here."""
    _, params, sd = aist_weights
    back = convert_reference_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_init_weights_is_seeded_and_shaped_like_jax_init():
    """``init_weights`` draws from the generator: same seed, same weights;
    block convs have std ~1e-3, plain convs ~2e-2, affinity params 1."""
    cfg = PC.MarionetteConfig(grid_size=32, feat_dim=32, nkeypoints=6,
                              nlatent_kypt=16, nhidden_kypt=32)
    a, b, c = (NeuralMarionette(cfg) for _ in range(3))
    for m, s in ((a, 1), (b, 1), (c, 2)):
        init_weights(m, torch.Generator().manual_seed(s))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["dyna_module.offset_param"],
                           sc["dyna_module.offset_param"])
    det = "kypt_detector.vox_to_kypt."
    block = sa[det + "extract_features.0.block.0.weight"]
    plain = sa[det + "extract_heatmaps_from_features.0.weight"]
    assert 5e-4 < block.std() < 2e-3 and 1e-2 < plain.std() < 4e-2
    assert torch.equal(sa["kypt_detector.affinity_params"],
                       torch.ones_like(sa["kypt_detector.affinity_params"]))
