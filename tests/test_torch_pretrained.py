"""Two-phase training in the port against the JAX package, on the CPU:
``derive_training_id``, the reference-detector loader against the JAX
package's ``load_torch_detector`` (to the bit), a ``pretrained_mode=1``
``Trainer`` started from a detector run's checkpoint and from a reference
``.pth`` (the detector loaded to the bit, the dynamics as initialised, the
detector frozen to the bit through a learner epoch, the skeleton of the
loaded affinity), and ``resume_epoch``. Every ``.pth`` is written by the
test from seeded random tensors of the reference layout.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from neural_marionette_tpu import config as JC
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.utils.torch_convert import load_torch_detector

from neural_marionette_tpu_torch import config as PC
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.train import Trainer, load_params_only
from neural_marionette_tpu_torch.weights import (load_reference_detector,
                                                 state_dict_from_jax)

from _torch_port import configs, jax_params, moving_vox, randomize

DATASETS = ("dfaust", "aist", "animals", "panda", "hanco", "hands",
            "humanoids", "synthetic")
DET = "kypt_detector."


# ------------------------------------------------------------ config
@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("pretrained_mode", [0, 1])
def test_derive_training_id_equal(dataset, pretrained_mode):
    kw = dict(dataset=dataset, pretrained_mode=pretrained_mode)
    got = PC.derive_training_id(PC.adjust_config(PC.MarionetteConfig(**kw)))
    want = JC.derive_training_id(JC.adjust_config(JC.MarionetteConfig(**kw)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if pretrained_mode == 1:
        assert (got.detector_end, got.learner_start) == (0, 0)


def test_derive_training_id_clamps_gifs_and_rejects_mode_2():
    for mod in (PC, JC):
        cfg = mod.derive_training_id(mod.MarionetteConfig(nbatch=3,
                                                          log_gif_num=8))
        assert cfg.log_gif_num == 3
        with pytest.raises(ValueError, match="mode 2"):
            mod.derive_training_id(mod.MarionetteConfig(pretrained_mode=2))


# ------------------------------------------------------------ fixtures
@dataclasses.dataclass(frozen=True)
class _JaxState:
    """What ``load_torch_detector`` reads and replaces of a TrainState."""
    params: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = configs(dataset="aist", detector_start=0, detector_end=5,
                        learner_start=5, affinity_anneal=0, lrate=1e-3,
                        nepoch=3, save_every=1, save_que_len=5)
    model, params = jax_params(jcfg, seed=5)
    return jcfg, cfg, model, params


def _reference_pth(path, cfg, seed, drop=None, extra=None):
    """A reference-layout ``.pth`` (``network.state_dict()``) of seeded
    random tensors: every key of the model, detector and dynamics, and one
    key outside both. Returns the tensors written."""
    g = np.random.default_rng(seed)
    state = {k: torch.from_numpy(g.normal(0, 0.1, v.shape).astype(np.float32))
             for k, v in NeuralMarionette(cfg).state_dict().items()}
    state["num_batches_seen"] = torch.tensor(7)
    if drop is not None:
        del state[drop]
    state.update(extra or {})
    torch.save(state, path)
    return state


def _net(cfg, params):
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params))
    return net


def _batches(cfg, seed):
    _, pts = moving_vox(B=2, T=cfg.Ttot, G=cfg.grid_size, seed=seed)
    return [pts]


@pytest.fixture(scope="module")
def detector_run(small, tmp_path_factory):
    """A detector run of three epochs checkpointed each epoch under
    ``<root>/detector/aist_detector``, as the dynamics run looks for it."""
    _, cfg, _, params = small
    root = tmp_path_factory.mktemp("pretrained")
    path = root / "detector" / "aist_detector"
    trainer = Trainer(cfg, device="cpu", dtype="float32",
                      model=_net(cfg, params), logger_path=str(path))
    records = list(trainer.fit(_batches(cfg, seed=1)))
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(r["phase"]["detector"] for r in records)
    detector = {k: v.detach().clone()
                for k, v in trainer.model.state_dict().items()
                if k.startswith(DET)}
    return root, path, detector


def _dyna_config(cfg, root):
    return PC.derive_training_id(dataclasses.replace(
        cfg, pretrained_mode=1, pretrained_dir=str(root), nepoch=1))


# ------------------------------------------------------------ loaders
def test_reference_detector_equals_jax_load_torch_detector(small, tmp_path):
    """The same ``.pth`` through the JAX package's ``load_torch_detector``
    and through the port's loader: every detector tensor equal to the bit,
    and equal to what was written; the dynamics and the extra key ignored."""
    jcfg, cfg, _, params = small
    path = tmp_path / "network.pth"
    written = _reference_pth(path, cfg, seed=11)
    state = load_torch_detector(str(path), _JaxState(params), jcfg)
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    net = _net(cfg, params)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    load_reference_detector(str(path), net)
    got = net.state_dict()
    n_det = 0
    for k, v in got.items():
        if k.startswith(DET):
            assert torch.equal(v, want[k]) and torch.equal(v, written[k]), k
            n_det += 1
        else:
            assert torch.equal(v, before[k]), k
    assert n_det == len([k for k in want if k.startswith(DET)]) > 0


def test_reference_detector_missing_or_unmapped_key_raises(small, tmp_path):
    jcfg, cfg, _, params = small
    key = "kypt_detector.vox_to_kypt.propagate_heatmaps.0.bias"
    missing = tmp_path / "missing.pth"
    _reference_pth(missing, cfg, seed=12, drop=key)
    with pytest.raises(KeyError, match="missing"):
        load_reference_detector(str(missing), _net(cfg, params))
    unmapped = tmp_path / "unmapped.pth"
    _reference_pth(unmapped, cfg, seed=13, extra={
        "kypt_detector.vox_to_kypt.unknown_head.0.weight": torch.zeros(2)})
    with pytest.raises(KeyError, match="unknown_head"):
        load_reference_detector(str(unmapped), _net(cfg, params))
    with pytest.raises(KeyError):   # the JAX converter refuses it too
        load_torch_detector(str(unmapped), _JaxState(params), jcfg)


# ------------------------------------------------------------ two phases
def test_dynamics_run_from_a_port_checkpoint(small, detector_run):
    """``pretrained_mode=1`` with no checkpoint of its own: the detector of
    the detector run's latest checkpoint to the bit, the dynamics as
    initialised; after a learner epoch the detector is unchanged to the bit,
    the dynamics moved, and the skeleton is the JAX package's extraction
    from the loaded affinity."""
    _, cfg, jmodel, params = small
    root, _, detector = detector_run
    dcfg = _dyna_config(cfg, root)
    net = _net(dcfg, randomize(params, seed=6))
    init = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = Trainer(dcfg, device="cpu", dtype="float32", model=net)
    assert trainer.start_epoch == 0
    sd = trainer.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, detector[k] if k.startswith(DET) else init[k]), k
    record = trainer.train_epoch(0, _batches(cfg, seed=2))
    assert (record["phase"]["detector"], record["phase"]["learner"]) == \
        (False, True)
    assert np.isfinite(record["train"]["total_loss"])
    sd = trainer.model.state_dict()
    for k in detector:
        assert torch.equal(sd[k], detector[k]), k
    assert any(not torch.equal(sd[k], init[k]) for k in sd
               if k.startswith("dyna_module."))
    tree = jax.tree.map(np.asarray, params)
    tree["params"]["kypt_detector"]["affinity_params"] = \
        detector[DET + "affinity_params"].numpy()
    aff = jmodel.apply(tree, method=lambda m: m.kypt_detector.get_affinity())
    for a, b in zip(trainer.skeleton, jax_skeleton(np.asarray(aff))):
        np.testing.assert_array_equal(a, b)


def test_dynamics_run_from_a_reference_pth(small, tmp_path):
    """The same start from ``<pretrained_dir>/detector/aist_detector.pth``
    in the reference's layout; with neither file it raises."""
    _, cfg, _, params = small
    (tmp_path / "detector").mkdir()
    written = _reference_pth(tmp_path / "detector" / "aist_detector.pth",
                             cfg, seed=14)
    dcfg = _dyna_config(cfg, tmp_path)
    net = _net(dcfg, params)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = Trainer(dcfg, device="cpu", dtype="float32", model=net)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, written[k] if k.startswith(DET) else init[k]), k
    with pytest.raises(ValueError, match="pretrained file is not existing"):
        Trainer(_dyna_config(cfg, tmp_path / "elsewhere"), device="cpu",
                dtype="float32", model=_net(dcfg, params))


def test_resume_epoch_explicit_latest_and_missing(small, detector_run,
                                                  tmp_path):
    _, cfg, _, params = small
    _, path, _ = detector_run
    state, _, meta = load_params_only(str(path))
    assert meta == {"epoch": 2}
    explicit = Trainer(dataclasses.replace(cfg, resume_epoch="1"),
                       device="cpu", dtype="float32",
                       model=_net(cfg, params), logger_path=str(path))
    assert explicit.start_epoch == 2
    want, _, meta = load_params_only(str(path), epoch=1)
    assert meta == {"epoch": 1}
    for k, v in explicit.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert any(not torch.equal(want[k], state[k]) for k in want)
    latest = Trainer(cfg, device="cpu", dtype="float32",
                     model=_net(cfg, params), logger_path=str(path))
    assert latest.start_epoch == 3
    for k, v in latest.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    with pytest.raises(ValueError,
                       match="No previous checkpoints from this setting."):
        Trainer(dataclasses.replace(cfg, resume_epoch="1"), device="cpu",
                dtype="float32", model=_net(cfg, params),
                logger_path=str(tmp_path / "fresh"))
