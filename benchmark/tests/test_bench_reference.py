"""The plain reference against the port on the CPU at grid 32, K 6, T 4,
both in float32: the serving window's outputs, the first three training
steps of each phase, the batches the reference works out from the tree,
and the voxels."""
import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import model as ref
from bench_small import run_small, small


def test_serve_window_equals_the_port(tmp_path):
    c = run_small("aist_dynamics.serve", tmp_path, compute_dtype="float32")
    got = c["_readings"]
    assert got["windows_missing"] == 0 and got["choice_gap"] == 0
    assert got["keypoints_gap"] < 1e-4
    assert got["kypt_recon_gap"] < 1e-4 and got["R_gap"] < 1e-4


# Adam divides each element's moment by its own root mean square, so an
# element whose gradient is round-off moves by the learning rate in a
# direction set by that round-off: over three steps the change of a leaf
# holding such elements differs by a few % between two float32 programs
# whose losses agree to 1e-5.
@pytest.mark.parametrize("cell,loss,grad,change", [
    ("aist_detector.train", 1e-4, 1e-3, 0.1),
    ("aist_dynamics.train", 1e-5, 1e-5, 1e-3)])
def test_training_steps_equal_the_port(cell, loss, grad, change, tmp_path):
    c = run_small(cell, tmp_path, compute_dtype="float32")
    got = c["_readings"]
    assert got["frozen_moved"] == 0
    assert got["loss_gap"] < loss and got["grad_gap"] < grad
    assert got["change_gap"] < change


def test_loader_batches_equal_the_port(tmp_path):
    from neural_marionette_tpu_torch.data.datasets import AIST
    from neural_marionette_tpu_torch.data.loader import DataLoader
    from benchmark import program
    _, f, m = small("aist_detector.train")
    inputs.write_aist_tree(tmp_path, 77, m["sequences"], m["frames"],
                           m["points"])
    cfg = program.port_config(f, 2 ** 33 + 5, data_root=str(tmp_path))
    ds = AIST(train=True, options=cfg)
    with DataLoader(ds, cfg.nbatch, shuffle=True, num_workers=2,
                    seed=cfg.seed) as loader:
        port = []
        for epoch in range(3):
            ds.log_epoch(epoch)
            port += [b[0] for b in loader]
    mine = inputs.loader_batches(tmp_path, dict(f, seed=2 ** 33 + 5),
                                 len(port))
    assert len(port) == 3
    for a, b in zip(port, mine):
        np.testing.assert_array_equal(a, b)


def test_voxels_equal_the_port():
    from neural_marionette_tpu_torch.ops.voxelize import voxelize_plain
    pts = torch.as_tensor(inputs.serve_window(3, 0, 2, 3, 500))
    np.testing.assert_array_equal(
        ref.voxelize(pts, 32).numpy(), voxelize_plain(pts, 32)[..., 0].numpy())
