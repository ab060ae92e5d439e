"""Runs of each cell with the timed path broken underneath, and the
cell's control, must come out not correct under the cell's limits; the
same runs unbroken come out correct. The harness's look for a card is
skipped (the CPU, small sizes, float32 compute); everything else of a run
is driven as on the card: set-up, the window, the check.

Faults: a training step that leaves its state unchanged; a step that
leaves out half of the batch and takes the mean over the rest (the rows
cut before the forward, or every row run forward and the second
microbatch's gradient dropped); the frozen detector's keypoints moved
where they are made; a served answer altered where it is produced; the
VRNN keeping another sample than the nearest; a served window whose
result never comes. One card, so no exchange between cards to leave out.
The control and the faults that ``benchmark.calibrate`` reads on the card
are the reference put in the program's place."""
import itertools

import numpy as np
import pytest
import torch

from bench_small import run_small

TRAIN = ("aist_detector.train", "aist_dynamics.train")


@pytest.mark.parametrize("cell", TRAIN + ("aist_dynamics.serve",))
def test_sound_run_is_correct(cell, tmp_path):
    assert run_small(cell, tmp_path, compute_dtype="float32")["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, tmp_path, monkeypatch):
    from neural_marionette_tpu_torch.train import state
    monkeypatch.setattr(state.Adam, "update",
                        lambda self, grads, trainable: self.global_norm(
                            [g for g in grads if g is not None]))
    assert not run_small(cell, tmp_path, compute_dtype="float32")["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out(cell, tmp_path, monkeypatch):
    from neural_marionette_tpu_torch.train.loop import Trainer
    orig = Trainer._to_device

    def half(self, batch):
        x = orig(self, batch)
        return x[: x.shape[0] // 2]

    monkeypatch.setattr(Trainer, "_to_device", half)
    assert not run_small(cell, tmp_path, compute_dtype="float32")["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_of_the_mean(cell, tmp_path, monkeypatch):
    """Every row runs forward; the step's gradient is the first
    microbatch's alone (its loss doubled, the second's zeroed), while the
    reported loss stays the mean over both."""
    from neural_marionette_tpu_torch.train import step
    orig = step.total_loss
    calls = itertools.count()

    def half(out, weights, dtype, device):
        loss, metrics = orig(out, weights, dtype, device)
        return loss * (2.0 if next(calls) % 2 == 0 else 0.0), metrics

    monkeypatch.setattr(step, "total_loss", half)
    assert not run_small(cell, tmp_path, compute_dtype="float32")["correct"]


def test_frozen_keypoints_moved(tmp_path, monkeypatch):
    """The frozen detector's keypoints moved by one voxel where they are
    made, in the dynamics phase."""
    from neural_marionette_tpu_torch.models.detector import KyptDetector
    orig = KyptDetector.forward

    def moved(self, *a, **k):
        out = dict(orig(self, *a, **k))
        kp = out["keypoints"]
        out["keypoints"] = torch.cat(
            [kp[..., :3] + 2.0 / 32, kp[..., 3:]], dim=-1)
        return out

    monkeypatch.setattr(KyptDetector, "forward", moved)
    assert not run_small("aist_dynamics.train", tmp_path,
                         compute_dtype="float32")["correct"]


def test_served_sample_not_the_nearest(tmp_path, monkeypatch):
    """The VRNN keeps, per row, the second-nearest of its samples."""
    from neural_marionette_tpu_torch.models.dynamics import HSVRNNBVH

    def second(self, prev_state, z_samples, offset_rep, skeleton,
               keypoint_flat):
        S, B, Z = z_samples.shape
        dec_in = torch.cat([prev_state[None].expand(S, B, self.H),
                            z_samples], dim=-1)
        kypt, R = self.extract_kypt_from_latent_and_state(
            dec_in.reshape(S * B, self.H + Z), offset_rep, skeleton)
        kypt = kypt.reshape(S, B, -1)
        R = R.reshape(S, B, self.K, 3, 3)
        d = ((keypoint_flat[None] - kypt) ** 2).sum(dim=-1)
        pick = torch.sort(d, dim=0).indices[1]
        rows = torch.arange(B, device=pick.device)
        return z_samples[pick, rows], kypt[pick, rows], R[pick, rows], pick

    monkeypatch.setattr(HSVRNNBVH, "_best_of_n", second)
    assert not run_small("aist_dynamics.serve", tmp_path,
                         compute_dtype="float32")["correct"]


@pytest.mark.parametrize("key", ["keypoints", "kypt_recon", "R"])
def test_served_answer_altered(key, tmp_path, monkeypatch):
    from neural_marionette_tpu_torch.api import MarionetteStream
    orig = MarionetteStream._fetch

    def altered(pending):
        res = orig(pending)
        res[key] = res[key] + np.float32(0.05)
        return res

    monkeypatch.setattr(MarionetteStream, "_fetch", staticmethod(altered))
    assert not run_small("aist_dynamics.serve", tmp_path,
                         compute_dtype="float32")["correct"]


def test_served_window_never_returns(tmp_path, monkeypatch):
    from neural_marionette_tpu_torch.api import MarionetteStream
    monkeypatch.setattr(MarionetteStream, "flush", lambda self: None)
    res = run_small("aist_dynamics.serve", tmp_path, compute_dtype="float32",
                    checked=10 ** 6)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("cell,label", [
    ("aist_detector.train", "low"), ("aist_detector.train", "half"),
    ("aist_dynamics.train", "low"), ("aist_dynamics.train", "half"),
    ("aist_dynamics.train", "shift"), ("aist_dynamics.serve", "low"),
    ("aist_dynamics.serve", "pick"), ("aist_dynamics.serve", "shift")])
def test_control_is_not_correct(cell, label, tmp_path):
    """The control and each fault that ``benchmark.calibrate`` reads on the
    card, put in the program's place, fail the cell's limits."""
    from benchmark import check
    from benchmark.calibrate import faults
    from benchmark.registry import Registry
    r = Registry()
    fields = r.config(r.cell(cell)["config"])["model"]
    res = run_small(cell, tmp_path, compute_dtype="float32",
                    controls={label: faults(label, fields)})
    ok, _ = check.verdict(res["_controls"][label], r.limits(cell))
    assert not ok
