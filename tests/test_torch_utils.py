"""The port's FLOPs counter and profiling utilities on the CPU.

``utils/flops.py`` against the JAX package's counter over the AIST preset
and the five detector option sets (equal), and against
``torch.utils.flop_counter.FlopCounterMode``'s count of the port's own
detector forward at a small width: within the 10 % that
``tests/test_flops.py`` allows against XLA's cost analysis. ``utils/
profiling.py`` on the CPU: ``StepTimer``, ``trace`` writing a trace file,
``device_memory_stats() == {}`` and ``loop_time``. About 5 s.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from neural_marionette_tpu.config import MarionetteConfig as JaxConfig
from neural_marionette_tpu.config import adjust_config as jax_adjust
from neural_marionette_tpu.utils import flops as jax_flops

from neural_marionette_tpu_torch import MarionetteConfig, adjust_config
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.utils import flops, profiling

# the detector option sets of chip_smoke.OPTION_SETS and
# tests/test_torch_options.py
OPTION_SETS = {
    "aist": {},
    "ci2_gauss_max_aff0": dict(const_intensity=2, vol_fit_type="gaussian",
                               gaussian_cat_type="max", affinity_ver=0,
                               graph_loss_ver=0),
    "ci0_none_sum_aff1": dict(const_intensity=0, vol_fit_type="none",
                              gaussian_cat_type="sum", affinity_ver=1,
                              graph_loss_ver=2),
    "ci1_aff4_sigma": dict(const_intensity=1, affinity_ver=4, fixed_sigma=0,
                           graph_random_init=1, keypoints_detach=1),
    "ci4_aff2_noconst": dict(const_intensity=4, affinity_ver=2,
                             using_local_const=0, using_time_const=0,
                             using_sparsity_const=0),
    "graph_none": dict(keypoints_graph="none"),
}


@pytest.mark.parametrize("name", list(OPTION_SETS))
@pytest.mark.parametrize("B", [1, 4, 24])
def test_flops_equal_the_jax_counter(name, B):
    jcfg = dataclasses.replace(jax_adjust(JaxConfig(dataset="aist")),
                               **OPTION_SETS[name])
    cfg = dataclasses.replace(adjust_config(MarionetteConfig(dataset="aist")),
                              **OPTION_SETS[name])
    assert flops.forward_flops(cfg, B) == jax_flops.forward_flops(jcfg, B)
    assert flops.train_step_flops(cfg, B) == \
        jax_flops.train_step_flops(jcfg, B) == \
        3.0 * flops.forward_flops(cfg, B)


@pytest.mark.parametrize("const_intensity", [3, 0])
def test_forward_flops_within_10_percent_of_flop_counter_mode(
        const_intensity):
    """The port's detector forward at a small width (the configuration of
    tests/test_flops.py), counted by ``FlopCounterMode``: its convs alone
    equal the counter here, the rest (soft-argmax, the chamfer's dot
    products) is within 0.2 %."""
    cfg = MarionetteConfig(
        grid_size=32, nkeypoints=6, input_dim=3, Ttot=4, Tcond=2,
        nlatent_kypt=16, nhidden_kypt=32, const_intensity=const_intensity,
        affinity_ver=3, nneighbor=2, feat_dim=32, dataset="synthetic")
    B = 2
    net = NeuralMarionette(cfg, device="cpu")
    g = np.random.default_rng(0)
    vox = torch.from_numpy(
        (g.random((B, cfg.Ttot, 32, 32, 32, 1)) < 0.05).astype(np.float32))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = net(vox)
    assert torch.isfinite(out["recon_loss"]).all()
    counted = counter.get_total_flops()
    model = flops.forward_flops(cfg, B)
    assert abs(model - counted) / counted < 0.10, (model, counted)


def test_mfu_against_the_h100_peak():
    assert flops.H100_SXM_BF16_DENSE_TFLOPS == 989.0
    assert abs(flops.mfu(989e12 * 0.25, 1.0) - 0.25) < 1e-12
    assert abs(flops.mfu(197e12 * 0.5, 1.0, peak_tflops=197.0) - 0.5) < 1e-12
    # the JAX default is a TPU v5e's peak; the port's is the H100's
    assert flops.mfu(1e12, 1.0) * 989 == pytest.approx(
        jax_flops.mfu(1e12, 1.0) * 197)


def test_step_timer_on_the_cpu():
    timer = profiling.StepTimer(items_per_step=8)
    for _ in range(3):
        with timer.step() as out:
            out["result"] = {"x": torch.ones(4) * 2, "y": [torch.zeros(2)]}
    assert len(timer.times) == 3 and all(t >= 0 for t in timer.times)
    mean = timer.mean_time()
    assert mean == pytest.approx(sum(timer.times[1:]) / 2)
    assert timer.throughput() == pytest.approx(8 / mean)
    timer.start()
    assert timer.stop(torch.ones(1)) >= 0 and len(timer.times) == 4


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.rglob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_device_memory_stats_and_loop_time_without_a_card():
    assert not torch.cuda.is_available()
    assert profiling.device_memory_stats() == {}
    calls = []
    x = torch.ones(8)
    dt = profiling.loop_time(lambda t: calls.append(t.sum()), x, iters=5)
    assert len(calls) == 6 and dt >= 0
