"""The yardstick's counts: the FLOP counter of each cell's counted path
against ``torch.utils.flop_counter.FlopCounterMode`` on the reference at a
small width, and the bytes and operations of K1, K2 and K3 at known
shapes."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import model as ref
from bench_small import small


def _fields(cell):
    return small(cell, compute_dtype="float32")[1]


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def net_and_vox():
    f = _fields("aist_dynamics.serve")
    P = ref.make_params(f, 5, "cpu")
    g = torch.Generator().manual_seed(0)
    G, T = f["grid_size"], f["Ttot"]
    vox = (torch.rand((1, T, G, G, G), generator=g) < 0.1).float()
    return ref.Net(P, f, ref.Prec()), vox, f


def test_keypoint_path(net_and_vox):
    net, vox, f = net_and_vox
    got = _counted(lambda: net.keypoints(vox))
    assert work.keypoint_flops(f) == pytest.approx(got, rel=0.10)


def test_decoder(net_and_vox):
    net, vox, f = net_and_vox
    det = net.keypoints(vox)
    got = _counted(lambda: net.decode(det["keypoints"], det["first_feature"],
                                      vox[:, 0]))
    assert work.decoder_flops(f) == pytest.approx(got, rel=0.10)


def test_vrnn_encode(net_and_vox):
    net, vox, f = net_and_vox
    kp = net.keypoints(vox)["keypoints"]
    K = f["nkeypoints"]
    parents, order = [0] + list(range(K - 1)), list(range(K))
    eps = torch.randn((f["Ttot"], 10, 1, f["nlatent_kypt"]))
    got = _counted(lambda: net.encode(kp, parents, order, eps))
    assert work.vrnn_encode_flops(f) == pytest.approx(got, rel=0.10)


@pytest.mark.parametrize("path,expect", [
    ("detector_train", lambda f: 3 * (work.keypoint_flops(f)
                                      + work.decoder_flops(f))),
    ("dynamics_train", lambda f: work.keypoint_flops(f)
     + 3 * work.vrnn_encode_flops(f)),
    ("serve", lambda f: work.keypoint_flops(f) + work.vrnn_encode_flops(f))])
def test_cell_paths(path, expect):
    f = _fields("aist_dynamics.serve")
    assert work.useful_flops_per_clip(f, path) == expect(f)


def test_k1_bound():
    assert work.k1_bound_s(2, 100, 4, 2) == pytest.approx(
        (2 * 100 * 12 + 2 * 64 * 2) / work.PEAK_BYTES_PER_S)


@pytest.mark.parametrize("backward,n_bytes,ops", [
    (False, 2 * 3 * 3 * 4 + 2 * 64 * 2 + 2 * 4, 10 * (3 * 9 + 8)),
    (True, 2 * 4 + 2 * (2 * 3 * 3 * 4) + 2 * 64 * 2, 10 * (3 * 9 + 16))])
def test_k2_bound(backward, n_bytes, ops):
    assert work.k2_bound_s(2, 3, 4, 2, 10, backward) == pytest.approx(
        max(n_bytes / work.PEAK_BYTES_PER_S, ops / work.PEAK_FP32_OPS_PER_S))


def test_k3_bound():
    x, w = (1, 4, 4, 4, 32), (3, 3, 3, 32, 64)
    n_bytes = 2 * (64 * 32 + 27 * 32 * 64 + 64 + 64 * 64)
    ops = 2 * 64 * 27 * 32 * 64
    assert work.k3_bound_s(x, w) == pytest.approx(
        max(n_bytes / work.PEAK_BYTES_PER_S, ops / work.PEAK_BF16_OPS_PER_S))
