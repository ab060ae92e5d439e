"""Kernels K3 (conv3d) and K4 (fused conv + GroupNorm + LeakyReLU stage)
and the conv route (``conv_kernel=True``) against the JAX package, on the
CPU: ``conv3d_pallas`` and ``fused_stage`` run in interpret mode, as
``tests/test_pallas.py`` runs them, and the JAX model's conv route is
switched on by patching ``_pallas_conv_applicable`` to its own predicate
without the backend test, as ``tests/test_pallas.py:112`` does. On the CPU
the port's wrappers run their plain versions; the kernels themselves are
checked on the card by ``chip_smoke.py``.

Tolerances, with their reasons:

* K3 forward, float32 x: the output stays float32 and both sides sum the
  same bf16 products in float32 in other orders: 1e-5 of the largest |ref|.
* K3 forward, bfloat16 x: both sides round the same float32 sum once, so
  they differ by at most one bf16 ulp of the larger magnitude (where the
  float32 orders straddle a rounding boundary), plus 1e-5 of max |ref|.
* K3 gradients: float32 convolution gradients of the same operands in
  other orders, 1e-5 of each gradient's largest entry; bfloat16 (the
  route's dtypes): dx and dw are rounded to bf16 once on each side from
  float32 sums, and g = cos(y) sees y's rare one-ulp differences, so two
  bf16 ulps of the larger magnitude plus 1e-3 of the largest entry.
* K4: the stored y of both sides may differ by one bf16 ulp, which the
  GroupNorm's gain (about 1 at these unit-variance outputs) carries to the
  output, which is rounded to bf16 again: 2^-6 of the largest |ref|
  (about two bf16 ulps at the output's scale), the bound
  ``chip_smoke.phase_k4`` holds the kernel to on the card.
* The route in blocks, the decoder and the model (bfloat16 compute): the
  routed convs round exactly as JAX's routed ``conv3d_pallas`` does, so
  against the JAX route the outputs differ by the rare one-ulp conv
  roundings carried through the GroupNorms; against the route off and
  against JAX's plain XLA convs, each of the stack's bf16 convs rounds
  its output (and, off the route, the bias too) once in its own way.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu import models as JM
from neural_marionette_tpu.models import blocks as jax_blocks
from neural_marionette_tpu.models import NeuralMarionette as JaxMarionette
from neural_marionette_tpu.models.detector import KyptToVoxNet as JaxDecoder
from neural_marionette_tpu.ops.pallas import conv3d_kernel as jax_k3
from neural_marionette_tpu.ops.pallas import fusedstage_kernel as jax_k4

from neural_marionette_tpu_torch import models as PM
from neural_marionette_tpu_torch.models import NeuralMarionette, blocks
from neural_marionette_tpu_torch.ops import conv3d as K3
from neural_marionette_tpu_torch.ops import fusedstage as K4
from neural_marionette_tpu_torch.train import (LossScheduler,
                                               create_train_state,
                                               make_train_step)
from neural_marionette_tpu_torch.weights import (block_state_dict,
                                                 init_weights,
                                                 state_dict_from_jax)

from _torch_port import configs, jax_params, moving_vox, randomize

BF16 = torch.bfloat16


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def bf16_ulp(v):
    """Spacing of bfloat16 values at the magnitudes ``v`` (float32 numpy):
    8 significant bits, so 2^(e-8) for v in [2^(e-1), 2^e)."""
    _, e = np.frexp(v)
    return np.ldexp(1.0, e - 8)


def assert_bf16_close(got, want, ulps=1, rel_top=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = ulps * bf16_ulp(np.maximum(np.abs(got), np.abs(want))) \
        + rel_top * np.abs(want).max()
    assert (err <= tol).all(), (err.max(), np.abs(want).max())


def _operands(shape, cout, k=3, seed=0, z_scale=False):
    g = np.random.default_rng(seed)
    x = g.normal(size=shape)
    if z_scale:   # every z plane its own scale (tests/test_pallas.py:77)
        x = x * np.arange(1, shape[1] + 1)[None, :, None, None, None]
    w = g.normal(size=(k, k, k, shape[-1], cout)) * 0.1
    b = g.normal(size=(cout,)) * 0.1
    return (x.astype(np.float32), w.astype(np.float32),
            b.astype(np.float32))


def _torch_dtype(dtype):
    return {"float32": torch.float32, "bfloat16": BF16}[dtype]


def _jax_dtype(dtype):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]


# ------------------------------------------------------------ K3 forward
K3_CASES = {
    # name: (x shape, Cout, k, z-asymmetric content)
    "single_tile": ((2, 8, 8, 8, 16), 8, 3, False),   # test_pallas.py:59
    "wider_w": ((1, 8, 8, 16, 32), 8, 3, False),      # :60
    "stem_k5": ((1, 8, 8, 8, 4), 8, 5, False),        # :61
    "z_boundaries": ((1, 6, 8, 8, 16), 8, 3, True),   # :77
    "c72": ((1, 4, 4, 4, 72), 72, 3, False),          # hourglass bottom
    "spatial_2": ((2, 2, 2, 2, 48), 72, 3, False),    # 2^3 at AIST width
    "spatial_1": ((2, 1, 1, 1, 32), 48, 3, False),    # 1^3 at grid 32
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_conv3d_forward_matches_pallas(case, dtype):
    shape, cout, k, zs = K3_CASES[case]
    x, w, b = _operands(shape, cout, k, seed=len(case), z_scale=zs)
    want = np.asarray(jax_k3.conv3d_pallas(
        jnp.asarray(x, _jax_dtype(dtype)), jnp.asarray(w), jnp.asarray(b)),
        np.float32)
    xt = t(x).to(_torch_dtype(dtype))
    plain = K3.conv3d_plain(xt, t(w), t(b))
    via_fn = K3.conv3d(xt, t(w), t(b))
    assert plain.dtype == via_fn.dtype == xt.dtype
    assert torch.equal(plain, via_fn)   # a CPU tensor runs the plain version
    got = plain.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert_bf16_close(got, want)


def test_conv3d_keeps_the_input_layout():
    """An NCDHW-stored x (the model's activations, viewed NDHWC) gives an
    NCDHW-stored y, and the same values as a contiguous x."""
    x, w, b = _operands((2, 4, 5, 6, 32), 16, seed=3)
    xc = t(x).to(BF16).permute(0, 4, 1, 2, 3).contiguous().permute(
        0, 2, 3, 4, 1)
    assert xc.permute(0, 4, 1, 2, 3).is_contiguous()
    y = K3.conv3d(xc, t(w), t(b))
    assert y.permute(0, 4, 1, 2, 3).is_contiguous()
    assert_bf16_close(y.float(), K3.conv3d(t(x).to(BF16), t(w), t(b)).float())


def test_conv3d_checks_its_arguments():
    x, w, b = (t(a) for a in _operands((1, 4, 4, 4, 8), 8))
    with pytest.raises(ValueError, match="cubic and odd"):
        K3.conv3d(x, w[:2, :2, :2], b)
    with pytest.raises(ValueError, match="disagree"):
        K3.conv3d(x, w, b[:4])
    with pytest.raises(ValueError, match="unsupported device"):
        K3._launch(x, w, b)


# ----------------------------------------------------------- K3 backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_gradients_match_pallas(dtype):
    """d/d(x, w, b) of sum(sin(conv3d)) against ``jax.grad`` of
    ``conv3d_pallas`` (tests/test_pallas.py:96), with ``_bwd``'s dtype
    rules: dx in x's dtype, dw and db in w's."""
    x, w, b = _operands((1, 8, 8, 8, 16), 8, seed=2)
    jd, td = _jax_dtype(dtype), _torch_dtype(dtype)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(
        jax_k3.conv3d_pallas(*a).astype(jnp.float32))), argnums=(0, 1, 2))(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd))
    args = [t(a).to(td).requires_grad_(True) for a in (x, w, b)]
    torch.sin(K3.conv3d(*args).float()).sum().backward()
    for name, a, r in zip("xwb", args, want):
        assert a.grad.dtype == td, name
        got, ref = a.grad.float().numpy(), np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)
        else:
            assert_bf16_close(got, ref, ulps=2, rel_top=1e-3)


# -------------------------------------------------------------------- K4
K4_CASES = {"c32": (32, 32), "c64_4groups": (32, 64)}


@pytest.fixture(scope="module", params=sorted(K4_CASES))
def k4_case(request):
    """x (2, 8, 8, 8, Cin) bf16 and the stage's parameters
    (tests/test_pallas.py:213), the JAX kernel's and oracle's outputs."""
    cin, cout = K4_CASES[request.param]
    g = np.random.default_rng(0)
    x = g.normal(0, 1, (2, 8, 8, 8, cin)).astype(np.float32)
    w = g.normal(0, 0.05, (3, 3, 3, cin, cout)).astype(np.float32)
    b, sc, bi = (g.normal(m, 0.1, (cout,)).astype(np.float32)
                 for m in (0, 1, 0))
    jx = jnp.asarray(x, jnp.bfloat16)
    jargs = [jnp.asarray(a) for a in (w, b, sc, bi)]
    fused = np.asarray(jax_k4.fused_stage(jx, *jargs), np.float32)
    ref = np.asarray(jax_k4.reference_stage(jx, *jargs), np.float32)
    port = [t(x).to(BF16)] + [t(a) for a in (w, b, sc, bi)]
    return dict(port=port, fused=fused, ref=ref, cout=cout)


def _assert_stage_close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 2 ** -6 * np.abs(want).max(), (err, np.abs(want).max())


def test_fused_stage_matches_pallas(k4_case):
    got = K4.fused_stage_plain(*k4_case["port"])
    assert got.dtype == BF16
    assert torch.equal(got, K4.fused_stage(*k4_case["port"]))
    _assert_stage_close(got.float().numpy(), k4_case["fused"])


def test_reference_stage_matches_jax(k4_case):
    got = K4.reference_stage(*k4_case["port"])
    assert got.dtype == BF16
    _assert_stage_close(got.float().numpy(), k4_case["ref"])
    # the fused order of rounding against the two-pass GroupNorm
    _assert_stage_close(K4.fused_stage_plain(*k4_case["port"]).float()
                        .numpy(), k4_case["ref"])


def test_fused_stage_groups():
    x, w, b = (t(a) for a in _operands((1, 4, 4, 4, 16), 48))
    ones, zeros = torch.ones(48), torch.zeros(48)
    with pytest.raises(ValueError, match="groups"):
        K4.fused_stage(x.to(BF16), w, b, ones, zeros, ngroups=5)
    # ngroups = Cout // 16 by default, as the JAX kernel
    assert torch.equal(K4.fused_stage(x, w, b, ones, zeros),
                       K4.fused_stage(x, w, b, ones, zeros, ngroups=3))


# --------------------------------------------------------------- the route
def _jax_route(mod, x):
    """``_pallas_conv_applicable`` (neural_marionette_tpu/models/blocks.py)
    without the NM_PALLAS_CONV and backend tests."""
    k = mod.kernel_size
    return (x.ndim == 5 and len(k) == 3 and len(set(k)) == 1
            and k[0] % 2 == 1 and k[0] >= 3 and x.shape[-1] >= 32
            and (mod.strides or 1) in (1, (1, 1, 1))
            and mod.padding == "SAME" and mod.feature_group_count == 1
            and mod.use_bias and mod.dtype == jnp.bfloat16)


@contextlib.contextmanager
def counting(module, name):
    """Count the calls of the function ``module.name`` in the block:
    yields a one-element list holding the count."""
    calls = [0]
    fn = getattr(module, name)

    def wrapper(*a):
        calls[0] += 1
        return fn(*a)
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def test_routes_to_kernel_predicate():
    """The predicate's inputs, one at a time (JAX's, without the backend)."""
    nn = torch.nn
    ok = nn.Conv3d(32, 8, 3, padding=1)
    assert blocks.routes_to_kernel(ok, BF16)
    assert not blocks.routes_to_kernel(ok, torch.float32)
    for m in (nn.Conv3d(16, 8, 3, padding=1),         # Cin < 32
              nn.Conv3d(32, 8, 1),                    # 1x1
              nn.Conv3d(32, 8, 2, stride=2),          # pool conv
              nn.Conv3d(32, 8, 3, padding=0),         # not SAME
              nn.Conv3d(32, 8, 3, padding=1, bias=False),
              nn.Conv3d(32, 8, (3, 3, 1), padding=(1, 1, 0))):
        assert not blocks.routes_to_kernel(m, BF16), m
    assert blocks.routes_to_kernel(nn.Conv3d(32, 8, 5, padding=2), BF16)


@pytest.mark.parametrize("cout,max_err,mean_err", [(32, 2e-2, 1e-4),
                                                   (48, 6e-2, 4e-3)])
def test_res_block_route_matches_jax_route(monkeypatch, cout, max_err,
                                           mean_err):
    """A routed port Res3DBlock against the JAX block routed through
    ``conv3d_pallas``, on the same weights, bfloat16 compute: two routed
    convs each (Cin 32 and cout). At cout 32 every conv routes, and the
    outputs differ by rare one-ulp conv roundings (max 2e-2, mean 1e-4); at
    48 the 1x1 skip projection does not route, and there flax rounds the
    conv before adding the bias in bf16: ``test_block_dtype_rules``' bound
    (max 6e-2, mean 4e-3)."""
    x = np.random.default_rng(1).normal(size=(2, 6, 6, 6, 32)).astype(
        np.float32)
    jm = JM.Res3DBlock(cout, dtype=jnp.bfloat16)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    monkeypatch.setattr(jax_blocks, "_pallas_conv_applicable", _jax_route)
    with counting(jax_k3, "conv3d_pallas") as pallas:
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert pallas[0] == 2
    pm = PM.Res3DBlock(32, cout, dtype=BF16, conv_kernel=True)
    pm.load_state_dict(block_state_dict(params["params"], "Res3DBlock"))
    with counting(K3, "conv3d_plain") as plain, torch.no_grad():
        got = pm(t(np.moveaxis(x, -1, 1)))
    assert plain[0] == 2 and got.dtype == torch.float32
    diff = np.abs(np.moveaxis(got.numpy(), 1, -1) - want)
    assert diff.max() < max_err and diff.mean() < mean_err, (diff.max(),
                                                              diff.mean())


def test_decoder_route_matches_jax_route(monkeypatch):
    """The routed port ``KyptToVoxNet`` against the JAX one routed through
    ``conv3d_pallas``, bfloat16, at feat_dim 64 so that three of the four
    decoder stages route (Cin 64, 32, 32; the last has Cin 16). Its 1x1
    convs and last stage do not route and round as the plain path does
    (``test_block_dtype_rules``), so on the occupancy in (0, 1): max 6e-2,
    mean 4e-3."""
    jcfg, cfg = configs(feat_dim=64, grid_size=16)
    B, T, K, g = 2, 2, jcfg.nkeypoints, 4
    rng = np.random.default_rng(4)
    gauss = rng.uniform(0, 1, (B, T, g, g, g, K)).astype(np.float32)
    feat = rng.normal(0, 1, (B, g, g, g, 64)).astype(np.float32)
    first = (rng.random((B, 16, 16, 16, 1)) < 0.2).astype(np.float32)
    jm = JaxDecoder(jcfg, dtype=jnp.bfloat16)
    args = tuple(map(jnp.asarray, (gauss, feat, first)))
    params = randomize(jm.init(jax.random.PRNGKey(0), *args), 6)
    monkeypatch.setattr(jax_blocks, "_pallas_conv_applicable", _jax_route)
    with counting(jax_k3, "conv3d_pallas") as pallas:
        want = np.asarray(jm.apply(params, *args))
    assert pallas[0] == 3
    pm = PM.KyptToVoxNet(cfg, dtype=BF16, conv_kernel=True)
    sd = state_dict_from_jax({"params": {"kypt_detector": {
        "kypt_to_vox": params["params"]}}})
    pm.load_state_dict({k.partition("kypt_to_vox.")[2]: v
                        for k, v in sd.items()}, strict=True)
    with counting(K3, "conv3d_plain") as plain, torch.no_grad():
        got = pm(t(np.moveaxis(gauss, -1, 2)), t(np.moveaxis(feat, -1, 1)),
                 t(first)).numpy()
    assert plain[0] == 3
    diff = np.abs(got - want)
    assert diff.max() < 6e-2 and diff.mean() < 4e-3, (diff.max(),
                                                        diff.mean())


# --------------------------------------------------------------- the slice
ROUTED_AT_SMALL = 38   # routed convs per detector forward at the tests' size


def _count_routed(model):
    return sum(blocks.routes_to_kernel(m, model.dtype)
               for m in model.modules() if isinstance(m, torch.nn.Conv3d))


@pytest.fixture(scope="module")
def slice_bf16():
    """The detector forward in bfloat16 at the tests' size: JAX (plain XLA
    convs), the port with the route off, and on (counting the routed
    convs), on the same weights and clip."""
    jcfg, cfg = configs()
    model, params = jax_params(jcfg, seed=0)
    vox, _ = moving_vox(B=2, T=jcfg.Ttot, G=jcfg.grid_size, seed=0)
    jm = JaxMarionette(jcfg, dtype=jnp.bfloat16)
    want = jax.jit(lambda p, v: jm.apply(p, v, detector_active=True,
                                         learner_active=False))(
        params, jnp.asarray(vox))
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    out = {}
    sd = state_dict_from_jax(params)
    for route in (False, True):
        net = NeuralMarionette(cfg, dtype=BF16, conv_kernel=route)
        net.load_state_dict(sd, strict=True)
        with counting(K3, "conv3d_plain") as calls, torch.no_grad():
            got = net(t(vox), detector_active=True, learner_active=False)
        out[route] = dict(got=got, calls=calls[0], routable=_count_routed(net))
    return dict(want=want, off=out[False], on=out[True])


def test_slice_route_counts(slice_bf16):
    on, off = slice_bf16["on"], slice_bf16["off"]
    assert on["routable"] == off["routable"] == ROUTED_AT_SMALL
    assert on["calls"] == ROUTED_AT_SMALL and off["calls"] == 0


@pytest.mark.parametrize("key,max_err,mean_err", [
    ("keypoints", 2e-3, 3e-4), ("heatmaps", 5e-2, 3e-3),
    ("recon", 0.15, 3e-3)])
def test_slice_route_matches_route_off_and_jax(slice_bf16, key, max_err,
                                               mean_err):
    """The routed bfloat16 detector against the port with the route off
    and against JAX's bfloat16 model on plain XLA convs (max and mean abs
    error). Keypoints, coordinates in [-1, 1], are soft-argmax averages of
    the heatmaps (range 0.7), whose bf16 roundings differ by a few ulps
    (2^-8 relative each). recon, an occupancy in (0, 1), is
    sigmoid(10 (tanh(logits) + first - 0.5)), computed in bf16: its slope
    reaches 2.5 per unit of bf16 logits, so a few ulps of the logits move
    single voxels by up to 0.1 while the mean moves by 1e-3."""
    got = slice_bf16["on"]["got"][key].float().numpy()
    for name, ref in (("route off", slice_bf16["off"]["got"][key].float()
                       .numpy()), ("JAX", slice_bf16["want"][key])):
        assert got.shape == ref.shape, name
        diff = np.abs(got - ref)
        assert diff.max() <= max_err and diff.mean() <= mean_err, (
            name, diff.max(), diff.mean())


@pytest.mark.parametrize("key,rtol", [
    ("recon_loss", 2e-3), ("vol_fit_reg", 2e-3), ("separation_loss", 2e-3),
    ("sparsity_loss", 2e-3), ("local_const_loss", 2e-3),
    ("time_const_loss", 5e-2), ("graph_traj_loss", 5e-2)])
def test_slice_route_loss_scalars(slice_bf16, key, rtol):
    """Loss scalars of the routed detector against the route off and JAX's:
    2e-3 relative (the serving slice's bound), and 5e-2 for the two losses
    of keypoint velocities (differences of consecutive frames' keypoints,
    which move by about 1e-2 here, so their bf16 noise is a few percent of
    them: the route off and JAX differ from each other by 1.9 %)."""
    got = float(slice_bf16["on"]["got"][key])
    for ref in (float(slice_bf16["off"]["got"][key]),
                float(slice_bf16["want"][key])):
        assert abs(got - ref) <= rtol * abs(ref) + 1e-7, (got, ref)


# ------------------------------------------------------- one training step
@pytest.fixture(scope="module")
def routed_steps():
    """One detector-phase step in bfloat16 with the route off and on, from
    the same weights and batch; the routed one counts its routed convs.
    The weights are the seeded initial ones training starts from: with the
    informative weights of the other tests the bf16 sharpened sigmoid of
    recon saturates at 1.0 and the clamped BCE's gradient is NaN, route on
    or off."""
    _, cfg = configs(detector_start=0, learner_start=int(1e9),
                     affinity_anneal=0)
    _, pts = moving_vox(B=2, T=cfg.Ttot, G=cfg.grid_size, seed=0)
    sched = LossScheduler(cfg)
    sched.anneal(0)
    out = {}
    for route, dtype in ((False, BF16), (True, BF16),
                         ("float32", torch.float32)):
        net = NeuralMarionette(cfg, dtype=dtype, conv_kernel=route is True)
        init_weights(net, torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in net.state_dict().items()}
        state = create_train_state(cfg, net, torch.Generator().manual_seed(0))
        step = make_train_step(net, cfg, sched.active_weights(), True, False,
                               True)
        with counting(K3, "conv3d_plain") as calls:
            metrics = step(state, torch.from_numpy(pts))
        out[route] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          state=state, before=before, calls=calls[0],
                          net=net)
    return out


def test_routed_step_runs_the_route(routed_steps):
    on, off = routed_steps[True], routed_steps[False]
    assert on["calls"] == ROUTED_AT_SMALL and off["calls"] == 0
    for k, v in on["metrics"].items():
        assert np.isfinite(v), k
    assert on["metrics"]["grad_norm"] > 0


def test_routed_step_masked_adam(routed_steps):
    """The detector phase trains the detector and the affinity; the VRNN's
    parameters keep their values, on the route as off it."""
    on = routed_steps[True]
    moved = {k for k, p in on["net"].named_parameters()
             if not torch.equal(p.detach(), on["before"][k])}
    assert moved and all(k.startswith("kypt_detector.") for k in moved)
    off_moved = {k for k, p in routed_steps[False]["net"].named_parameters()
                 if not torch.equal(p.detach(),
                                    routed_steps[False]["before"][k])}
    assert moved == off_moved


def _grad_l2(a, b):
    """Relative L2 distance of two steps' gradients (Adam's first moment,
    (1 - b1) times the masked, clipped gradient)."""
    err2 = ref2 = 0.0
    for x, y in zip(a["state"].optimizer.mu, b["state"].optimizer.mu):
        err2 += float(((x - y).double() ** 2).sum())
        ref2 += float((y.double() ** 2).sum())
    assert ref2 > 0
    return (err2 / ref2) ** 0.5


def test_routed_step_matches_route_off(routed_steps):
    """Metrics within 2e-2 relative of the route-off step's (grad_norm
    moves by 0.8 %). bf16 gradients of this 38-conv stack at the initial
    weights are noisy: the route-off step's lie 0.22 (relative L2) from the
    float32 step's. So the routed gradients must lie within 0.15 of the
    route-off ones and no farther from the float32 step's than 1.1 times
    the route-off ones do."""
    on, off = routed_steps[True], routed_steps[False]
    for k, v in off["metrics"].items():
        assert abs(on["metrics"][k] - v) <= 2e-2 * abs(v) + 1e-6, (
            k, on["metrics"][k], v)
    f32 = routed_steps["float32"]
    assert _grad_l2(on, off) < 0.15, _grad_l2(on, off)
    assert _grad_l2(on, f32) <= 1.1 * _grad_l2(off, f32), (
        _grad_l2(on, f32), _grad_l2(off, f32))
