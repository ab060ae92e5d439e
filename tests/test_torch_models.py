"""The port's models against the JAX package's, on the CPU, on the same
weights (carried by ``state_dict_from_jax``) and the same inputs.

Tolerances (float32 on both sides): conv blocks and stacks 1e-4 absolute
(README's parity record: different summation orders through several
GroupNorms); keypoints 1e-4; loss scalars 2e-3 relative; the dynamics,
which see the same keypoints and the same noise, 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu import models as JM
from neural_marionette_tpu.models import HSVRNNBVH as JaxHSVRNNBVH
from neural_marionette_tpu.models import NeuralMarionette as JaxMarionette
from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton

from neural_marionette_tpu_torch import models as PM
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.models import SkeletonArrays
from neural_marionette_tpu_torch.skeleton import extract_skeleton
from neural_marionette_tpu_torch.weights import (block_state_dict,
                                                 state_dict_from_jax)

from _torch_port import (configs, jax_params, jax_sample_eps, moving_vox,
                         randomize)

LOSSES = ("recon_loss", "vol_fit_reg", "kypt_const_loss", "separation_loss",
          "sparsity_loss", "local_const_loss", "time_const_loss",
          "sparsity_const_loss", "intensity_const_loss", "graph_traj_loss",
          "graph_vol_loss", "kl_kypt", "kypt_recon_loss", "gae_recon_loss",
          "topo_recon_loss")


def t(x):
    return torch.from_numpy(np.array(x))


def first(x):
    """channels-last numpy (N, X, Y, Z, C) -> NCDHW tensor."""
    return t(np.moveaxis(np.asarray(x), -1, 1))


def last(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


# ------------------------------------------------------------------ blocks
BLOCKS = {
    # name: (JAX module, port module, input shape (N, X, Y, Z, C))
    "basic_k5": (lambda: JM.Basic3DBlock(8, 5),
                 lambda: PM.Basic3DBlock(4, 8, 5), (2, 8, 8, 8, 4)),
    "res_skip_conv": (lambda: JM.Res3DBlock(32),
                      lambda: PM.Res3DBlock(16, 32), (2, 6, 6, 6, 16)),
    "res_identity": (lambda: JM.Res3DBlock(16),
                     lambda: PM.Res3DBlock(16, 16), (2, 6, 6, 6, 16)),
    "pool": (lambda: JM.Pool3DBlock(2),
             lambda: PM.Pool3DBlock(32, 2), (2, 8, 8, 8, 32)),
    "upsample": (lambda: JM.Upsample3DBlock(16, 0),
                 lambda: PM.Upsample3DBlock(32, 16, 0), (2, 4, 4, 4, 32)),
    "upsample_output_padding": (lambda: JM.Upsample3DBlock(16, 1),
                                lambda: PM.Upsample3DBlock(32, 16, 1),
                                (2, 3, 3, 3, 32)),
    # N=12 gives the decoder output paddings (1, 1, 0)
    "hourglass_n12": (lambda: JM.Hourglass(16, N=12),
                      lambda: PM.Hourglass(16, 16, 12), (1, 12, 12, 12, 16)),
    "hourglass_n8": (lambda: JM.Hourglass(16, N=8),
                     lambda: PM.Hourglass(16, 16, 8), (2, 8, 8, 8, 16)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    """A JAX block and the port's, on the same (randomised) weights carried
    by ``block_state_dict``: float32, atol 1e-4. The Hourglass cases also
    check the ConvTranspose kernel flip and the block-level bias."""
    jmod, pmod, shape = BLOCKS[name]
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jm = jmod()
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)), 3)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    kind = type(jm).__name__
    pm = pmod()
    pm.load_state_dict(block_state_dict(params["params"], kind), strict=True)
    with torch.no_grad():
        got = last(pm(first(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_block_dtype_rules():
    """bfloat16 compute: the conv runs in bfloat16 and GroupNorm returns
    float32, as flax promotes against its float32 scale. The JAX block
    agrees within bfloat16 rounding: each of the two convs rounds its
    inputs and output to 8 bits of mantissa (relative 4e-3), and the
    GroupNorm outputs are of unit scale, so atol 6e-2 at the worst element
    and 4e-3 on average."""
    x = np.random.default_rng(1).normal(size=(2, 6, 6, 6, 16)).astype(
        np.float32)
    jm = JM.Res3DBlock(32, dtype=jnp.bfloat16)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = jm.apply(params, jnp.asarray(x))
    pm = PM.Res3DBlock(16, 32, dtype=torch.bfloat16)
    pm.load_state_dict(block_state_dict(params["params"], "Res3DBlock"))
    with torch.no_grad():
        got = pm(first(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    diff = np.abs(last(got) - np.asarray(want))
    assert diff.max() < 6e-2 and diff.mean() < 4e-3, (diff.max(),
                                                        diff.mean())


# --------------------------------------------------------------- dynamics
def _keypoints(B, T, K, seed):
    g = np.random.default_rng(seed)
    base = g.uniform(-0.6, 0.6, (B, 1, K, 3))
    motion = np.cumsum(g.normal(0, 0.05, (B, T, K, 3)), axis=1)
    inten = g.uniform(0.2, 1.0, (B, T, K, 1))
    return np.concatenate([base + motion, inten], -1).astype(np.float32)


def _tree(K, seed):
    g = np.random.default_rng(seed)
    order = g.permutation(K).astype(np.int32)
    parents = np.zeros(K, np.int32)
    parents[order[0]] = order[0]
    for i in range(1, K):
        parents[order[i]] = order[g.integers(0, i)]
    return order, parents


def _best_indices(dyn, out, keypoints, eps):
    """The sample index behind each of ``out``'s chosen ``z``: the nearest
    of the port's candidates ``post_mean + post_std * eps`` at each step."""
    B, T = keypoints.shape[:2]
    idx = np.zeros((B, T), np.int64)
    with torch.no_grad():
        for step in range(T):
            h = t(out["h_kypts"][:, step])
            pm, ps, _, _ = dyn._post_prior_fused(
                h, t(keypoints[:, step].reshape(B, -1)))
            cand = pm[None].numpy() + ps[None].numpy() * eps[step]
            dist = ((cand - np.asarray(out["z_kypts"])[None, :, step]) ** 2
                    ).sum(-1)
            idx[:, step] = dist.argmin(0)
    return idx


def test_dynamics_encode_matches_jax():
    """``HSVRNNBVH.encode`` alone, on the same keypoints, skeleton and
    noise: every output at atol 1e-4, and the best-of-N selections equal."""
    jcfg, cfg = configs()
    B, T, K, S = 2, jcfg.Ttot, jcfg.nkeypoints, 4
    kp = _keypoints(B, T, K, 2)
    order, parents = _tree(K, 3)
    jsk = JaxSkeletonArrays(jnp.asarray(order), jnp.asarray(parents))
    model = JaxHSVRNNBVH(jcfg)
    init = {"params": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)}
    params = jax.jit(lambda r, k: model.init(r, k, jsk, sample_num=S,
                                             method=JaxHSVRNNBVH.encode))(
        init, jnp.asarray(kp))
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, k: model.apply(
        p, k, jsk, sample_num=S, method=JaxHSVRNNBVH.encode,
        rngs={"sample": key}))(params, jnp.asarray(kp))
    k0 = model.apply(params, method=lambda m: m.make_rng("sample"),
                     rngs={"sample": key})
    eps = np.stack([np.asarray(jax.random.normal(k, (S, B, jcfg.nlatent_kypt)))
                    for k in jax.random.split(k0, T)])

    net = PM.HSVRNNBVH(cfg)
    sd = state_dict_from_jax({"params": {"dyna_module": params["params"]}})
    net.load_state_dict({k.partition(".")[2]: v for k, v in sd.items()},
                        strict=True)
    sk = SkeletonArrays(t(order.astype(np.int64)), t(parents.astype(np.int64)))
    with torch.no_grad():
        got = net.encode(t(kp), sk, sample_num=S, eps=t(eps))
    for k in ("kypt_recon", "R", "z_kypts", "h_kypts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    for k in ("kl_kypt", "kypt_recon_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-5, err_msg=k)
    want_idx = _best_indices(net, want, kp, eps)
    np.testing.assert_array_equal(got["best_index"].numpy(), want_idx)


@pytest.mark.parametrize("method", ["_gru", "_post_prior_fused",
                                    "_decoder_fused"])
def test_dynamics_step_functions_match_jax(method):
    """One VRNN step function on the same weights and random inputs: the
    port runs the reference's modules unfused, the JAX package fused
    weights; atol 1e-5 (float32 matmuls of depth up to H+S)."""
    jcfg, cfg = configs()
    B, T, K = 3, jcfg.Ttot, jcfg.nkeypoints
    Z, H = jcfg.nlatent_kypt, jcfg.nhidden_kypt
    S = K * (jcfg.input_dim + 1)
    order, parents = _tree(K, 3)
    jsk = JaxSkeletonArrays(jnp.asarray(order), jnp.asarray(parents))
    model = JaxHSVRNNBVH(jcfg)
    init = {"params": jax.random.PRNGKey(7), "sample": jax.random.PRNGKey(8)}
    params = model.init(init, jnp.asarray(_keypoints(B, T, K, 9)), jsk,
                        sample_num=2, method=JaxHSVRNNBVH.encode)
    net = PM.HSVRNNBVH(cfg)
    sd = state_dict_from_jax({"params": {"dyna_module": params["params"]}})
    net.load_state_dict({k.partition(".")[2]: v for k, v in sd.items()},
                        strict=True)
    g = np.random.default_rng(10)
    widths = {"_gru": (S + Z, H), "_post_prior_fused": (H, S),
              "_decoder_fused": (H + Z,)}[method]
    args = [g.normal(0, 1, (B, w)).astype(np.float32) for w in widths]
    want = model.apply(params, *map(jnp.asarray, args),
                       method=getattr(JaxHSVRNNBVH, method))
    with torch.no_grad():
        got = getattr(net, method)(*map(t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=f"{method}[{i}]")


def test_dynamics_draws_from_generator():
    """Without ``eps`` the encode draws its noise from the generator: the
    same seed gives the same rollout, another seed another one."""
    _, cfg = configs()
    net = PM.HSVRNNBVH(cfg)
    kp = t(_keypoints(2, cfg.Ttot, cfg.nkeypoints, 4))
    sk = SkeletonArrays.chain(cfg.nkeypoints)
    with torch.no_grad():
        a, b, c = (net.encode(kp, sk, sample_num=3,
                              generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
    assert torch.equal(a["z_kypts"], b["z_kypts"])
    assert not torch.equal(a["z_kypts"], c["z_kypts"])
    with pytest.raises(ValueError):
        net.encode(kp, sk, sample_num=3, eps=torch.zeros(1, 3, 2, 4))


# ---------------------------------------------------- the whole slice
@pytest.fixture(scope="module")
def slice_pair():
    """JAX ``encode_only`` and the port's on the same weights, clip,
    skeleton and noise."""
    jcfg, cfg = configs()
    model, params = jax_params(jcfg, seed=0)
    vox, _ = moving_vox(B=2, T=jcfg.Ttot, G=jcfg.grid_size, seed=0)
    S = 3
    aff = model.apply(params, method=lambda m: m.kypt_detector.get_affinity())
    skeleton = jax_skeleton(np.asarray(aff))
    jsk = JaxSkeletonArrays.from_skeleton(skeleton)
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda p, v: model.apply(
        p, v, jsk, sample_num=S, method=JaxMarionette.encode_only,
        rngs={"sample": key}))(params, jnp.asarray(vox))
    want = jax.tree.map(np.asarray, want)
    eps = jax_sample_eps(model, params, key, jcfg.Ttot, S, 2,
                         jcfg.nlatent_kypt)

    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        port_skeleton = extract_skeleton(
            net.kypt_detector.get_affinity().numpy())
        got = net.encode_only(t(vox), SkeletonArrays.from_skeleton(
            port_skeleton), sample_num=S, eps=t(eps))
    return dict(want=want, got=got, eps=eps, net=net, skeleton=skeleton,
                port_skeleton=port_skeleton)


def test_slice_skeleton_matches_jax(slice_pair):
    for a, b in zip(slice_pair["port_skeleton"], slice_pair["skeleton"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key,atol", [("keypoints", 1e-4),
                                      ("heatmaps", 1e-4),
                                      ("recon", 1e-4),
                                      ("affinity", 1e-6),
                                      ("first_feature", 1e-4),
                                      ("kypt_recon", 1e-4),
                                      ("R", 1e-4),
                                      ("z_kypts", 1e-4)])
def test_slice_outputs_match_jax(slice_pair, key, atol):
    got = slice_pair["got"][key].numpy()
    want = slice_pair["want"][key]
    assert got.shape == want.shape, key
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("key", LOSSES)
def test_slice_loss_scalars_match_jax(slice_pair, key):
    """Loss scalars at 2e-3 relative (atol 1e-7 for the ones that are
    zero upstream)."""
    got = slice_pair["got"][key].numpy()
    want = slice_pair["want"][key]
    assert got.shape == want.shape == (), key
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7, err_msg=key)


def test_slice_best_of_n_selections_match_jax(slice_pair):
    """The best-of-N argmin picks the same samples on both sides."""
    want = slice_pair["want"]
    kp = want["keypoints"]
    idx = _best_indices(slice_pair["net"].dyna_module, want, kp,
                        slice_pair["eps"])
    np.testing.assert_array_equal(
        slice_pair["got"]["best_index"].numpy(), idx)


def test_unported_options_raise():
    """No option value is unported any more: every value of the detector
    options that the JAX package runs constructs a ``NeuralMarionette``;
    ``affinity_ver=5`` and ``vol_fit_type="nope"`` raise ``ValueError`` on
    both sides (the JAX package when its model first runs)."""
    _, cfg = configs()
    values = {"const_intensity": (0, 1, 2, 3, 4),
              "affinity_ver": (0, 1, 2, 3, 4), "graph_loss_ver": (0, 1, 2),
              "vol_fit_type": ("none", "chamfer", "gaussian"),
              "gaussian_cat_type": ("none", "max", "sum"),
              "fixed_sigma": (0, 1),
              "keypoints_graph": ("affinity_params", "none")}
    for name, vals in values.items():
        for value in vals:
            NeuralMarionette(dataclasses.replace(cfg, **{name: value}))
    for name, value in (("affinity_ver", 5), ("vol_fit_type", "nope")):
        jcfg, pcfg = configs(**{name: value})
        with pytest.raises(ValueError, match=name):
            NeuralMarionette(pcfg)
        with pytest.raises(ValueError):
            jax_params(jcfg)
