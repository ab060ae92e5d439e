"""Plain PyTorch reference of Neural Marionette at the AIST option set.

Written from the reference's description (``model/kypt_detector.py``,
``modules/vox_modules.py``, ``model/hsvrnn_bvh.py``, ``train.py``) as the
configurations of this benchmark state it: ``const_intensity`` 3 (the
spatio-temporal prior, constant over the clip), fixed sigmas, no Gaussian
pooling, ``affinity_ver`` 3, ``graph_loss_ver`` 1, the chamfer volume fit,
keypoints not detached. Any other option raises.

Parameters are a flat dict of tensors under the names of the reference's
``state_dict`` (:func:`param_spec` lists them), so the benchmark makes one
set of seeded weights and hands the same tensors to the program and to this
module. Activations are NCDHW, time folded into the batch.

Precision. ``prec="fp32"`` computes everything in float32 (the caller
turns TF32 off), but the reconstruction, held as the configuration holds
it (:class:`HeldSigmoid`). ``prec="low"`` is the control: where the configurations
compute and hold bfloat16 (each convolution's input, weight and output,
and the reconstruction made from the decoder's output), float8 e4m3 with a
per-tensor scale, the step below (the reconstruction through
:class:`HeldSigmoid`); the VRNN's matmul operands, float32
there, rounded to TF32, the step below that; all with a straight-through
gradient, so the backward sees the rounded values.

Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.01
E4M3_MAX = 448.0


# ------------------------------------------------------------------ options
SUPPORTED = dict(const_intensity=3, fixed_sigma=1, gaussian_cat_type="none",
                 affinity_ver=3, graph_loss_ver=1, vol_fit_type="chamfer",
                 keypoints_graph="affinity_params", keypoints_detach=0,
                 using_local_const=1, using_time_const=1,
                 using_sparsity_const=1, input_dim=3)


def check_options(cfg: dict) -> None:
    for k, v in SUPPORTED.items():
        if cfg[k] != v:
            raise ValueError(f"reference: {k}={cfg[k]!r} is not modelled "
                             f"(only {v!r})")


# ----------------------------------------------------------------- rounding
def _ste(x, q):
    return x + (q - x).detach()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale for the tensor (its max onto 448)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return _ste(x, q)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to TF32's 10 mantissa bits, to nearest."""
    b = x.detach().contiguous().view(torch.int32)
    q = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    return _ste(x, q)


class HeldSigmoid(torch.autograd.Function):
    """``sigmoid(z)`` held in a narrower type by ``hold``, its derivative
    y (1 - y) taken at the held y, as a network that computes and keeps the
    reconstruction in that type differentiates it. A configuration that
    holds the reconstruction in bfloat16 rounds near-saturated voxels to
    exactly 1.0, which then take no gradient; in float32 they take a
    large one. That is the configuration's precision, not rounding noise,
    so the reference holds this one tensor as the configuration does."""

    @staticmethod
    def forward(ctx, z, hold):
        y = hold(torch.sigmoid(z))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y * (1.0 - y), None


class Prec:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "low"):
            raise ValueError(f"precision {mode!r}")
        self.low = mode == "low"

    def conv_operand(self, t):
        return round_fp8(t) if self.low else t

    def mm_operand(self, t):
        return round_tf32(t) if self.low else t

    # what the configurations hold in bfloat16
    held = conv_operand


# --------------------------------------------------------------- parameters
def _conv_entry(name, cin, cout, k, block):
    kind = ("normal", 0.001 if block else 0.02)
    return [(f"{name}.weight", (cout, cin, k, k, k), kind),
            (f"{name}.bias", (cout,), ("zeros",))]


def _gn_entry(name, c):
    return [(f"{name}.weight", (c,), ("ones",)),
            (f"{name}.bias", (c,), ("zeros",))]


def _res_spec(p, cin, cout):
    s = (_conv_entry(f"{p}.res_branch.0", cin, cout, 3, True)
         + _gn_entry(f"{p}.res_branch.1", cout)
         + _conv_entry(f"{p}.res_branch.3", cout, cout, 3, True)
         + _gn_entry(f"{p}.res_branch.4", cout))
    if cin != cout:
        s += (_conv_entry(f"{p}.skip_con.0", cin, cout, 1, True)
              + _gn_entry(f"{p}.skip_con.1", cout))
    return s


def _pool_spec(p, c):
    return (_conv_entry(f"{p}.stride_conv.0", c, c, 2, True)
            + _gn_entry(f"{p}.stride_conv.1", c))


def _up_spec(p, cin, cout):
    return ([(f"{p}.block.0.weight", (cin, cout, 2, 2, 2),
              ("normal", 0.001)),
             (f"{p}.block.0.bias", (cout,), ("zeros",))]
            + _gn_entry(f"{p}.block.1", cout))


def _hourglass_spec(p, c):
    s = _res_spec(f"{p}.skip_res1", c, c)
    s += _pool_spec(f"{p}.encoder_pool1", c)
    s += _res_spec(f"{p}.encoder_res1", c, 32)
    s += _res_spec(f"{p}.skip_res2", 32, 32)
    s += _pool_spec(f"{p}.encoder_pool2", 32)
    s += _res_spec(f"{p}.encoder_res2", 32, 48)
    s += _res_spec(f"{p}.skip_res3", 48, 48)
    s += _pool_spec(f"{p}.encoder_pool3", 48)
    s += _res_spec(f"{p}.encoder_res3", 48, 72)
    s += _res_spec(f"{p}.decoder_res3", 72, 72)
    s += _up_spec(f"{p}.decoder_upsample3", 72, 48)
    s += _res_spec(f"{p}.decoder_res2", 48, 48)
    s += _up_spec(f"{p}.decoder_upsample2", 48, 32)
    s += _res_spec(f"{p}.decoder_res1", 32, 32)
    s += _up_spec(f"{p}.decoder_upsample1", 32, c)
    return s


def _feature_spec(p, C):
    s = (_conv_entry(f"{p}.0.block.0", 4, C // 4, 5, True)
         + _gn_entry(f"{p}.0.block.1", C // 4))
    s += _pool_spec(f"{p}.1", C // 4)
    s += _res_spec(f"{p}.2", C // 4, C // 2)
    s += _pool_spec(f"{p}.3", C // 2)
    s += _hourglass_spec(f"{p}.4", C // 2)
    s += _res_spec(f"{p}.5", C // 2, C)
    return s


def _linear_spec(p, fin, fout):
    bound = 1.0 / math.sqrt(fin)
    return [(f"{p}.weight", (fout, fin), ("uniform", bound)),
            (f"{p}.bias", (fout,), ("uniform", bound))]


def param_spec(cfg: dict) -> list:
    """``[(name, shape, distribution)]`` of every parameter, in a fixed
    order. Distributions: the JAX package's initial ones (block convs
    N(0, 0.001), other convs N(0, 0.02), biases 0, GroupNorm (1, 0),
    linears and the GRU uniform(+-1/sqrt(fan_in)), the initial GRU state
    and the offset directions N(0, 1)), except the affinity parameters,
    drawn N(0, 1) as ``graph_random_init`` draws them, so the skeleton they
    give is a tree of distinct edges, as a trained affinity's is, and not
    the tie-broken chain of a constant one."""
    check_options(cfg)
    C, K, G = cfg["feat_dim"], cfg["nkeypoints"], cfg["grid_size"]
    H, Z = cfg["nhidden_kypt"], cfg["nlatent_kypt"]
    S = K * (cfg["input_dim"] + 1)
    v = "kypt_detector.vox_to_kypt"
    d = "kypt_detector.kypt_to_vox"
    s = _feature_spec(f"{v}.extract_features", C)
    s += _conv_entry(f"{v}.extract_heatmaps_from_features.0", C, K, 1, False)
    s += _feature_spec(f"{v}.extract_spatio_temporal_features", 2 * C)
    s += _conv_entry(f"{v}.extract_spatio_temporal_heatmaps_from_features.0",
                     2 * C, K, 1, False)
    s += _conv_entry(f"{v}.propagate_heatmaps.0", 2, 1, 1, False)
    s += _conv_entry(f"{d}.adjust_combined_representation.0", 2 * K + C + 3,
                     C, 1, False)
    dec = f"{d}.decode_voxel_from_combined_representation"
    s += _conv_entry(f"{dec}.1", C, C // 2, 3, False) + _gn_entry(
        f"{dec}.2", C // 2)
    s += _conv_entry(f"{dec}.4", C // 2, C // 2, 3, False) + _gn_entry(
        f"{dec}.5", C // 2)
    s += _conv_entry(f"{dec}.8", C // 2, C // 4, 3, False) + _gn_entry(
        f"{dec}.9", C // 4)
    s += _conv_entry(f"{dec}.11", C // 4, C // 4, 3, False) + _gn_entry(
        f"{dec}.12", C // 4)
    s += _conv_entry(f"{dec}.14", C // 4, 1, 1, False)
    s += [("kypt_detector.affinity_params", (cfg["nneighbor"], K, K - 1),
           ("normal", 1.0))]
    dm = "dyna_module"
    s += _linear_spec(f"{dm}.extract_post_dist.0", H + S, 128)
    s += _linear_spec(f"{dm}.extract_post_dist.2", 128, 2 * Z)
    s += _linear_spec(f"{dm}.extract_prior_dist.0", H, 128)
    s += _linear_spec(f"{dm}.extract_prior_dist.2", 128, 2 * Z)
    s += _linear_spec(f"{dm}.root_intensity_decoder.0", H + Z, 128)
    s += _linear_spec(f"{dm}.root_intensity_decoder.2", 128, 3 + K)
    s += _linear_spec(f"{dm}.joint_matrix_decoder.0", H + Z, 128)
    s += _linear_spec(f"{dm}.joint_matrix_decoder.2", 128, 6 * K)
    gb = 1.0 / math.sqrt(H)
    s += [(f"{dm}.kypt_rnn_cell.weight_ih", (3 * H, S + Z), ("uniform", gb)),
          (f"{dm}.kypt_rnn_cell.weight_hh", (3 * H, H), ("uniform", gb)),
          (f"{dm}.kypt_rnn_cell.bias_ih", (3 * H,), ("uniform", gb)),
          (f"{dm}.kypt_rnn_cell.bias_hh", (3 * H,), ("uniform", gb)),
          (f"{dm}.init_kypt_rnn_state", (1, H), ("normal", 1.0)),
          (f"{dm}.offset_param", (K, 3), ("normal", 1.0))]
    return s


def make_params(cfg: dict, seed: int, device) -> dict:
    """Every parameter from ``seed``, on ``device``, float32: one normal and
    one uniform draw from a generator on the device, cut into the leaves."""
    spec = param_spec(cfg)
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    n_norm = sum(math.prod(sh) for _, sh, k in spec if k[0] == "normal")
    n_unif = sum(math.prod(sh) for _, sh, k in spec if k[0] == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind[0] == "normal":
            out[name] = (normal[i:i + n] * kind[1]).reshape(shape)
            i += n
        elif kind[0] == "uniform":
            out[name] = (unif[j:j + n] * kind[1]).reshape(shape)
            j += n
        elif kind[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------------------ blocks
class Net:
    """The forward passes over a parameter dict ``P`` in precision
    ``prec``."""

    def __init__(self, P: dict, cfg: dict, prec: Prec):
        check_options(cfg)
        self.P, self.cfg, self.prec = P, cfg, prec

    # -- primitives
    def conv(self, name, x, stride=1, padding=0):
        w, b = self.P[name + ".weight"], self.P[name + ".bias"]
        q = self.prec.conv_operand
        return self.prec.held(F.conv3d(q(x), q(w), q(b), stride, padding))

    def gn(self, name, x):
        w = self.P[name + ".weight"]
        return F.group_norm(x, max(w.shape[0] // 16, 1), w,
                            self.P[name + ".bias"], 1e-5)

    def basic(self, p, x, k):
        return F.leaky_relu(self.gn(p + ".block.1", self.conv(
            p + ".block.0", x, padding=k // 2)), LEAKY)

    def res(self, p, x):
        r = F.leaky_relu(self.gn(p + ".res_branch.1", self.conv(
            p + ".res_branch.0", x, padding=1)), LEAKY)
        r = self.gn(p + ".res_branch.4", self.conv(p + ".res_branch.3", r,
                                                   padding=1))
        if p + ".skip_con.0.weight" in self.P:
            skip = self.gn(p + ".skip_con.1", self.conv(p + ".skip_con.0", x))
        else:
            skip = x
        return r + skip

    def pool(self, p, x):
        return F.leaky_relu(self.gn(p + ".stride_conv.1", self.conv(
            p + ".stride_conv.0", x, stride=2)), LEAKY)

    def up(self, p, x, output_padding):
        q = self.prec.conv_operand
        y = self.prec.held(F.conv_transpose3d(
            q(x), q(self.P[p + ".block.0.weight"]), None, stride=2,
            output_padding=output_padding))
        y = y + self.P[p + ".block.0.bias"].view(1, -1, 1, 1, 1)
        return F.leaky_relu(self.gn(p + ".block.1", y), LEAKY)

    def hourglass(self, p, x, N):
        pad = [(N // 4) % 2, (N // 2) % 2, N % 2]
        skip1 = self.res(p + ".skip_res1", x)
        x = self.res(p + ".encoder_res1", self.pool(p + ".encoder_pool1", x))
        skip2 = self.res(p + ".skip_res2", x)
        x = self.res(p + ".encoder_res2", self.pool(p + ".encoder_pool2", x))
        skip3 = self.res(p + ".skip_res3", x)
        x = self.res(p + ".encoder_res3", self.pool(p + ".encoder_pool3", x))
        x = self.res(p + ".decoder_res3", x)
        x = self.up(p + ".decoder_upsample3", x, pad[0]) + skip3
        x = self.res(p + ".decoder_res2", x)
        x = self.up(p + ".decoder_upsample2", x, pad[1]) + skip2
        x = self.res(p + ".decoder_res1", x)
        return self.up(p + ".decoder_upsample1", x, pad[2]) + skip1

    def feature_net(self, p, x):
        G = self.cfg["grid_size"]
        x = self.basic(p + ".0", x, 5)
        x = self.res(p + ".2", self.pool(p + ".1", x))
        x = self.pool(p + ".3", x)
        x = self.hourglass(p + ".4", x, G // 4)
        return self.res(p + ".5", x)

    # -- detector
    def keypoints(self, vox: torch.Tensor) -> dict:
        """``vox`` (B, T, G, G, G) float32 -> heatmaps (B, T, K, g, g, g),
        keypoints (B, T, K, 4), first_feature (B, C, g, g, g)."""
        B, T = vox.shape[:2]
        G = vox.shape[-1]
        v = "kypt_detector.vox_to_kypt"
        prior_feat = self.feature_net(
            v + ".extract_spatio_temporal_features",
            add_coords(vox.mean(dim=1)[:, None]))
        prior = F.leaky_relu(self.conv(
            v + ".extract_spatio_temporal_heatmaps_from_features.0",
            prior_feat), LEAKY)                              # (B, K, g, g, g)
        frames = vox.reshape(B * T, 1, G, G, G)
        feats = self.feature_net(v + ".extract_features", add_coords(frames))
        heat = F.leaky_relu(self.conv(
            v + ".extract_heatmaps_from_features.0", feats), LEAKY)
        heat = heat.reshape((B, T) + heat.shape[1:])
        w = self.P[v + ".propagate_heatmaps.0.weight"].reshape(2)
        b = self.P[v + ".propagate_heatmaps.0.bias"][0]
        heat = F.softplus(w[0] * heat + w[1] * prior[:, None] + b)
        kp = soft_argmax(heat.reshape((B * T,) + heat.shape[2:]))
        kp = kp.reshape(B, T, *kp.shape[1:])
        first = feats.reshape((B, T) + feats.shape[1:])[:, 0]
        return dict(heatmaps=heat, keypoints=kp, first_feature=first)

    def decode(self, kp, first_feature, first_frame):
        """Keypoints (B, T, K, 4), first_feature (B, C, g, g, g) and the
        first frame (B, G, G, G) -> recon (B, T, G, G, G)."""
        cfg = self.cfg
        B, T, K = kp.shape[:3]
        g = cfg["grid_size"] // 4
        sig = torch.full((K,), float(cfg["gaussian_sigma"]),
                         device=kp.device)
        gauss = render_gaussians(kp, sig, g)                # (B, T, K, g^3)
        g0 = gauss[:, :1].expand_as(gauss)
        ff = first_feature[:, None].expand((B, T) + first_feature.shape[1:])
        comb = torch.cat([gauss, ff, g0], dim=2)
        comb = add_coords(comb.reshape((B * T,) + comb.shape[2:]))
        d = "kypt_detector.kypt_to_vox"
        x = F.leaky_relu(self.conv(d + ".adjust_combined_representation.0",
                                   comb), LEAKY)
        dec = d + ".decode_voxel_from_combined_representation"

        def stage(i, v):
            return F.leaky_relu(self.gn(f"{dec}.{i + 1}", self.conv(
                f"{dec}.{i}", v, padding=1)), LEAKY)

        x = F.interpolate(x, scale_factor=2, mode="trilinear",
                          align_corners=False)
        x = stage(4, stage(1, x))
        x = F.interpolate(x, scale_factor=2, mode="trilinear",
                          align_corners=False)
        x = stage(11, stage(8, x))
        logits = self.conv(dec + ".14", x)
        G = cfg["grid_size"]
        logits = logits.reshape(B, T, G, G, G)
        z = 10.0 * (torch.tanh(logits) + first_frame[:, None] - 0.5)
        if self.prec.low:
            return HeldSigmoid.apply(z, lambda y: round_fp8(y).detach())
        if cfg["compute_dtype"] == "bfloat16":
            return HeldSigmoid.apply(z, lambda y: y.bfloat16().float())
        return torch.sigmoid(z)

    def affinity(self) -> torch.Tensor:
        """(nneighbor, K, K) of ``affinity_ver`` 3."""
        P = self.P["kypt_detector.affinity_params"]
        n, K = P.shape[:2]
        Wt = torch.softmax(P, dim=-1)
        z = torch.zeros((n, K, 1), device=P.device)
        return (torch.cat([z, torch.triu(Wt, diagonal=0)], dim=-1)
                + torch.cat([torch.tril(Wt, diagonal=-1), z], dim=-1))

    def detector_losses(self, vox, det, recon) -> dict:
        """The detector's weighted terms, each a mean over the rows."""
        cfg = self.cfg
        kp = det["keypoints"]
        K = kp.shape[2]
        out = {}
        # nn.BCELoss, the reference's loss: logs clamped at -100, the
        # gradient (x - y) / max(x (1 - x), 1e-12)
        out["recon_loss"] = F.binary_cross_entropy(recon, vox)
        heat = det["heatmaps"]                               # (B,T,K,g,g,g)
        out["sparsity_loss"] = heat.mean(dim=(3, 4, 5)).abs().mean()
        coords = kp[..., :3]
        disp = coords - coords.mean(dim=1, keepdim=True)
        diff = ((disp[:, :, :, None] - disp[:, :, None]) ** 2).sum(-1)
        sep = torch.exp(-diff.mean(dim=1) / (2.0 * cfg["sep_sigma"] ** 2))
        out["separation_loss"] = ((sep.sum(dim=(1, 2)) - K)
                                  / (K * (K - 1))).mean()
        out["vol_fit_reg"] = chamfer_fit(vox, coords).mean()
        aff = self.affinity()                                # (n, K, K)
        infl = aff.amax(dim=0)                               # (K, K)
        dist = ((coords[:, :, :, None] - coords[:, :, None]) ** 2).sum(-1)
        out["local_const_loss"] = (dist * infl).mean()
        dev = (dist - dist.mean(dim=1, keepdim=True)).abs()
        out["time_const_loss"] = (dev * infl).mean()
        sp = ((aff[:, None] * aff[None]) ** 2).sum(dim=1) - aff ** 4
        out["sparsity_const_loss"] = sp.sum(dim=0).mean()
        vel = coords[:, 1:] - coords[:, :-1]
        acc = vel[:, 1:] - vel[:, :-1]
        out["graph_traj_loss"] = (
            ((1.0 - cosine(vel[:, :, :, None], vel[:, :, None])) / 2.0
             * infl).mean(dim=(0, 1))
            + ((1.0 - cosine(acc[:, :, :, None], acc[:, :, None])) / 2.0
               * infl).mean(dim=(0, 1))).mean()
        return out

    # -- VRNN
    def linear(self, name, x):
        q = self.prec.mm_operand
        return F.linear(q(x), q(self.P[name + ".weight"]),
                        self.P[name + ".bias"])

    def mlp(self, name, x):
        return self.linear(name + ".2", F.leaky_relu(
            self.linear(name + ".0", x), LEAKY))

    def gru(self, x, h):
        q = self.prec.mm_operand
        g = "dyna_module.kypt_rnn_cell."
        gi = F.linear(q(x), q(self.P[g + "weight_ih"]), self.P[g + "bias_ih"])
        gh = F.linear(q(h), q(self.P[g + "weight_hh"]), self.P[g + "bias_hh"])
        ir, iz, inn = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        return (1.0 - z) * n + z * h

    @staticmethod
    def dist(raw):
        mean, s = raw.chunk(2, dim=-1)
        return mean, F.softplus(s) + 1e-4

    def decode_state(self, x, offset, parents, order):
        """Decoder input (M, H+Z), bone offsets (M, K, 3) -> keypoints
        (M, K, 4), global rotations (M, K, 3, 3): the two heads, the 6D
        rotations and forward kinematics walked root first."""
        K = offset.shape[1]
        raw = torch.tanh(self.mlp("dyna_module.root_intensity_decoder", x))
        rot = rot6d_to_matrix(self.mlp("dyna_module.joint_matrix_decoder",
                                       x).reshape(-1, K, 6))
        Rg = [None] * K
        pos = [None] * K
        for i, k in enumerate(order):
            if i == 0:
                Rg[k], pos[k] = rot[:, k], raw[:, :3]
            else:
                p = parents[k]
                Rg[k] = Rg[p] @ rot[:, k]
                pos[k] = pos[p] + (Rg[k] @ offset[:, k, :, None])[..., 0]
        R = torch.stack(Rg, dim=1)
        pts = torch.stack(pos, dim=1)
        inten = (raw[:, 3:] + 1.0) * 0.5
        return torch.cat([pts, inten[..., None]], dim=-1), R

    def offsets(self, kp, parents):
        T = kp.shape[1]
        pos = kp[..., :3]
        d = torch.sqrt(((pos[:, :, :, None] - pos[:, :, None]) ** 2).sum(-1))
        med = torch.sort(d, dim=1).values[:, (T - 1) // 2]   # (B, K, K)
        idx = torch.as_tensor(parents, device=kp.device)
        scale = med[:, torch.arange(len(parents), device=kp.device), idx]
        o = self.P["dyna_module.offset_param"]
        direction = o / (torch.sqrt((o ** 2).sum(-1, keepdim=True)) + 1e-10)
        return (direction[None] * scale[..., None]).detach()

    def encode(self, kp, parents, order, eps, follow=None,
               rank: int = 0) -> dict:
        """Posterior rollout with best-of-N over ``eps`` (T, N, B, Z).

        Without ``follow`` each step keeps its own best sample (with
        ``rank``, a fault, the sample of that rank by distance). With
        ``follow`` (the served ``kypt_recon`` (B, T, K, 4) and ``R``
        (B, T, K, 3, 3)) each step keeps the sample nearest the served one
        and records how far the served keypoints and rotations lie from it,
        and by how much its distance to the detected keypoints exceeds the
        best sample's (``choice_gap``, a share of the best's)."""
        kp = kp.float()
        B, T, K, _ = kp.shape
        N = eps.shape[1]
        H = self.P["dyna_module.init_kypt_rnn_state"].shape[1]
        offset = self.offsets(kp, parents)
        off_rep = offset.repeat(N, 1, 1)
        h = self.P["dyna_module.init_kypt_rnn_state"].expand(B, H)
        kyp, Rs, kls = [], [], []
        gaps = dict(choice_gap=0.0, kypt_gap=0.0, R_gap=0.0)
        for t in range(T):
            x = kp[:, t].reshape(B, -1)
            pm, ps = self.dist(self.mlp("dyna_module.extract_post_dist",
                                        torch.cat([h, x], dim=-1)))
            qm, qs = self.dist(self.mlp("dyna_module.extract_prior_dist", h))
            zs = pm[None] + ps[None] * eps[t]                 # (N, B, Z)
            dec_in = torch.cat([h[None].expand(N, B, H), zs], dim=-1)
            cand, Rc = self.decode_state(dec_in.reshape(N * B, -1), off_rep,
                                         parents, order)
            cand = cand.reshape(N, B, K * 4)
            Rc = Rc.reshape(N, B, K, 3, 3)
            d = ((x[None] - cand) ** 2).sum(-1)               # (N, B)
            best = torch.argmin(d, dim=0) if not rank else \
                torch.sort(d, dim=0).indices[rank]
            if follow is not None:
                served = follow[0][:, t].reshape(B, K * 4).float()
                pick = torch.argmin(((cand - served[None]) ** 2).sum(-1),
                                    dim=0)
                rows = torch.arange(B, device=kp.device)
                dmin = d[best, rows]
                gaps["choice_gap"] = max(gaps["choice_gap"], float(
                    ((d[pick, rows] - dmin) / dmin.clamp(min=1e-12)).max()))
                gaps["kypt_gap"] = max(gaps["kypt_gap"], float(
                    (cand[pick, rows] - served).abs().max()))
                gaps["R_gap"] = max(gaps["R_gap"], float(
                    (Rc[pick, rows] - follow[1][:, t].float()).abs().max()))
                best = pick
            rows = torch.arange(B, device=kp.device)
            bz, bk, bR = zs[best, rows], cand[best, rows], Rc[best, rows]
            h = self.gru(torch.cat([bk, bz], dim=-1), h)
            kyp.append(bk)
            Rs.append(bR)
            vr = (ps / qs) ** 2
            kls.append(0.5 * (vr + ((pm - qm) / qs) ** 2 - 1.0
                              - torch.log(vr)))
        inferred = torch.stack(kyp, 1).reshape(B, T, K, 4)
        return dict(kypt_recon=inferred, R=torch.stack(Rs, 1),
                    kl_kypt=torch.stack(kls, 1).mean(),
                    kypt_recon_loss=((inferred - kp) ** 2).sum(
                        dim=(2, 3)).mean(), **gaps)


# ------------------------------------------------------------ free functions
def add_coords(x: torch.Tensor) -> torch.Tensor:
    """(N, C, X, Y, Z) -> (N, C + 3, X, Y, Z): per-axis linspace(-1, 1)
    coordinates, from float32 ``np.linspace``."""
    sp = x.shape[2:]
    grids = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in sp]
    maps = np.stack(np.meshgrid(*grids, indexing="ij"), axis=0)
    m = torch.as_tensor(maps, device=x.device, dtype=x.dtype)
    return torch.cat([x, m[None].expand((x.shape[0],) + m.shape)], dim=1)


def soft_argmax(heat: torch.Tensor) -> torch.Tensor:
    """(N, K, g, g, g) -> (N, K, 4): coordinates as expectations over
    linspace(-1, 1) of each axis' normalized marginal (+1e-6 per voxel),
    intensity as the spatial mean over the frame's largest."""
    g = heat.shape[-1]
    inten = heat.mean(dim=(2, 3, 4))
    inten = inten / (inten.amax(dim=-1, keepdim=True) + 1e-6)
    grid = torch.linspace(-1.0, 1.0, g, device=heat.device)
    cs = []
    for axis in (2, 3, 4):
        other = tuple(a for a in (2, 3, 4) if a != axis)
        w = heat.sum(dim=other) + 1e-6 * g * g
        w = w / w.sum(dim=-1, keepdim=True)
        cs.append((w * grid).sum(-1))
    return torch.cat([torch.stack(cs, -1), inten[..., None]], dim=-1)


def render_gaussians(kp: torch.Tensor, sigma: torch.Tensor, g: int):
    """(..., K, 4) -> (..., K, g, g, g): separable Gaussians of width
    ``sigma / g`` at the keypoints, scaled by intensity."""
    grid = torch.linspace(-1.0, 1.0, g, device=kp.device)
    width = 2.0 * (sigma / g) ** 2                            # (K,)
    a = torch.exp(-((grid - kp[..., :3, None]) ** 2)
                  / width[:, None, None])                     # (..., K, 3, g)
    return (a[..., 0, :, None, None] * a[..., 1, None, :, None]
            * a[..., 2, None, None, :]) * kp[..., 3, None, None, None]


def chamfer_fit(vox: torch.Tensor, coords: torch.Tensor,
                block: int = 8) -> torch.Tensor:
    """(B, T, G, G, G) occupancy, (B, T, K, 3) keypoints -> (B, T): the
    occupancy-weighted mean over voxels of the squared distance from the
    voxel centre to its nearest keypoint, frames in blocks of ``block``."""
    B, T, G = vox.shape[0], vox.shape[1], vox.shape[-1]
    lin = torch.as_tensor(np.linspace(-1.0, 1.0, G, dtype=np.float32),
                          device=vox.device)
    V = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                    -1).reshape(-1, 3)
    occ = vox.reshape(B * T, -1)
    c = coords.reshape(B * T, -1, 3)
    nums = []
    for i in range(0, B * T, block):
        d = ((V[None, :, None] - c[i:i + block, None]) ** 2).sum(-1)
        nums.append((d.amin(dim=-1) * occ[i:i + block]).sum(-1))
    num = torch.cat(nums).reshape(B, T)
    return num / occ.reshape(B, T, -1).sum(-1).clamp(min=1.0)


def cosine(x, y, eps=1e-6):
    w = (x * y).sum(-1)
    nx = torch.sqrt(torch.clamp((x * x).sum(-1), min=eps * eps))
    ny = torch.sqrt(torch.clamp((y * y).sum(-1), min=eps * eps))
    return w / (nx * ny)


def rot6d_to_matrix(p: torch.Tensor) -> torch.Tensor:
    def unit(v):
        return v / (torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-20) + 1e-10)

    x = unit(p[..., 0:3])
    z = unit(torch.linalg.cross(x, p[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def voxelize(points: torch.Tensor, G: int) -> torch.Tensor:
    """(..., N, 3) float32 points -> (..., G, G, G) float32 occupancy: a
    point is dropped when any axis falls outside the grid, whose cells are
    ``2 / G + 1e-5`` wide from -1; divided, not multiplied by a
    reciprocal."""
    lead = points.shape[:-2]
    flat = points.reshape(-1, points.shape[-2], 3)
    step = torch.tensor([2.0 / G + 1e-5], dtype=torch.float32,
                        device=points.device)
    idx = torch.floor((flat + 1.0) / step)
    ok = ((idx >= 0) & (idx < G)).all(dim=-1)
    idx = idx.long()
    lin = (torch.arange(flat.shape[0], device=points.device)[:, None]
           * G ** 3 + (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2])
    out = torch.zeros(flat.shape[0] * G ** 3, device=points.device)
    out[lin[ok]] = 1.0
    return out.reshape(lead + (G, G, G))


# ------------------------------------------------------------------ training
DETECTOR_TERMS = ("recon_loss", "sparsity_loss", "separation_loss",
                  "vol_fit_reg", "local_const_loss", "time_const_loss",
                  "sparsity_const_loss", "graph_traj_loss")
LEARNER_TERMS = ("kl_kypt", "kypt_recon_loss")
_WEIGHT_KEYS = {"recon_loss": "recon_weight", "sparsity_loss": "sparse_weight",
                "separation_loss": "sep_weight",
                "vol_fit_reg": "vol_reg_weight",
                "local_const_loss": "local_const_weight",
                "time_const_loss": "time_const_weight",
                "sparsity_const_loss": "sparsity_const_weight",
                "graph_traj_loss": "graph_traj_weight",
                "kl_kypt": "kl_kypt_weight",
                "kypt_recon_loss": "kypt_recon_weight"}


def trained(name: str, phase: str) -> bool:
    """Which parameters a phase updates: the detector's in the detector
    phase, the VRNN's but its offset directions in the dynamics phase."""
    if phase == "detector":
        return name.startswith("kypt_detector.")
    return name.startswith("dyna_module.") and not name.endswith(
        "offset_param")


def detector_loss(net: Net, vox):
    """The detector phase's total loss over the rows of ``vox``, its terms
    and the keypoints."""
    cfg = net.cfg
    det = net.keypoints(vox)
    recon = net.decode(det["keypoints"], det["first_feature"], vox[:, 0])
    terms = net.detector_losses(vox, det, recon)
    return (sum(cfg[_WEIGHT_KEYS[k]] * terms[k] for k in DETECTOR_TERMS),
            terms, det["keypoints"].detach())


def learner_loss(net: Net, kp, eps, skeleton) -> torch.Tensor:
    """The dynamics phase's total loss: the VRNN over keypoints ``kp``."""
    terms = net.encode(kp, skeleton[0], skeleton[1], eps)
    return sum(net.cfg[_WEIGHT_KEYS[k]] * terms[k] for k in LEARNER_TERMS)


def frozen_keypoints(P: dict, cfg: dict, prec: Prec, vox, chunk: int):
    """The frozen detector's keypoints of ``vox``, ``chunk`` rows at a
    time, without a gradient."""
    net = Net(P, cfg, prec)
    with torch.no_grad():
        return torch.cat([net.keypoints(vox[i:i + chunk])["keypoints"]
                          for i in range(0, vox.shape[0], chunk)])


class RefAdam:
    """optax ``chain(clip_by_global_norm(c), adam(lr))`` on the trained
    parameters, float32."""

    def __init__(self, params: dict, lr: float, max_norm: float):
        self.lr, self.max_norm = lr, max_norm
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        f = float(self.max_norm / norm) if float(norm) >= self.max_norm \
            else 1.0
        self.count += 1
        b1, b2 = 0.9, 0.999
        clipped = {}
        for k, g in grads.items():
            g = g * f
            clipped[k] = g
            self.mu[k].mul_(b1).add_((1 - b1) * g)
            self.nu[k].mul_(b2).add_((1 - b2) * g * g)
            m = self.mu[k] / (1 - b1 ** self.count)
            v = self.nu[k] / (1 - b2 ** self.count)
            params[k].sub_(self.lr * m / (torch.sqrt(v) + 1e-8))
        return clipped


def train_steps(P0: dict, cfg: dict, phase: str, batches, prec: Prec,
                chunk: int, eps=None, skeleton=None,
                keep_rows: Optional[float] = None, follow=None,
                shift: float = 0.0) -> dict:
    """The reference's steps from parameters ``P0`` over ``batches`` (a list
    of (B, T, G, G, G) occupancies), each step's gradient summed over
    chunks of ``chunk`` rows, each chunk weighted by its share of the
    batch. ``eps``: per step the VRNN's draws (T, N, B, Z). ``keep_rows``:
    a fault, the share of each batch that the step's loss and gradient
    take, as their mean, while every row runs forward. ``follow``: per
    step the frozen detector's keypoints to train the VRNN on, in place of
    the reference's own (the dynamics phase). ``shift``: a fault, added to
    the coordinates of the frozen detector's keypoints where they are
    made.

    Returns each step's loss, the first step's clipped gradient per leaf,
    the first step's gradient of each microbatch of ``grad_accum`` (its
    rows' share of the loss, times ``grad_accum``, before clipping; on the
    host), the parameters after the last step and the keypoints of each
    step (in the dynamics phase, those the VRNN trained on)."""
    P = {k: v.clone() for k, v in P0.items()}
    names = [k for k in P if trained(k, phase)]
    opt = RefAdam({k: P[k] for k in names}, cfg["lrate"],
                  cfg["max_grad_norm"])
    accum = max(int(cfg["grad_accum"]), 1)
    losses, terms, used, first_grad, micro = [], [], [], None, None
    for s, vox in enumerate(batches):
        B = vox.shape[0]
        b = B // accum
        kept = B if keep_rows is None else max(int(B * keep_rows), 1)
        grads = [{k: torch.zeros_like(P[k]) for k in names}
                 for _ in range(accum)]
        total, step_terms, step_kp = 0.0, {}, []

        def add(m, loss):
            gs = torch.autograd.grad(loss, [leaves[k] for k in names],
                                     allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    grads[m][k] += g
            return float(loss.detach())

        if phase == "dynamics":
            if follow is None:
                kp = frozen_keypoints(P, cfg, prec, vox, chunk)
                kp[..., :3] += shift
            else:
                kp = follow[s].float()
            used.append(kp)
            for m in range(accum):
                i, j = m * b, min((m + 1) * b, kept)
                if i >= j:
                    continue
                leaves = {k: P[k].detach().requires_grad_(k in names)
                          for k in P}
                total += add(m, learner_loss(
                    Net(leaves, cfg, prec), kp[i:j], eps[s][:, :, i:j],
                    skeleton) * ((j - i) / kept))
        edges = sorted(set(range(0, B, chunk)) | set(range(0, B, b))
                       | {kept, B}) if phase == "detector" else []
        for i, j in zip(edges, edges[1:]):
            part = vox[i:j]
            if i >= kept:
                # the fault's rows outside the mean: forward only
                with torch.no_grad():
                    step_kp.append(Net(P, cfg, prec).keypoints(part)[
                        "keypoints"])
                continue
            leaves = {k: P[k].detach().requires_grad_(k in names) for k in P}
            loss, parts, kp = detector_loss(Net(leaves, cfg, prec), part)
            step_kp.append(kp)
            for k, v in parts.items():
                step_terms[k] = step_terms.get(k, 0.0) + float(
                    v.detach()) * part.shape[0] / kept
            total += add(i // b, loss * (part.shape[0] / kept))
            del leaves, loss
        losses.append(total)
        terms.append(step_terms)
        if step_kp:
            used.append(torch.cat(step_kp))
        if micro is None:
            micro = [{k: (v * accum).cpu() for k, v in g.items()}
                     for g in grads]
        whole = {k: sum(g[k] for g in grads) for k in names}
        del grads
        clipped = opt.step({k: P[k] for k in names}, whole)
        if first_grad is None:
            first_grad = {k: v.clone() for k, v in clipped.items()}
    return dict(losses=losses, terms=terms, first_grad=first_grad,
                micro=micro, params=P, keypoints=used)
