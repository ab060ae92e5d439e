"""Keypoint detector: voxel encoder, keypoint head, voxel decoder, affinity.

Counterpart of ``neural_marionette_tpu/models/detector.py`` on its plain
path (the strip, upconv, hybrid and frame-chunk rewrites are TPU layout
work and are not ported). Time is folded into the batch, as there.
Public tensors keep the JAX layouts (voxels ``(B, T, G, G, G, 1)``,
heatmaps ``(B, T, g, g, g, K)``, keypoints ``(B, T, K, 4)``); convolutions
run in NCDHW inside.

Every value of the detector options that the JAX package runs is ported:
``const_intensity`` 0-4, learned sigmas (``fixed_sigma=0``),
``gaussian_cat_type`` ``max``/``sum``, ``affinity_ver`` 0-4 (version 4
with Gumbel noise from an explicit generator or an injected draw),
``keypoints_graph="none"`` and ``keypoints_detach``; the losses' options
(``vol_fit_type``, ``graph_loss_ver``) are in ``ops/losses.py``.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import MarionetteConfig, check_supported
from ..ops import losses as L
from ..ops.coords import add_coord_channels_first
from ..ops.keypoints import (extract_keypoints_from_heatmap_first,
                             render_gaussian_maps_first)
from ..ops.upsample import upsample2_trilinear_first
from .blocks import (LEAKY_SLOPE, Basic3DBlock, Hourglass, Pool3DBlock,
                     Res3DBlock, conv, group_norm, leaky_relu, norm)


def _channels_last_vox(seq: torch.Tensor) -> torch.Tensor:
    """(N, G, G, G, 1) -> (N, 1, G, G, G); a view, since C = 1."""
    return seq.reshape(seq.shape[0], 1, *seq.shape[1:4])


def feature_net(C: int, grid_size: int, dtype, device,
                conv_kernel: bool = False) -> nn.Sequential:
    """Voxels + 3 coordinate channels -> features at grid/4 (reference
    ``_build_feature_net``): Basic(k5, C/4) -> Pool/2 -> Res(C/2) -> Pool/2
    -> HG(C/2) -> Res(C)."""
    kw = dict(dtype=dtype, device=device)
    rk = dict(kw, conv_kernel=conv_kernel)
    return nn.Sequential(
        Basic3DBlock(1 + 3, C // 4, 5, **rk),
        Pool3DBlock(C // 4, 2, **kw),
        Res3DBlock(C // 4, C // 2, **rk),
        Pool3DBlock(C // 2, 2, **kw),
        Hourglass(C // 2, C // 2, grid_size // 4, **rk),
        Res3DBlock(C // 2, C, **rk))


def heatmap_head(C: int, K: int, device, softplus: bool = False
                 ) -> nn.Sequential:
    """1x1 conv head, activated with LeakyReLU, or with softplus for the
    per-frame head of const_intensity 0."""
    act = nn.Softplus() if softplus else nn.LeakyReLU(LEAKY_SLOPE)
    return nn.Sequential(nn.Conv3d(C, K, 1, device=device), act)


class VoxToKyptNet(nn.Module):
    """Per-frame voxel encoder + spatial soft-argmax. ``const_intensity``:

    * 0: the per-frame heatmaps alone (softplus head);
    * 1: a learned initial heatmap prior ``initial_heatmaps``, updated
      recurrently frame by frame;
    * 2: the spatio-temporal (sequence-mean) prior, updated recurrently;
    * 3: the spatio-temporal prior, constant across frames (AIST preset);
    * 4: the motion-saliency prior ``(1 - mean + 1/T) * clip(sum, 0, 1)``
      through the spatio-temporal net, constant across frames.

    Each frame's heatmap is fused with the prior by the 1x1 conv + softplus
    ``propagate_heatmaps`` (modes 1-4). Sigmas are the fixed
    ``gaussian_sigma`` or, with ``fixed_sigma=0``, the learned
    ``sigmoid(sigmas) * 2 gaussian_sigma``."""

    def __init__(self, cfg: MarionetteConfig, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.heat_grid = g = cfg.grid_size // 4
        C, K = cfg.feat_dim, cfg.nkeypoints
        ci = cfg.const_intensity
        if not cfg.fixed_sigma:
            self.sigmas = nn.Parameter(torch.zeros(K, device=device))
        if ci == 1:
            # the reference's layout, (K, g, g, g)
            self.initial_heatmaps = nn.Parameter(
                torch.zeros((K, g, g, g), device=device))
        self.extract_features = feature_net(C, cfg.grid_size, dtype, device,
                                            conv_kernel)
        self.extract_heatmaps_from_features = heatmap_head(
            C, K, device, softplus=not ci)
        if ci in (2, 3, 4):
            self.extract_spatio_temporal_features = feature_net(
                2 * C, cfg.grid_size, dtype, device, conv_kernel)
            self.extract_spatio_temporal_heatmaps_from_features = \
                heatmap_head(2 * C, K, device)
        if ci:
            self.propagate_heatmaps = nn.Sequential(
                nn.Conv3d(2, 1, 1, device=device), nn.Softplus())

    def get_sigmas(self) -> torch.Tensor:
        """(K,) widths of the Gaussian keypoint maps."""
        cfg = self.cfg
        if cfg.fixed_sigma:
            dev = self.extract_heatmaps_from_features[0].weight.device
            return torch.full((cfg.nkeypoints,), cfg.gaussian_sigma,
                              dtype=self.dtype, device=dev)
        return torch.sigmoid(self.sigmas) * (cfg.gaussian_sigma * 2.0)

    def _heatmaps(self, head: nn.Sequential, feats):
        h = conv(head[0], feats, self.dtype)
        return F.softplus(h) if isinstance(head[1], nn.Softplus) \
            else leaky_relu(h)

    def _prior(self, summed: torch.Tensor) -> torch.Tensor:
        """(B, G, G, G, 1) -> the spatio-temporal net's (B, K, g, g, g)."""
        return self._heatmaps(
            self.extract_spatio_temporal_heatmaps_from_features,
            self.extract_spatio_temporal_features(
                add_coord_channels_first(_channels_last_vox(summed))))

    def _propagate(self, heatmap, prev):
        """softplus(w0 * h + w1 * prev + b), in float32 as the JAX package's
        float32 parameters promote it."""
        w = self.propagate_heatmaps[0].weight.reshape(2)
        b = self.propagate_heatmaps[0].bias[0]
        return F.softplus(w[0] * heatmap.float() + w[1] * prev.float() + b)

    def forward(self, seq: torch.Tensor):
        """``seq`` (B, T, G, G, G, 1) -> (heatmaps (B, T, K, g, g, g),
        keypoints (B, T, K, 4), gaussians (B, T, K, g, g, g),
        first_feature (B, C, g, g, g))."""
        B, T = seq.shape[:2]
        ci = self.cfg.const_intensity
        prev = None                                       # (B, K, g, g, g)
        if ci == 1:
            prev = self.initial_heatmaps[None].expand(
                (B,) + self.initial_heatmaps.shape)
        elif ci in (2, 3):
            prev = self._prior(seq.mean(dim=1))
        elif ci == 4:
            # motion saliency: dynamic voxels ~1, static ~1/T, masked to the
            # union of the occupancy
            prev = self._prior((1.0 - seq.mean(dim=1) + 1.0 / T)
                               * torch.clamp(seq.sum(dim=1), 0, 1))

        frames = _channels_last_vox(seq.reshape((B * T,) + seq.shape[2:]))
        features = self.extract_features(add_coord_channels_first(frames))
        heatmaps = self._heatmaps(self.extract_heatmaps_from_features,
                                  features)               # (BT, K, g, g, g)
        heatmaps = heatmaps.reshape((B, T) + heatmaps.shape[1:])
        first_feature = features.reshape((B, T) + features.shape[1:])[:, 0]

        if ci in (3, 4):
            heatmaps = self._propagate(heatmaps, prev[:, None])
        elif ci in (1, 2):
            fused = []          # the prior is updated frame by frame
            for t in range(T):
                prev = self._propagate(heatmaps[:, t], prev)
                fused.append(prev)
            heatmaps = torch.stack(fused, dim=1)

        keypoints = extract_keypoints_from_heatmap_first(
            heatmaps.reshape((B * T,) + heatmaps.shape[2:]))
        keypoints = keypoints.reshape(B, T, *keypoints.shape[1:])
        gaussians = render_gaussian_maps_first(keypoints, self.get_sigmas(),
                                               self.heat_grid)
        return heatmaps, keypoints, gaussians, first_feature


class KyptToVoxNet(nn.Module):
    """Gaussian keypoint maps (+ first-frame feature) -> voxel occupancy,
    through the plain voxel decoder (2x trilinear upsample + conv/GN/
    LeakyReLU stages) and the first-frame-biased sharpened sigmoid. With
    ``gaussian_cat_type`` ``max`` (``sum``) every keypoint's map is
    replaced by the max (the sum clipped to [0, 1]) over the keypoints."""

    def __init__(self, cfg: MarionetteConfig, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.conv_kernel = conv_kernel
        C, K = cfg.feat_dim, cfg.nkeypoints
        self.adjust_combined_representation = nn.Sequential(
            nn.Conv3d(2 * K + C + 3, C, 1, device=device),
            nn.LeakyReLU(LEAKY_SLOPE))
        C2, C4 = C // 2, C // 4
        up = nn.Upsample(scale_factor=2, mode="trilinear",
                         align_corners=False)
        act = nn.LeakyReLU(LEAKY_SLOPE)
        # indices match the reference Sequential's state_dict keys
        self.decode_voxel_from_combined_representation = nn.Sequential(
            up,
            nn.Conv3d(C, C2, 3, padding=1, device=device),
            group_norm(C2, device), act,
            nn.Conv3d(C2, C2, 3, padding=1, device=device),
            group_norm(C2, device), act,
            up,
            nn.Conv3d(C2, C4, 3, padding=1, device=device),
            group_norm(C4, device), act,
            nn.Conv3d(C4, C4, 3, padding=1, device=device),
            group_norm(C4, device), act,
            nn.Conv3d(C4, 1, 1, device=device))

    def _decode(self, x):
        d = self.decode_voxel_from_combined_representation
        dt, ck = self.dtype, self.conv_kernel
        x = upsample2_trilinear_first(x)
        x = leaky_relu(norm(d[2], conv(d[1], x, dt, ck)))
        x = leaky_relu(norm(d[5], conv(d[4], x, dt, ck)))
        x = upsample2_trilinear_first(x)
        x = leaky_relu(norm(d[9], conv(d[8], x, dt, ck)))
        x = leaky_relu(norm(d[12], conv(d[11], x, dt, ck)))
        return conv(d[14], x, dt)

    def forward(self, gaussians, first_feature, first_frame,
                sharpness: float = 10.0, translation: float = 0.5):
        """gaussians (B, T, K, g, g, g); first_feature (B, C, g, g, g);
        first_frame (B, G, G, G, 1) -> (B, T, G, G, G, 1)."""
        B, T = gaussians.shape[:2]
        if self.cfg.gaussian_cat_type == "max":
            gaussians = gaussians.amax(dim=2, keepdim=True).expand_as(
                gaussians)
        elif self.cfg.gaussian_cat_type == "sum":
            gaussians = torch.clamp(gaussians.sum(dim=2, keepdim=True), 0,
                                    1).expand_as(gaussians)
        g0 = gaussians[:, :1].expand_as(gaussians)
        ff = first_feature[:, None].expand((B, T) + first_feature.shape[1:])
        combined = torch.cat([gaussians, ff, g0], dim=2)
        combined = combined.reshape((B * T,) + combined.shape[2:])
        combined = add_coord_channels_first(combined)
        x = leaky_relu(conv(self.adjust_combined_representation[0], combined,
                            self.dtype))
        logits = self._decode(x)                          # (BT, 1, G, G, G)
        logits = logits.reshape((B, T) + first_frame.shape[1:])
        return torch.sigmoid(
            sharpness * (torch.tanh(logits) + first_frame[:, None]
                         - translation))


GumbelSource = Union[torch.Tensor, torch.Generator, None]


def gumbel_uniform(shape, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """A uniform draw in [1e-20, 1) from ``generator`` on ``device`` (the
    generator's), formed as ``jax.random.uniform(minval=1e-20,
    maxval=1.0)`` forms it: ``max(1e-20, u + 1e-20)`` in float32."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u + 1e-20, min=1e-20)


class KyptDetector(nn.Module):
    """Encoder + decoder + learned affinity graph + detector losses."""

    def __init__(self, cfg: MarionetteConfig, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.vox_to_kypt = VoxToKyptNet(cfg, dtype, device, conv_kernel)
        self.kypt_to_vox = KyptToVoxNet(cfg, dtype, device, conv_kernel)
        if cfg.keypoints_graph == "affinity_params":
            K, n = cfg.nkeypoints, cfg.nneighbor
            cols = K if cfg.affinity_ver < 3 else K - 1
            fill = 0.0 if cfg.affinity_ver < 3 else 1.0
            self.affinity_params = nn.Parameter(
                torch.full((n, K, cols), fill, device=device))
        else:
            self.register_parameter("affinity_params", None)

    def get_affinity(self, uniform: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """(nneighbor, K, K, 1) affinity of ``affinity_ver``: 0 a row
        softmax; 1 softplus, its Gram matrix with a zero diagonal, rows
        normalised; 2 softplus with a zero diagonal, then a row softmax; 3
        a row softmax over the K-1 other joints, scattered around the zero
        diagonal; 4 version 3 on ``P + g`` with Gumbel noise
        ``g = -log(-log(u + 1e-20) + 1e-20)``, ``u`` the ``uniform`` draw
        (shape of ``affinity_params``, in [1e-20, 1)) or drawn from
        ``generator``; version 4 raises without either."""
        cfg = self.cfg
        P = self.affinity_params
        if P is None:
            raise ValueError(f"keypoints_graph={cfg.keypoints_graph!r} learns "
                             "no affinity (and so no skeleton)")
        ver, K = cfg.affinity_ver, cfg.nkeypoints
        off_diag = 1.0 - torch.eye(K, dtype=P.dtype, device=P.device)
        if ver == 0:
            W = torch.softmax(P, dim=2)
        elif ver == 1:
            W = F.softplus(P)
            W = torch.einsum("nij,nkj->nik", W, W) * off_diag
            W = W / (W.sum(dim=-1, keepdim=True) + 1e-6)
        elif ver == 2:
            W = torch.softmax(F.softplus(P) * off_diag, dim=2)
        elif ver in (3, 4):
            if ver == 4:
                if uniform is None:
                    if generator is None:
                        raise ValueError(
                            "affinity_ver=4 draws Gumbel noise: pass the "
                            "uniform draw or a torch.Generator")
                    uniform = gumbel_uniform(P.shape, generator, P.device)
                elif tuple(uniform.shape) != tuple(P.shape):
                    raise ValueError(f"uniform: shape {tuple(P.shape)} "
                                     f"wanted, got {tuple(uniform.shape)}")
                u = uniform.to(P.device, P.dtype)
                P = P - torch.log(-torch.log(u + 1e-20) + 1e-20)
            Wt = torch.softmax(P, dim=-1)                 # (n, K, K-1)
            zeros_col = torch.zeros((Wt.shape[0], K, 1), dtype=Wt.dtype,
                                    device=Wt.device)
            m_up = torch.cat([zeros_col, torch.triu(Wt, diagonal=0)], dim=-1)
            m_low = torch.cat([torch.tril(Wt, diagonal=-1), zeros_col],
                              dim=-1)
            W = m_up + m_low
        else:
            raise ValueError(f"affinity_ver={ver!r}: invalid affinity "
                             "version (0-4)")
        return W[..., None]

    def forward(self, seq: torch.Tensor, affinity_active: bool = True,
                gumbel: GumbelSource = None) -> dict[str, Any]:
        """``gumbel``: version 4's uniform draw, or the generator to draw it
        from (``get_affinity``)."""
        cfg = self.cfg
        B, T = seq.shape[:2]
        heatmaps, keypoints, gaussians, first_feature = self.vox_to_kypt(seq)
        recon = self.kypt_to_vox(gaussians, first_feature, seq[:, 0])
        heatmaps = heatmaps.permute(0, 1, 3, 4, 5, 2)  # channels-last

        recon_loss = L.bce_recon_loss(recon, seq)
        zero_bt = torch.zeros((B, T), dtype=seq.dtype, device=seq.device)
        sparsity_loss = L.keypoint_sparsity_loss(heatmaps)
        separation_loss = L.temporal_separation_loss(keypoints, cfg.sep_sigma)
        vol_fit_reg = L.volume_fitting_loss(seq, keypoints,
                                            self.vox_to_kypt.get_sigmas(),
                                            cfg.vol_fit_type)

        if cfg.keypoints_graph == "none" or not affinity_active:
            affinity = None
            local = time_c = sparsity_c = intensity_c = graph_traj = zero_bt
        else:
            if isinstance(gumbel, torch.Generator):
                affinity = self.get_affinity(generator=gumbel)
            else:
                affinity = self.get_affinity(uniform=gumbel)
            kp = keypoints.detach() if cfg.keypoints_detach else keypoints
            local, time_c, sparsity_c, intensity_c = \
                L.graph_consistency_losses(
                    kp, affinity,
                    local_const=bool(cfg.using_local_const),
                    time_const=bool(cfg.using_time_const),
                    sparsity_const=bool(cfg.using_sparsity_const),
                    ver=cfg.graph_loss_ver)
            if cfg.graph_traj_weight > 0:
                graph_traj = L.graph_trajectory_loss(kp, affinity,
                                                     ver=cfg.graph_loss_ver)
            else:
                graph_traj = zero_bt

        return dict(
            recon=recon,
            keypoints=keypoints,
            heatmaps=heatmaps,
            affinity=affinity,
            recon_loss=recon_loss.mean(),
            vol_fit_reg=vol_fit_reg.mean(),
            kypt_const_loss=zero_bt.mean(),  # dead upstream
            separation_loss=separation_loss.mean(),
            sparsity_loss=sparsity_loss.mean(),
            local_const_loss=local.mean(),
            time_const_loss=time_c.mean(),
            sparsity_const_loss=sparsity_c.mean(),
            intensity_const_loss=intensity_c.mean(),
            graph_traj_loss=graph_traj.mean(),
            graph_vol_loss=zero_bt.mean(),  # always zero upstream
            first_feature=first_feature.permute(0, 2, 3, 4, 1),
        )

    def decode_from_dyna(self, keypoints, first_feature, first_frame
                         ) -> dict[str, Any]:
        """Keypoints of a rollout -> voxels (reference
        kypt_detector.py:213-241): Gaussian maps with the fixed sigma list
        ``[gaussian_sigma] * K`` (not the learned sigmas, as upstream), then
        the decoder. ``keypoints`` (B, T, K, 4); ``first_feature``
        (B, g, g, g, C), channels-last as :meth:`forward` returns it;
        ``first_frame`` (B, G, G, G, 1). Returns ``gen`` (B, T, G, G, G, 1)."""
        cfg = self.cfg
        sigmas = torch.full((cfg.nkeypoints,), cfg.gaussian_sigma,
                            dtype=keypoints.dtype, device=keypoints.device)
        gaussians = render_gaussian_maps_first(keypoints, sigmas,
                                               cfg.grid_size // 4)
        gen = self.kypt_to_vox(gaussians, first_feature.permute(0, 4, 1, 2, 3),
                               first_frame)
        return dict(gen=gen)
