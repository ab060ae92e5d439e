"""Keypoint detector: voxel encoder, keypoint head, voxel decoder, affinity.

Counterpart of ``neural_marionette_tpu/models/detector.py`` on its plain
path (the strip, upconv, hybrid and frame-chunk rewrites are TPU layout
work and are not ported). Time is folded into the batch, as there.
Public tensors keep the JAX layouts (voxels ``(B, T, G, G, G, 1)``,
heatmaps ``(B, T, g, g, g, K)``, keypoints ``(B, T, K, 4)``); convolutions
run in NCDHW inside.

Only the configuration of the AIST preset is ported; see
``config.check_supported``.
"""
from __future__ import annotations

from typing import Any

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


def heatmap_head(C: int, K: int, device) -> nn.Sequential:
    """1x1 conv head; const_intensity 3 activates with LeakyReLU."""
    return nn.Sequential(nn.Conv3d(C, K, 1, device=device),
                         nn.LeakyReLU(LEAKY_SLOPE))


class VoxToKyptNet(nn.Module):
    """Per-frame voxel encoder + spatial soft-argmax, const_intensity 3: a
    spatio-temporal (sequence-mean) prior heatmap, constant across frames,
    fused with each frame's heatmap by a 1x1 conv + softplus."""

    def __init__(self, cfg: MarionetteConfig, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.heat_grid = cfg.grid_size // 4
        C, K = cfg.feat_dim, cfg.nkeypoints
        self.extract_features = feature_net(C, cfg.grid_size, dtype, device,
                                            conv_kernel)
        self.extract_heatmaps_from_features = heatmap_head(C, K, device)
        self.extract_spatio_temporal_features = feature_net(
            2 * C, cfg.grid_size, dtype, device, conv_kernel)
        self.extract_spatio_temporal_heatmaps_from_features = heatmap_head(
            2 * C, K, device)
        self.propagate_heatmaps = nn.Sequential(
            nn.Conv3d(2, 1, 1, device=device), nn.Softplus())

    def sigmas(self) -> torch.Tensor:
        cfg = self.cfg
        return torch.full((cfg.nkeypoints,), cfg.gaussian_sigma,
                          dtype=self.dtype,
                          device=self.propagate_heatmaps[0].weight.device)

    def _heatmaps(self, head: nn.Sequential, feats):
        return leaky_relu(conv(head[0], feats, self.dtype))

    def forward(self, seq: torch.Tensor):
        """``seq`` (B, T, G, G, G, 1) -> (heatmaps (B, T, K, g, g, g),
        keypoints (B, T, K, 4), gaussians (B, T, K, g, g, g),
        first_feature (B, C, g, g, g))."""
        B, T = seq.shape[:2]
        seq_summed = _channels_last_vox(seq.mean(dim=1))
        prev = self._heatmaps(
            self.extract_spatio_temporal_heatmaps_from_features,
            self.extract_spatio_temporal_features(
                add_coord_channels_first(seq_summed)))   # (B, K, g, g, g)

        frames = _channels_last_vox(seq.reshape((B * T,) + seq.shape[2:]))
        features = self.extract_features(add_coord_channels_first(frames))
        heatmaps = self._heatmaps(self.extract_heatmaps_from_features,
                                  features)               # (BT, K, g, g, g)
        heatmaps = heatmaps.reshape((B, T) + heatmaps.shape[1:])
        first_feature = features.reshape((B, T) + features.shape[1:])[:, 0]

        # softplus(w0 * h + w1 * prev + b), in float32 as the JAX package's
        # float32 parameters promote it
        w = self.propagate_heatmaps[0].weight.reshape(2)
        b = self.propagate_heatmaps[0].bias[0]
        heatmaps = F.softplus(w[0] * heatmaps.float()
                              + w[1] * prev.float()[:, None] + b)

        keypoints = extract_keypoints_from_heatmap_first(
            heatmaps.reshape((B * T,) + heatmaps.shape[2:]))
        keypoints = keypoints.reshape(B, T, *keypoints.shape[1:])
        gaussians = render_gaussian_maps_first(keypoints, self.sigmas(),
                                               self.heat_grid)
        return heatmaps, keypoints, gaussians, first_feature


class KyptToVoxNet(nn.Module):
    """Gaussian keypoint maps (+ first-frame feature) -> voxel occupancy,
    through the plain voxel decoder (2x trilinear upsample + conv/GN/
    LeakyReLU stages) and the first-frame-biased sharpened sigmoid."""

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


class KyptDetector(nn.Module):
    """Encoder + decoder + learned affinity graph (ver 3) + detector losses."""

    def __init__(self, cfg: MarionetteConfig, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.vox_to_kypt = VoxToKyptNet(cfg, dtype, device, conv_kernel)
        self.kypt_to_vox = KyptToVoxNet(cfg, dtype, device, conv_kernel)
        K, n = cfg.nkeypoints, cfg.nneighbor
        self.affinity_params = nn.Parameter(
            torch.ones((n, K, K - 1), device=device))

    def get_affinity(self) -> torch.Tensor:
        """(nneighbor, K, K, 1) affinity, version 3: a row softmax over the
        K-1 other joints, scattered around the zero diagonal."""
        K = self.cfg.nkeypoints
        Wt = torch.softmax(self.affinity_params, dim=-1)  # (n, K, K-1)
        zeros_col = torch.zeros((Wt.shape[0], K, 1), dtype=Wt.dtype,
                                device=Wt.device)
        m_up = torch.cat([zeros_col, torch.triu(Wt, diagonal=0)], dim=-1)
        m_low = torch.cat([torch.tril(Wt, diagonal=-1), zeros_col], dim=-1)
        return (m_up + m_low)[..., None]

    def forward(self, seq: torch.Tensor,
                affinity_active: bool = True) -> dict[str, Any]:
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
                                            self.vox_to_kypt.sigmas(),
                                            cfg.vol_fit_type)

        if not affinity_active:
            affinity = None
            local = time_c = sparsity_c = intensity_c = graph_traj = zero_bt
        else:
            affinity = self.get_affinity()
            local, time_c, sparsity_c, intensity_c = \
                L.graph_consistency_losses(
                    keypoints, affinity,
                    local_const=bool(cfg.using_local_const),
                    time_const=bool(cfg.using_time_const),
                    sparsity_const=bool(cfg.using_sparsity_const),
                    ver=cfg.graph_loss_ver)
            if cfg.graph_traj_weight > 0:
                graph_traj = L.graph_trajectory_loss(keypoints, affinity,
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
