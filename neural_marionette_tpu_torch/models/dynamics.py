"""HSVRNNBVH: variational-RNN latent dynamics over keypoints with
forward-kinematic 6D-rotation decoding — the ``encode`` path.

Counterpart of ``neural_marionette_tpu/models/dynamics.py``: the GRU cell,
the posterior/prior and decoder MLPs, best-of-N sampling with the N
samples folded into the batch, pointer-doubling FK. Parameter names follow
the reference ``state_dict`` (``model/hsvrnn_bvh.py``). The dynamics
compute in float32 whatever the detector's dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import MarionetteConfig
from ..ops.fk import fk_global_rotations_parallel, fk_positions_parallel
from ..ops.losses import gaussian_kl
from ..ops.rotations import rotation_6d_to_matrix


class SkeletonArrays(NamedTuple):
    """Tensor form of :class:`..skeleton.Skeleton`, as the FK consumes it."""
    priority_indices: torch.Tensor  # (K,) int64, root first
    parents: torch.Tensor           # (K,) int64

    @classmethod
    def from_skeleton(cls, sk, device=None):
        return cls(torch.as_tensor(np.asarray(sk.priority_indices),
                                   dtype=torch.long, device=device),
                   torch.as_tensor(np.asarray(sk.parents), dtype=torch.long,
                                   device=device))

    @classmethod
    def chain(cls, K: int, device=None):
        """Trivial 0-1-2-... chain, a placeholder before a skeleton exists."""
        parents = torch.clamp(torch.arange(K, device=device) - 1, min=0)
        return cls(torch.arange(K, device=device), parents)


def _mlp(in_f: int, out_f: int, device) -> nn.Sequential:
    return nn.Sequential(nn.Linear(in_f, 128, device=device),
                         nn.LeakyReLU(0.01),
                         nn.Linear(128, out_f, device=device))


class HSVRNNBVH(nn.Module):
    """Prior/posterior GRU over keypoint states (reference hsvrnn_bvh.py)."""

    def __init__(self, cfg: MarionetteConfig, device=None):
        super().__init__()
        K, Z, H = cfg.nkeypoints, cfg.nlatent_kypt, cfg.nhidden_kypt
        S = K * (cfg.input_dim + 1)
        self.K, self.Z, self.H, self.S = K, Z, H, S
        self.extract_post_dist = _mlp(H + S, 2 * Z, device)
        self.extract_prior_dist = _mlp(H, 2 * Z, device)
        self.root_intensity_decoder = _mlp(H + Z, 3 + K, device)
        self.joint_matrix_decoder = _mlp(H + Z, 6 * K, device)
        self.kypt_rnn_cell = nn.GRUCell(S + Z, H, device=device)
        self.init_kypt_rnn_state = nn.Parameter(torch.zeros(1, H,
                                                            device=device))
        self.offset_param = nn.Parameter(torch.zeros(K, 3, device=device))

    # ------------------------------------------------------------ primitives
    def _gru(self, x, h):
        """torch.nn.GRUCell semantics (reset gate inside the candidate)."""
        return self.kypt_rnn_cell(x, h)

    def _post_prior_fused(self, h, keypoint_flat):
        """Posterior(h, x) and prior(h). The JAX package fuses the two MLPs
        into one (XLA folds the weight concatenation); eager PyTorch would
        rebuild the fused weights on every step, so the modules run as they
        are. Returns (post_mean, post_std, prior_mean, prior_std)."""
        post = self.extract_post_dist(torch.cat([h, keypoint_flat], dim=-1))
        prior = self.extract_prior_dist(h)
        post_mean, post_sraw = post.chunk(2, dim=-1)
        prior_mean, prior_sraw = prior.chunk(2, dim=-1)
        eps = 1e-4  # hsvrnn_bvh.py:95,103
        return (post_mean, F.softplus(post_sraw) + eps,
                prior_mean, F.softplus(prior_sraw) + eps)

    def _decoder_fused(self, x):
        """Both decoder heads on ``x``, unfused as in ``_post_prior_fused``.
        Returns (root raw pre-tanh (B, 3+K), rot6d flat (B, 6K))."""
        return self.root_intensity_decoder(x), self.joint_matrix_decoder(x)

    # -------------------------------------------------------------- decoding
    def extract_kypt_from_latent_and_state(self, decoder_input, offset,
                                           skeleton: SkeletonArrays):
        """(B, H+Z), (B, K, 3) -> (flat keypoints (B, K*4), R (B, K, 3, 3))."""
        K = self.K
        root_raw, rot6d = self._decoder_fused(decoder_input)
        raw = torch.tanh(root_raw)
        root_pos = raw[:, :3]
        intensity = (raw[:, 3:] + 1.0) * 0.5
        R_local = rotation_6d_to_matrix(rot6d.reshape(-1, K, 6))
        R_glob = fk_global_rotations_parallel(
            R_local, skeleton.priority_indices, skeleton.parents)
        pos = fk_positions_parallel(R_glob, offset, root_pos,
                                    skeleton.priority_indices,
                                    skeleton.parents)
        processed = torch.cat([pos, intensity[..., None]], dim=-1)
        return processed.reshape(processed.shape[0], -1), R_glob

    def get_offset(self, keypoints, parents):
        """Bone offsets: lower-median (over T) distance to the parent times
        the frozen unit directions (torch.median takes the lower middle)."""
        T = keypoints.shape[1]
        pos = keypoints[..., :3]
        dist = torch.sqrt(((pos[:, :, :, None] - pos[:, :, None]) ** 2
                           ).sum(dim=-1))                 # (B, T, K, K)
        med = torch.sort(dist, dim=1).values[:, (T - 1) // 2]  # (B, K, K)
        idx = parents.long()[None, :, None].expand(med.shape[0], -1, 1)
        scale = torch.gather(med, -1, idx)[..., 0]        # med[:, k, p[k]]
        direction = self.offset_param / (torch.sqrt(
            (self.offset_param ** 2).sum(dim=-1, keepdim=True)) + 1e-10)
        return (direction[None] * scale[..., None]).detach()

    def _best_of_n(self, prev_state, z_samples, offset_rep, skeleton,
                   keypoint_flat):
        """Decode N samples and pick, per batch row, the argmin L2 to the
        detected keypoints. Returns (z, keypoints, R, index)."""
        S_num, B, Z = z_samples.shape
        state_rep = prev_state[None].expand(S_num, B, self.H)
        dec_in = torch.cat([state_rep, z_samples], dim=-1)
        kypt_flat, R = self.extract_kypt_from_latent_and_state(
            dec_in.reshape(S_num * B, self.H + Z), offset_rep, skeleton)
        kypt_flat = kypt_flat.reshape(S_num, B, -1)
        R = R.reshape(S_num, B, self.K, 3, 3)
        d = ((keypoint_flat[None] - kypt_flat) ** 2).sum(dim=-1)  # (S, B)
        best = torch.argmin(d, dim=0)
        b_idx = torch.arange(B, device=best.device)
        return (z_samples[best, b_idx], kypt_flat[best, b_idx],
                R[best, b_idx], best)

    # ----------------------------------------------------------------- encode
    def encode(self, keypoints, skeleton: SkeletonArrays,
               sample_num: int = 10, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> dict[str, Any]:
        """Posterior-driven rollout with best-of-N sampling.

        ``keypoints``: (B, T, K, 4), detached by the caller. ``eps``: the
        standard-normal draws, (T, sample_num, B, Z); drawn from
        ``generator`` when not given."""
        keypoints = keypoints.float()
        B, T, K, _ = keypoints.shape
        if eps is None:
            eps = torch.randn((T, sample_num, B, self.Z), generator=generator,
                              device=keypoints.device)
        if eps.shape != (T, sample_num, B, self.Z):
            raise ValueError(f"eps must be {(T, sample_num, B, self.Z)}, "
                             f"got {tuple(eps.shape)}")
        offset = self.get_offset(keypoints, skeleton.parents)
        offset_rep = offset.repeat(sample_num, 1, 1)
        h0 = self.init_kypt_rnn_state.expand(B, self.H)
        h = h0
        kypts, Rs, zs, hs, kls, idx = [], [], [], [], [], []
        for t in range(T):
            keypoint_flat = keypoints[:, t].reshape(B, -1)
            post_mean, post_std, prior_mean, prior_std = \
                self._post_prior_fused(h, keypoint_flat)
            z_samples = post_mean[None] + post_std[None] * eps[t]
            best_z, best_kypt, best_R, best = self._best_of_n(
                h, z_samples, offset_rep, skeleton, keypoint_flat)
            h = self._gru(torch.cat([best_kypt, best_z], dim=-1), h)
            kypts.append(best_kypt)
            Rs.append(best_R)
            zs.append(best_z)
            hs.append(h)
            kls.append(gaussian_kl(post_mean, post_std, prior_mean,
                                   prior_std))
            idx.append(best)

        keypoints_inferred = torch.stack(kypts, 1).reshape(B, T, K, -1)
        kypt_recon_loss = ((keypoints_inferred - keypoints) ** 2).sum(
            dim=(2, 3))                                   # (B, T)
        zero = torch.zeros((), dtype=keypoints.dtype, device=keypoints.device)
        return dict(
            kypt_recon=keypoints_inferred[..., :4],
            R=torch.stack(Rs, 1),
            z_kypts=torch.stack(zs, 1),
            h_kypts=torch.cat([h0[:, None], torch.stack(hs, 1)], dim=1),
            kl_kypt=torch.stack(kls, 1).mean(),
            kypt_recon_loss=kypt_recon_loss.mean(),
            gae_recon_loss=zero,   # dead upstream
            topo_recon_loss=zero,  # dead upstream
            best_index=torch.stack(idx, 1),               # (B, T)
        )
