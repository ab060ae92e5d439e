"""HSVRNNBVH: variational-RNN latent dynamics over keypoints with
forward-kinematic 6D-rotation decoding: ``encode`` and the demo rollouts
``generate``, ``generate_many`` and ``interpolate``.

Counterpart of ``neural_marionette_tpu/models/dynamics.py``: the GRU cell,
the posterior/prior and decoder MLPs, best-of-N sampling with the N
samples folded into the batch, pointer-doubling FK. Parameter names follow
the reference ``state_dict`` (``model/hsvrnn_bvh.py``). The dynamics
compute in float32 whatever the detector's dtype, as in the JAX package.

Every rollout is a Python loop over t. Its standard-normal draws come in
as ``eps`` (laid out one to one onto the JAX package's draws, so the tests
replay them) or are drawn from ``generator`` on the keypoints' device.
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

    @staticmethod
    def _dist(raw):
        mean, sraw = raw.chunk(2, dim=-1)
        return mean, F.softplus(sraw) + 1e-4  # hsvrnn_bvh.py:95,103

    def _posterior(self, h, keypoint_flat):
        """(mean, std) of the posterior on ``[h, x]``."""
        return self._dist(self.extract_post_dist(
            torch.cat([h, keypoint_flat], dim=-1)))

    def _prior(self, h):
        """(mean, std) of the prior on ``h``."""
        return self._dist(self.extract_prior_dist(h))

    def _post_prior_fused(self, h, keypoint_flat):
        """Posterior(h, x) and prior(h). The JAX package fuses the two MLPs
        into one (XLA folds the weight concatenation); eager PyTorch would
        rebuild the fused weights on every step, so the modules run as they
        are. Returns (post_mean, post_std, prior_mean, prior_std)."""
        return self._posterior(h, keypoint_flat) + self._prior(h)

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

    # ----------------------------------------------------- demo rollouts
    def _noise(self, eps, shapes, generator, device, what):
        """The rollout's standard-normal draws: ``eps`` (a tuple of tensors
        of ``shapes``) checked, or drawn from ``generator`` on ``device``."""
        if eps is None:
            return tuple(torch.randn(s, generator=generator, device=device)
                         for s in shapes)
        got = tuple(tuple(e.shape) for e in eps)
        if got != tuple(shapes):
            raise ValueError(f"{what}: eps must be {tuple(shapes)}, got {got}")
        return tuple(eps)

    def _condition(self, keypoints, eps, offset_rep, skeleton):
        """Posterior best-of-N steps over the conditioning frames of
        ``keypoints`` (B, T, K, 4) from the learned initial state, with the
        draws ``eps`` (T, S, B, Z). Returns (h, the best keypoints of each
        step, (B, K*4) each)."""
        B, T = keypoints.shape[:2]
        h = self.init_kypt_rnn_state.expand(B, self.H)
        best = []
        for t in range(T):
            keypoint_flat = keypoints[:, t].reshape(B, -1)
            post_mean, post_std = self._posterior(h, keypoint_flat)
            z_samples = post_mean[None] + post_std[None] * eps[t]
            best_z, best_kypt, _, _ = self._best_of_n(
                h, z_samples, offset_rep, skeleton, keypoint_flat)
            h = self._gru(torch.cat([best_kypt, best_z], dim=-1), h)
            best.append(best_kypt)
        return h, best

    def _prior_step(self, h, eps, offset, skeleton):
        """One prior step: z from the prior on ``h`` with the draws ``eps``,
        decoded with ``offset``, then the GRU. Returns (h, keypoints flat)."""
        prior_mean, prior_std = self._prior(h)
        z = prior_mean + prior_std * eps
        kypt_flat, _ = self.extract_kypt_from_latent_and_state(
            torch.cat([h, z], dim=-1), offset, skeleton)
        return self._gru(torch.cat([kypt_flat, z], dim=-1), h), kypt_flat

    def generate_many(self, keypoints_cond, skeleton: SkeletonArrays,
                      Ttot: int, Tcond: int, sample_num: int = 3,
                      eps=None, generator: Optional[torch.Generator] = None):
        """Conditioned collapse, then ``sample_num`` independent prior
        rollouts (the generation demo, reference vis_generation.py:92-127):
        each conditioning step draws ``sample_num`` posterior samples and
        keeps the best; the state then fans out.

        ``keypoints_cond`` (1, Tcond, K, 4). ``eps`` = (conditioning draws
        (Tcond, sample_num, 1, Z), prior draws (Ttot-Tcond, sample_num, Z)),
        the JAX package's ``split(fold_in(rng, 0), Tcond)`` and
        ``split(fold_in(rng, 1), Ttot-Tcond)`` draws. Returns
        (cond_keypoints (1, Tcond, K, 4), the detected keypoints;
        gen_keypoints (sample_num, Ttot-Tcond, K, 4))."""
        keypoints_cond = keypoints_cond.float()
        B, T, K, _ = keypoints_cond.shape
        if B != 1 or T != Tcond:
            raise ValueError(f"generate_many takes one clip of Tcond={Tcond}"
                             f" frames, got {tuple(keypoints_cond.shape)}")
        S, Z, Tgen = sample_num, self.Z, Ttot - Tcond
        eps_cond, eps_gen = self._noise(
            eps, ((Tcond, S, 1, Z), (Tgen, S, Z)), generator,
            keypoints_cond.device, "generate_many")
        offset_rep = self.get_offset(keypoints_cond, skeleton.parents
                                     ).repeat(S, 1, 1)
        h, _ = self._condition(keypoints_cond, eps_cond, offset_rep, skeleton)
        h = h.expand(S, self.H)
        gen = []
        for t in range(Tgen):
            h, kypt_flat = self._prior_step(h, eps_gen[t], offset_rep,
                                            skeleton)
            gen.append(kypt_flat)
        return keypoints_cond, torch.stack(gen, 1).reshape(S, Tgen, K, -1)

    def generate(self, keypoints_cond, skeleton: SkeletonArrays,
                 Ttot: int = 10, Tcond: int = 3, sample_num: int = 10,
                 eps=None, generator: Optional[torch.Generator] = None
                 ) -> dict[str, Any]:
        """Conditioned posterior steps, then one prior rollout per batch row
        (reference hsvrnn_bvh.py:158-234).

        ``keypoints_cond`` (B, Tcond, K, 4). ``eps`` = (conditioning draws
        (Tcond, sample_num, B, Z), prior draws (Ttot-Tcond, B, Z)), laid out
        as ``generate_many``'s. Returns the best conditioning samples
        ``keypoints_cond`` (B, Tcond, K, 4) and ``keypoints_gen``
        (B, Ttot-Tcond, K, 4)."""
        keypoints_cond = keypoints_cond.float()
        B, T, K, _ = keypoints_cond.shape
        if T != Tcond:
            raise ValueError(f"generate takes Tcond={Tcond} frames, got "
                             f"{tuple(keypoints_cond.shape)}")
        S, Z, Tgen = sample_num, self.Z, Ttot - Tcond
        eps_cond, eps_gen = self._noise(
            eps, ((Tcond, S, B, Z), (Tgen, B, Z)), generator,
            keypoints_cond.device, "generate")
        offset = self.get_offset(keypoints_cond, skeleton.parents)
        h, cond = self._condition(keypoints_cond, eps_cond,
                                  offset.repeat(S, 1, 1), skeleton)
        gen = []
        for t in range(Tgen):
            # the rollout decodes with ``offset``, one row per clip
            h, kypt_flat = self._prior_step(h, eps_gen[t], offset, skeleton)
            gen.append(kypt_flat)
        return dict(
            keypoints_cond=torch.stack(cond, 1).reshape(B, Tcond, K, -1),
            keypoints_gen=torch.stack(gen, 1).reshape(B, Tgen, K, -1))

    def interpolate(self, keypoints, skeleton: SkeletonArrays,
                    anchor_rate: int = 10, sample_num: int = 10000,
                    eps=None, generator: Optional[torch.Generator] = None):
        """Anchor-constrained latent in-betweening (the interpolation demo,
        reference vis_interpolation.py:91-136): ``sample_num`` parallel
        prior rollouts between anchor frames (``t % anchor_rate == 0`` or
        the last frame). At an anchor the state collapses to the best
        posterior sample against the detected keypoints, and the in-between
        trajectory whose extra prior sample lands nearest that best sample
        is kept for the whole segment back to the previous anchor.

        ``keypoints`` (1, T, K, 4). ``eps`` = (posterior draws (T, S, Z),
        prior draws (T, S, Z)): an anchor step t draws its posterior sample
        from row t of the first and its prior sample from row t of the
        second (the JAX package's ``split(fold_in(rng, t))`` keys k1, k2);
        an in-between step draws from row t of the second (the key
        ``fold_in(rng, t)`` itself) and row t of the first goes unused.
        Returns the selected keypoints (1, T, K, 4) with the intensities
        of frame 0 on every frame (reference :136)."""
        keypoints = keypoints.float()
        B, T, K, _ = keypoints.shape
        if B != 1:
            raise ValueError(f"interpolate takes one clip, got B={B}")
        S, Z = sample_num, self.Z
        eps_post, eps_prior = self._noise(
            eps, ((T, S, Z), (T, S, Z)), generator, keypoints.device,
            "interpolate")
        offset = self.get_offset(keypoints, skeleton.parents)
        offset_rep = offset.repeat(S, 1, 1)
        h = self.init_kypt_rnn_state.expand(S, self.H)
        kp_det_seq = keypoints[0].reshape(T, K * 4)
        stored, chooses = [], []
        seg_start = 0
        for t in range(T):
            if t % anchor_rate == 0 or t == T - 1:
                kp_det = kp_det_seq[t][None].expand(S, K * 4)
                post_mean, post_std, prior_mean, prior_std = \
                    self._post_prior_fused(h, kp_det)
                z_post = post_mean + post_std * eps_post[t]
                z_choose = prior_mean + prior_std * eps_prior[t]
                kp_post, _ = self.extract_kypt_from_latent_and_state(
                    torch.cat([h, z_post], dim=-1), offset_rep, skeleton)
                kp_choose, _ = self.extract_kypt_from_latent_and_state(
                    torch.cat([h, z_choose], dim=-1), offset_rep, skeleton)
                # collapse to the best posterior sample (first on ties)
                best = torch.argmin(((kp_post - kp_det) ** 2).sum(dim=-1))
                kp_best = kp_post[best][None].expand(S, K * 4)
                z = z_post[best][None].expand(S, Z)
                h_c = h[best][None].expand(S, self.H)
                choose = torch.argmin(((kp_choose - kp_best) ** 2).sum(
                    dim=-1))
                h = self._gru(torch.cat([kp_best, z], dim=-1), h_c)
                stored.append(kp_det)
                # the segment back to the previous anchor keeps ``choose``
                chooses += [choose] * (t + 1 - seg_start)
                seg_start = t + 1
            else:
                h, kp_flat = self._prior_step(h, eps_prior[t], offset_rep,
                                              skeleton)
                stored.append(kp_flat)
        kp_all = torch.stack(stored)                        # (T, S, K*4)
        sel = torch.stack(chooses)                          # (T,)
        out = kp_all[torch.arange(T, device=sel.device), sel].reshape(
            1, T, K, 4).clone()
        out[0, :, :, -1] = out[0, 0, :, -1]
        return out
