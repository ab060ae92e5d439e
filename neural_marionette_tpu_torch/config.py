"""Configuration of the port: a copy of the JAX package's ``config.py``.

:class:`MarionetteConfig` keeps the JAX package's fields and defaults (the
reference CLI flag names) and :func:`adjust_config` its per-dataset
overrides, so one configuration drives both packages. The port implements
the configuration of the AIST preset only; :func:`check_supported` rejects
every other value of the options it does not implement.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class MarionetteConfig:
    # training itself (reference train.py:27-34)
    seed: int = 0
    nepoch: int = 2000
    lrate: float = 1e-3
    firstdecay: int = 1
    seconddecay: int = 10
    resume_epoch: str = "0"
    max_grad_norm: float = 30.0
    device: str = "tpu"

    # saving & logging (reference train.py:37-43)
    training_id: Optional[str] = None
    save_every: int = 1
    save_que_len: int = 100
    log_every: int = 1
    exp_name: str = "default"
    log_gif_num: int = 8
    log_gif_every: int = 1
    log_save_every: int = 50

    # dataset (reference train.py:46-57)
    dataset: str = "dfaust"
    nbatch: int = 24
    input_dim: int = 3
    grid_size: int = 64
    is_binarized: int = 1
    Ttot: int = 10
    Tcond: int = 5
    sample_rate: int = 1
    random_crop: int = 1
    surface_sampled: int = 1
    debug: int = 0
    is_eval: int = 0
    # opt-in voxel-chamfer eval metric (the reference implements it in
    # eval_utils.py:29-55 but never wires it into the loop, train.py:332)
    eval_voxel_chamfer: int = 0

    # architecture (reference train.py:60-65)
    nkeypoints: int = 22
    gaussian_sigma: float = 1.5
    dyna_module: str = "HSVRNNBVH"  # reference hardcodes HSVRNNBVH regardless
    nlatent_kypt: int = 128
    nhidden_kypt: int = 512
    sep_sigma: float = 0.02

    # loss weights (reference train.py:68-82)
    recon_weight: float = 100.0
    sparse_weight: float = 5.0
    sep_weight: float = 0.1
    vol_reg_weight: float = 10.0
    kypt_const_weight: float = 0.0
    local_const_weight: float = 1e-3
    time_const_weight: float = 1.0
    sparsity_const_weight: float = 0.01
    intensity_const_weight: float = 0.01
    graph_traj_weight: float = 1.0
    graph_vol_weight: float = 0.0
    kypt_recon_weight: float = 1.0
    kl_kypt_weight: float = 0.003
    gae_recon_weight: float = 1.0
    topo_recon_weight: float = 0.01

    # anneal-related (reference train.py:85-89)
    detector_start: int = 0
    affinity_anneal: int = 0
    learner_start: int = int(1e9)
    detector_end: int = -1
    learner_end: int = -1

    # pretraining (reference train.py:92-93)
    pretrained_mode: int = 0
    pretrained_dir: str = "pretrained"

    # experimental - detector (reference train.py:96-109)
    vol_fit_type: str = "chamfer"
    gaussian_cat_type: str = "none"
    fixed_sigma: int = 1
    keypoints_graph: str = "affinity_params"
    nneighbor: int = 2
    keypoints_detach: int = 0
    graph_random_init: int = 0
    using_local_const: int = 1
    using_time_const: int = 1
    using_sparsity_const: int = 1
    using_intensity_const: int = 1
    const_intensity: int = 3
    affinity_ver: int = 3
    graph_loss_ver: int = 1

    # experimental - dynamics learner (reference train.py:112-120)
    transition_type: str = "dl"
    using_pose_feature: int = 1
    nlatent_pose: int = 32
    using_dim_enhance: int = 1
    enhance_dim: int = 16
    sharing_enc_net: int = -1
    state_mode: str = "no_cat"
    action_mode: str = "pose"
    appnp_alpha: float = 0.3

    # vestigial RL-agent flags, kept for reference-pickle compatibility only
    ncontrols: int = 5
    replay_size: float = 4e3
    agent_gamma: float = 0.99
    agent_alpha: float = 0.2
    agent_polyak: float = 0.995
    rod_init_mode: str = "static_uniform"
    mapping_mode: str = "node"
    start_step: int = 500

    # TPU-framework-specific knobs (no reference equivalent)
    feat_dim: int = 128  # detector feature width (reference hardcodes 128)
    data_root: str = "data"
    output_root: str = "output"
    mesh_data: int = -1  # -1 => all devices on the data axis
    mesh_model: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # bfloat16 optionally for conv stacks
    debug_nans: int = 0
    profile_dir: str = ""  # capture a jax.profiler trace of early steps
    # rematerialize detector conv stacks (trades backward recompute for
    # HBM).  Measured policy at flagship scale (BASELINE.md r4): leave 0
    # for microbatches <= 12 seqs (120 folded frames — fits, and is ~14%
    # faster than remat=1); set 1 above that, 2 only to bound the
    # single-microbatch peak further.
    remat: int = 0
    # strip-packed decoder convs (ops/stripconv.py): -1 = auto (TPU
    # backend only — CPU XLA compiles the strip form pathologically
    # slowly and its conv is already fine there), 0 = off, 1 = force on
    strip_decoder: int = -1
    # fused upsample+conv (ops/upconv.py) for the decoder's second
    # upsample stage (32^3 64->32): measured 1.73-1.85x on hardware vs
    # upsample2_trilinear + conv3d (scripts/bench_upconv.py); -1 = auto
    # (TPU only), 0 = off, 1 = force on
    upconv_decoder: int = -1
    # strip-packed encoder front end (stem + first pool lane-packed at
    # the full grid; ops/stripconv + coord-split field): measured stem
    # fwd 9.6->5.5 ms / wgrad 17.9->2.7 ms, pool 4.5->2.2 ms at 40
    # frames (scripts/bench_encoder_parts.py); -1 = auto (TPU only),
    # 0 = off, 1 = force on
    strip_encoder: int = -1
    # strip-path routing gate: fold-frame count at or below which the
    # strip (lane-packed) conv paths are used; 0 = env NM_STRIP_MAX_FRAMES
    # or 64 (the measured FORWARD crossover — at >=~128 frames XLA's
    # batch-minor layouts win).  The training driver raises it to 96:
    # the strip BACKWARD (weight-grad) still wins there (measured
    # B=8 accum=1: strip 12.63 vs plain 11.23 seqs/sec).
    strip_max_frames: int = 0
    # folded-frame chunking through the conv stacks: XLA lays large conv
    # temps out batch-minor with the folded B*T frame count padded to the
    # next 128-lane multiple, so e.g. B=16 (160 frames -> 256 lanes)
    # silently wastes 1.6x of every conv store/load.  Splitting the
    # folded axis into a (N//128)*128 head (zero pad) plus a <128 tail
    # (strip-packed when under the strip gate) makes per-frame throughput
    # flat in B instead of cliffed at 128-multiples.  -1 = auto (128 on
    # TPU, off elsewhere), 0 = off, >0 = chunk size
    frame_chunk: int = -1
    grad_accum: int = 1  # microbatches per step (activation-memory relief)
    # 1 = recreate fresh Adam moments at every epoch start — the
    # reference's exact optimizer semantics (reference train.py:366-374).
    # Default 0 keeps one persistent Adam (documented deviation; better
    # training dynamics).  Used by the training-dynamics parity run.
    opt_reset_per_epoch: int = 0
    num_workers: int = 4   # loader threads
    # synthetic-dataset scale (TPU-framework-only dataset).  0 keeps the
    # legacy 64-train/64-valid split; N > 0 gives N train sequences and
    # max(N//4, 8) validation sequences (flagship-scale runs).
    synthetic_sequences: int = 0
    synthetic_seq_len: int = 40
    n_points: int = 4096   # fixed per-frame point count shipped to device
    platform: str = ""     # force a JAX platform ("cpu") before backend init
    # ----- multi-host runtime (SURVEY §5: per-host loading over DCN) -----
    coordinator_address: str = ""  # "host:port" enables jax.distributed
    num_processes: int = 0         # total processes (0 => single-process)
    process_id: int = -1           # this process's rank
    apply_adjust_config: int = 1  # 0 => keep CLI values verbatim (tests)

    # ----------------------------------------------------------------- utils
    def replace(self, **kw) -> "MarionetteConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, path: str) -> "MarionetteConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(**{k: v for k, v in raw.items() if k in _FIELD_NAMES})


_FIELD_NAMES = {f.name for f in dataclasses.fields(MarionetteConfig)}


def adjust_config(cfg: MarionetteConfig) -> MarionetteConfig:
    """Per-dataset overrides, mirroring reference `dataset/config.py:1-151`."""
    kw: dict[str, Any] = {"grid_size": 64}
    ds = cfg.dataset
    if ds == "dfaust":
        kw.update(input_dim=3, Ttot=10, Tcond=3, sample_rate=5, log_gif_num=4,
                  log_gif_every=50, lrate=4e-4, nkeypoints=24,
                  local_const_weight=0.001, time_const_weight=1.0,
                  graph_traj_weight=1.0,
                  firstdecay=600, seconddecay=1400, nepoch=2000)
        if cfg.pretrained_mode > 0:
            kw.update(Ttot=20, Tcond=5, log_gif_num=6, nepoch=2000,
                      log_gif_every=200, log_save_every=50)
    elif ds == "aist":
        kw.update(is_eval=1, input_dim=3, Ttot=10, Tcond=3, sample_rate=2,
                  log_gif_num=4, log_gif_every=5, lrate=4e-4, nkeypoints=24,
                  local_const_weight=0.001, time_const_weight=1.0,
                  graph_traj_weight=1.0,
                  firstdecay=60, seconddecay=140, nepoch=200)
        if cfg.pretrained_mode > 0:
            kw.update(Ttot=20, Tcond=5, log_gif_num=6, nepoch=200,
                      log_gif_every=20)
    elif ds == "animals":
        kw.update(input_dim=3, Ttot=10, Tcond=3, sample_rate=1, log_gif_num=4,
                  log_gif_every=5, lrate=4e-4, nkeypoints=24,
                  gaussian_sigma=2.0, graph_traj_weight=1e-6,
                  firstdecay=120, seconddecay=170, nepoch=200)
        if cfg.pretrained_mode > 0:
            kw.update(Ttot=20, Tcond=5, log_gif_num=6, nepoch=150,
                      log_gif_every=5)
    elif ds == "panda":
        kw.update(is_eval=1, input_dim=3, Ttot=10, Tcond=3, sample_rate=1,
                  log_gif_num=4, log_gif_every=5, lrate=4e-4, nkeypoints=12,
                  local_const_weight=1.0, time_const_weight=1.0,
                  graph_traj_weight=0.001,
                  firstdecay=60, seconddecay=140, nepoch=200)
        if cfg.pretrained_mode > 0:
            kw.update(Ttot=20, Tcond=5, log_gif_num=6, log_gif_every=20)
    elif ds == "hanco":
        kw.update(is_eval=1, input_dim=3, Ttot=10, Tcond=3, sample_rate=1,
                  log_gif_num=4, log_gif_every=5, lrate=4e-4, nkeypoints=28,
                  gaussian_sigma=1.0, graph_traj_weight=1e-6,
                  local_const_weight=1.0, vol_reg_weight=0.1,
                  firstdecay=120, seconddecay=170, nepoch=200)
        if cfg.pretrained_mode > 0:
            kw.update(Ttot=20, Tcond=5, log_gif_num=6, nepoch=200,
                      log_gif_every=20)
    elif ds in ("hands", "humanoids", "synthetic"):
        # hands/humanoids exist as datasets in the reference but have no
        # adjust_config entry there (reference would raise); synthetic is
        # TPU-framework-only.  Give them sane aist-like settings.
        kw.update(input_dim=3, Ttot=10, Tcond=3, sample_rate=1, log_gif_num=4,
                  log_gif_every=5, lrate=4e-4,
                  firstdecay=60, seconddecay=140, nepoch=200)
        if ds == "synthetic":
            kw.update(nkeypoints=8, is_eval=1)
        if cfg.pretrained_mode > 0:
            kw.update(Ttot=20, Tcond=5)
    else:
        raise ValueError(f"Wrong Dataset Assignment: {ds!r}")

    if cfg.pretrained_mode > 0:
        kw.update(firstdecay=int(1e10), seconddecay=int(1e10))
    return cfg.replace(**kw)


# option -> the one value the port implements (the AIST preset's)
SUPPORTED = {
    "const_intensity": 3,
    "affinity_ver": 3,
    "graph_loss_ver": 1,
    "vol_fit_type": "chamfer",
    "gaussian_cat_type": "none",
    "fixed_sigma": 1,
    "keypoints_graph": "affinity_params",
}


def check_supported(cfg: MarionetteConfig) -> None:
    """Raise ``NotImplementedError`` naming the first option whose value the
    port does not implement."""
    for name, value in SUPPORTED.items():
        got = getattr(cfg, name)
        if got != value:
            raise NotImplementedError(
                f"{name}={got!r} is not ported to neural_marionette_tpu_torch "
                f"(only {value!r})")
