"""Configuration of the port: a copy of the JAX package's ``config.py``.

:class:`MarionetteConfig` keeps the JAX package's fields and defaults (the
reference CLI flag names), :func:`adjust_config` its per-dataset
overrides, :func:`derive_training_id` the fields of the detector and
the dynamics runs and :func:`load_reference_pickle` the reference's
``opt.pickle``, so one configuration drives both packages. The port
runs every value of the detector options that the JAX package runs;
:func:`check_supported` rejects only the values the JAX package rejects
too.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
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
    # remat: rematerialize the detector's conv stacks where a gradient is
    # taken, trading recompute in the backward for activation memory, as
    # the JAX package's nn.remat (models/detector.py). 0 = off; 1 = each
    # feature net and the voxel decoder is one region, whose activations
    # are recomputed in the backward; 2 = also each block of a feature net
    # and each conv stage of the decoder, nested inside those, which bounds
    # the decoder's backward to one stage's activations. The results are
    # remat 0's; eval, serving and no_grad runs ignore it.
    remat: int = 0
    # The fields below up to frame_chunk are the JAX package's TPU layout
    # options. The port reads each one (the CLI takes the flag, a
    # checkpoint's opt.json keeps it) and ignores it: it has no strip,
    # upconv or frame-chunk rewrite of its convs, whose results those
    # rewrites leave exactly as the plain conv's (ROADMAP.md).
    # strip-packed decoder convs (JAX ops/stripconv.py): -1 = auto,
    # 0 = off, 1 = on.
    strip_decoder: int = -1
    # fused upsample + conv for the decoder's second upsample stage (JAX
    # ops/upconv.py): -1 = auto, 0 = off, 1 = on.
    upconv_decoder: int = -1
    # strip-packed encoder stem and first pool: -1 = auto, 0 = off, 1 = on.
    strip_encoder: int = -1
    # folded-frame count at or below which the JAX strip paths are taken;
    # 0 = the JAX package's default.
    strip_max_frames: int = 0
    # chunking of the folded frame axis through the conv stacks: -1 =
    # auto, 0 = off, > 0 = chunk size.
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


def derive_training_id(cfg: MarionetteConfig) -> MarionetteConfig:
    """The fields that follow from ``pretrained_mode``, mirroring reference
    ``train.py:141-158``: mode 0 is the detector run, mode 1 the dynamics
    run on a frozen pretrained detector (``detector_end=0``,
    ``learner_start=0``); ``log_gif_num`` is clamped to ``nbatch``."""
    if cfg.pretrained_mode == 0:
        tid = "rl_setup/disc_training/%s/%s/%dkypt" % (
            cfg.dataset, cfg.keypoints_graph, cfg.nkeypoints)
        kw: dict[str, Any] = {"training_id": tid}
    elif cfg.pretrained_mode == 1:
        tid = "rl_setup/dyna_training/%s/%s/%s/%dkypt/%dzkypt_%dhkypt" % (
            cfg.dataset, cfg.transition_type, cfg.dyna_module,
            cfg.nkeypoints, cfg.nlatent_kypt, cfg.nhidden_kypt)
        kw = {"training_id": tid, "detector_end": 0, "learner_start": 0}
    else:
        raise ValueError(
            "pretrained_mode must be 0 (detector) or 1 (dynamics); the "
            "reference's mode 2 (RL) is broken upstream and not implemented")
    if cfg.log_gif_num > cfg.nbatch:
        kw["log_gif_num"] = cfg.nbatch
    return cfg.replace(**kw)


class _NamespaceStub:
    """Unpickle target for argparse.Namespace attribute bags."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_reference_pickle(path: str) -> MarionetteConfig:
    """Read a reference ``opt.pickle`` (an ``argparse.Namespace``) into a
    config: unknown attributes are ignored, missing or None ones keep the
    defaults (reference ``vis_generation.py:47-50``)."""
    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if name == "Namespace":
                return _NamespaceStub
            return super().find_class(module, name)

    with open(path, "rb") as f:
        ns = _Unpickler(f).load()
    raw = dict(ns.__dict__) if not isinstance(ns, dict) else dict(ns)
    kw = {k: v for k, v in raw.items() if k in _FIELD_NAMES and v is not None}
    return MarionetteConfig(**kw)


VOL_FIT_TYPES = ("none", "chamfer", "gaussian")


def check_supported(cfg: MarionetteConfig) -> None:
    """Raise ``ValueError`` naming the first option whose value the JAX
    package rejects as well: an ``affinity_ver`` outside 0-4
    (``get_affinity``), an unknown ``vol_fit_type``
    (``volume_fitting_loss``), a ``pretrained_mode`` other than 0 or 1
    (``derive_training_id``; the reference's mode 2 is not implemented)."""
    if cfg.affinity_ver not in range(5):
        raise ValueError(f"affinity_ver={cfg.affinity_ver!r}: invalid "
                         "affinity version (0-4)")
    if cfg.vol_fit_type not in VOL_FIT_TYPES:
        raise ValueError(f"vol_fit_type={cfg.vol_fit_type!r}: unknown "
                         f"(one of {VOL_FIT_TYPES})")
    if cfg.pretrained_mode not in (0, 1):
        raise ValueError(f"pretrained_mode={cfg.pretrained_mode!r}: must be "
                         "0 (detector) or 1 (dynamics)")
