"""Dataset classes and their registry.

Counterpart of ``neural_marionette_tpu/data/datasets.py`` (reference
``dataset/dataset.py:14-589``): the seven families dfaust, aist, animals,
humanoids, panda, hands (InterHand) and hanco on the reference's on-disk
layouts under ``cfg.data_root``, and the procedural ``synthetic`` one. An
item is a normalized point window ``(T, N, 3)`` float32 with a fixed N
(voxelized on the device by the step), plus the GT joints ``(T, K', 3)``
when ``cfg.is_eval``; ``output="voxels"`` voxelizes on the host through
the port's native library instead.

``dataset[i]`` equals the JAX package's item to the bit, draw for draw:
each dataset keeps the JAX package's two generators (``random.Random``
for window starts, ``np.random.Generator`` for point subsets), seeded from
``cfg.seed``. An item is made in two halves: :meth:`PointSequenceDataset.
draw` takes the random choices from the sequence's length and point count
(a ``.npy`` header), :meth:`PointSequenceDataset.load` reads and
transforms. ``dataset[i]`` is ``load(i, draw(i))``; the loader draws in
index order on its calling thread and loads in its threads.

Sequences are read with ``np.load(..., mmap_mode="r")``: only the frames
of the window are read from disk, where the JAX package reads the whole
sequence per item. The window's values are the same.
"""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from ..config import MarionetteConfig
from .pipeline import crop_window, point_indices, select_points, window_start


class PointSequenceDataset:
    """Base: a list of .npy point-cloud sequences -> normalized windows,
    with ``__len__``, ``__getitem__`` and ``log_epoch`` for the
    deterministic crop schedule (reference dataset.py:40-45)."""

    #: per-dataset normalization scale (InterHand uses 0.7, dataset.py:428)
    scale: float = 1.0

    def __init__(self, train: bool = True,
                 options: Optional[MarionetteConfig] = None,
                 n_points: Optional[int] = None, output: str = "points"):
        cfg = options or MarionetteConfig()
        if n_points is None:
            n_points = cfg.n_points
        if output not in ("points", "voxels"):
            raise ValueError(f"output must be 'points' or 'voxels', got "
                             f"{output!r}")
        self.output = output
        self.cfg = cfg
        self.train = train
        self.split = "train" if train else "test"
        self.T = cfg.Ttot
        self.sample_rate = cfg.sample_rate
        self.grid_size = cfg.grid_size
        self.random_crop = bool(cfg.random_crop)
        self.is_eval = bool(cfg.is_eval)
        self.n_points = n_points
        self.epoch_id = 0
        self._rng = random.Random(cfg.seed)
        self._np_rng = np.random.default_rng(cfg.seed)

        self.seq_path = self._list_sequences()
        shuf = random.Random(cfg.seed)
        shuf.shuffle(self.seq_path)
        if cfg.debug == 1:
            self.seq_path = self.seq_path[:cfg.nbatch]

    # -------- per-dataset hooks
    def _list_sequences(self) -> list[str]:
        raise NotImplementedError

    def _points_path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _load_points(self, rel: str) -> np.ndarray:
        """The whole sequence (T_seq, N, C), as a memory map."""
        return np.load(self._points_path(rel), mmap_mode="r")

    def _points_shape(self, rel: str) -> tuple:
        return self._load_points(rel).shape

    def _load_joints(self, rel: str) -> Optional[np.ndarray]:
        return None

    def _load_align(self, rel: str) -> Optional[np.ndarray]:
        """Per-source-frame (T_seq, 3, 3) root-alignment rotations, or
        None (AIST ``align_root`` only)."""
        return None

    def gt_affinity(self) -> Optional[np.ndarray]:
        """(K', K') symmetric GT skeleton adjacency when the dataset ships
        one (AIST++ writes gt_affinity.npy during preparation), else None.
        Read by ``eval.affinity_recovery`` at the end of training."""
        return None

    # -------- common machinery
    def log_epoch(self, epoch_id: int) -> None:
        self.epoch_id = epoch_id

    def __len__(self) -> int:
        return len(self.seq_path)

    def draw(self, index: int) -> tuple[int, Optional[np.ndarray]]:
        """The random choices of item ``index`` for the current epoch, in
        the JAX package's order: the window start, then the point subset
        (None: all points). Reads only the sequence's shape."""
        seq_len, N = self._points_shape(self.seq_path[index])[:2]
        start = window_start(seq_len, self.T, self.sample_rate,
                             self.random_crop, self.epoch_id, self._rng)
        return start, point_indices(N, self.n_points, self._np_rng)

    def load(self, index: int, plan: tuple[int, Optional[np.ndarray]]):
        """Item ``index`` made with the choices ``plan`` of :meth:`draw`;
        uses no generator, so it may run on any thread."""
        start, idx = plan
        rel = self.seq_path[index]
        x = self._load_points(rel)[..., :3]
        joints = self._load_joints(rel) if self.is_eval else None
        out = crop_window(x, start, self.T, self.sample_rate, joints=joints,
                          scale=self.scale, align_rots=self._load_align(rel))
        pts, joints = out if joints is not None else (out, None)
        pts = select_points(pts.astype(np.float32), idx)
        if self.output == "voxels":
            from .native import voxelize_batch
            pts = voxelize_batch(pts, self.grid_size)
        if joints is not None:
            return pts, joints.astype(np.float32)
        return pts

    def __getitem__(self, index: int):
        return self.load(index, self.draw(index))


class _TwoLevelListing:
    """subject-dir / sequence-file listing (dfaust, animals, humanoids)."""

    def _list_sequences(self):
        out = []
        for sid in sorted(os.listdir(self.root)):
            for seq in sorted(os.listdir(os.path.join(self.root, sid))):
                out.append(os.path.join(sid, seq))
        return out


class DFAUST(_TwoLevelListing, PointSequenceDataset):
    """data/D-FAUST/surface/<split>/<sid>/<seq>.npy (dataset.py:14-91)."""

    def __init__(self, train=True, options=None, **kw):
        cfg = options or MarionetteConfig()
        self.root = os.path.join(cfg.data_root, "D-FAUST", "surface",
                                 "train" if train else "test")
        super().__init__(train, options, **kw)


class AIST(PointSequenceDataset):
    """data/aist_plusplus_smpl_joints/{surface,joints}/<split>/<seq>.npy
    with GT joints when is_eval (dataset.py:94-186).

    ``align_root=True`` cancels the global dance orientation with the stored
    yaw root-alignment matrices (``pipeline.window_from_sequence``)."""

    def __init__(self, train=True, options=None, align_root=False, **kw):
        cfg = options or MarionetteConfig()
        base = os.path.join(cfg.data_root, "aist_plusplus_smpl_joints")
        split = "train" if train else "test"
        self.base = base
        self.root = os.path.join(base, "surface", split)
        self.joint_root = os.path.join(base, "joints", split)
        self.align_root_dir = os.path.join(base, "root_aligns", split)
        self.align_root = align_root
        super().__init__(train, options, **kw)

    def gt_affinity(self):
        path = os.path.join(self.base, "gt_affinity.npy")
        return np.load(path) if os.path.exists(path) else None

    def _list_sequences(self):
        return sorted(os.listdir(self.root))

    def _load_align(self, rel):
        if not self.align_root:
            return None
        return np.load(os.path.join(self.align_root_dir, rel))  # (T, 3, 3)

    def _load_joints(self, rel):
        return np.load(os.path.join(self.joint_root, rel))


class DeformingThings4DAnimals(_TwoLevelListing, PointSequenceDataset):
    """data/DeformingThings4D/animals (dataset.py:188-261)."""

    def __init__(self, train=True, options=None, **kw):
        cfg = options or MarionetteConfig()
        self.root = os.path.join(cfg.data_root, "DeformingThings4D",
                                 "animals", "train" if train else "test")
        super().__init__(train, options, **kw)


class DeformingThings4DHumanoids(DeformingThings4DAnimals):
    """data/DeformingThings4D/humanoids (dataset.py:263-335)."""

    def __init__(self, train=True, options=None, **kw):
        cfg = options or MarionetteConfig()
        self.root = os.path.join(cfg.data_root, "DeformingThings4D",
                                 "humanoids", "train" if train else "test")
        PointSequenceDataset.__init__(self, train, options, **kw)


class Panda(PointSequenceDataset):
    """data/panda_gripper/<split>/{vertices,centroids}; eval joints are link
    centroids, filename remapped *_centroids.npy (dataset.py:337-414)."""

    def __init__(self, train=True, options=None, **kw):
        cfg = options or MarionetteConfig()
        split = "train" if train else "test"
        self.root = os.path.join(cfg.data_root, "panda_gripper", split,
                                 "vertices")
        self.joint_root = os.path.join(cfg.data_root, "panda_gripper", split,
                                       "centroids")
        super().__init__(train, options, **kw)

    def _list_sequences(self):
        return sorted(os.listdir(self.root))

    def _load_joints(self, rel):
        parts = rel.split("_")
        name = parts[0] + "_" + parts[1] + "_centroids.npy"
        return np.load(os.path.join(self.joint_root, name))


class InterHand(PointSequenceDataset):
    """data/InterHand2.6Mnpy/<episode>/<hand_type>/<file>, scale 0.7
    (dataset.py:416-477)."""
    scale = 0.7

    def __init__(self, train=True, options=None, **kw):
        cfg = options or MarionetteConfig()
        self.root = os.path.join(cfg.data_root, "InterHand2.6Mnpy",
                                 "train" if train else "test")
        super().__init__(train, options, **kw)

    def _list_sequences(self):
        out = []
        for episode in sorted(os.listdir(self.root)):
            for hand in sorted(os.listdir(os.path.join(self.root, episode))):
                for f in sorted(os.listdir(
                        os.path.join(self.root, episode, hand))):
                    out.append(os.path.join(episode, hand, f))
        return out


class HanCo(PointSequenceDataset):
    """data/HanCo/<split>/{vertices,joints}; joints file <seq>_joints.npy
    (dataset.py:479-563)."""

    def __init__(self, train=True, options=None, **kw):
        cfg = options or MarionetteConfig()
        split = "train" if train else "test"
        self.root = os.path.join(cfg.data_root, "HanCo", split, "vertices")
        self.joint_root = os.path.join(cfg.data_root, "HanCo", split,
                                       "joints")
        super().__init__(train, options, **kw)

    def _list_sequences(self):
        return sorted(os.listdir(self.root))

    def _load_joints(self, rel):
        name = rel.split("_")[0] + "_joints.npy"
        return np.load(os.path.join(self.joint_root, name))


class Synthetic(PointSequenceDataset):
    """Procedural articulated-chain clips (no files).

    K bones under smooth random joint rotations; points sampled along bone
    segments with Gaussian thickness. GT joints = bone endpoints, so the
    semantic eval metric works out of the box."""

    def __init__(self, train=True, options=None, n_sequences=None,
                 seq_len=None, n_bones=None, **kw):
        cfg = options or MarionetteConfig()
        if n_sequences is None:
            # cfg.synthetic_sequences=0 keeps the legacy 64/64 split
            if cfg.synthetic_sequences > 0:
                n_sequences = (cfg.synthetic_sequences if train
                               else max(cfg.synthetic_sequences // 4, 8))
            else:
                n_sequences = 64
        self.n_sequences = n_sequences
        self.seq_len = seq_len if seq_len is not None \
            else (cfg.synthetic_seq_len or 40)
        self.n_bones = n_bones or max(cfg.nkeypoints, 3)
        # (pts, joints) per seed: generation is deterministic in the seed, so
        # a plain memo is exact (a lost race between two threads only
        # generates twice)
        self._memo: dict = {}
        super().__init__(train, options, **kw)

    def _list_sequences(self):
        offset = 0 if self.train else 10_000
        return [f"synthetic_{i + offset}" for i in range(self.n_sequences)]

    def _generate(self, seed: int):
        g = np.random.default_rng(seed)
        T, K = self.seq_len, self.n_bones
        lengths = g.uniform(0.15, 0.35, size=K)
        # smooth random angular velocities per joint (yaw/pitch)
        base = g.uniform(-np.pi, np.pi, size=(2, K))
        vel = g.uniform(-0.15, 0.15, size=(2, K))
        t = np.arange(T)[:, None]
        yaw = base[0] + vel[0] * t + 0.3 * np.sin(0.13 * t + base[1])
        pitch = 0.5 * np.sin(0.21 * t + base[0]) + vel[1] * t
        dirs = np.stack([np.cos(yaw) * np.cos(pitch),
                         np.sin(pitch),
                         np.sin(yaw) * np.cos(pitch)], axis=-1)  # (T, K, 3)
        joints = np.zeros((T, K + 1, 3))
        for k in range(K):
            joints[:, k + 1] = joints[:, k] + dirs[:, k] * lengths[k]
        # sample points along bones with thickness
        n_per = 2048 // K + 1
        u = g.uniform(0, 1, size=(T, K, n_per, 1))
        noise = g.normal(0, 0.02, size=(T, K, n_per, 3))
        seg = (joints[:, :-1, None] * (1 - u)
               + joints[:, 1:, None] * u + noise)
        pts = seg.reshape(T, -1, 3)
        return pts.astype(np.float32), joints[:, 1:].astype(np.float32)

    def gt_affinity(self):
        # the procedural skeleton is a K-bone chain: joint k-1 -- k
        K = self.n_bones
        aff = np.zeros((K, K), np.float32)
        idx = np.arange(K - 1)
        aff[idx, idx + 1] = aff[idx + 1, idx] = 1.0
        return aff

    def _generate_memo(self, seed: int):
        hit = self._memo.get(seed)
        if hit is None:
            hit = self._memo[seed] = self._generate(seed)
        return hit

    def _load_points(self, rel):
        seed = int(rel.split("_")[1])
        return self._generate_memo(seed)[0]

    def _load_joints(self, rel):
        seed = int(rel.split("_")[1])
        return self._generate_memo(seed)[1]


DATASETS = {
    "dfaust": DFAUST,
    "aist": AIST,
    "animals": DeformingThings4DAnimals,
    "humanoids": DeformingThings4DHumanoids,
    "panda": Panda,
    "hands": InterHand,
    "hanco": HanCo,
    "synthetic": Synthetic,
}


def load_dataset(training: bool, options: MarionetteConfig, **kw):
    """Registry factory (reference DATASET_LIST.load, dataset.py:565-589)."""
    if options.dataset not in DATASETS:
        raise ValueError(
            f"unknown dataset {options.dataset!r}; "
            f"choose from {sorted(DATASETS)}")
    return DATASETS[options.dataset](training, options, **kw)
