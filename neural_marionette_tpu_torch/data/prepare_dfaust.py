"""D-FAUST offline preprocessor (L0 layer).

Equivalent of reference `dataset/dfaust/write_sequence_to_obj.py:25-116`:
read the registrations hdf5 per (subject, sequence), sample 20k surface
points per frame, write ``<path>/surface/<sid>/<seq>.npy`` (T, 20000, 3+3)
— the [point, face-normal] rows consumed (xyz only) by
``data.datasets.DFAUST`` after the manual train/test placement into
``surface/{train,test}/<sid>/`` (the reference leaves that step manual
too; its loader reads ``data/D-FAUST/surface/<split>``, dataset.py:19).

Self-contained: surface sampling is the numpy implementation in
``data.meshsample`` (the reference's only trimesh usage), so this runs on
any host with numpy + h5py and no mesh toolchain. A copy of the JAX
package's ``data/prepare_dfaust.py``, except that ``h5py`` is imported by
:func:`main` alone, so that importing the package never loads it.

    python -m neural_marionette_tpu_torch.data.prepare_dfaust \\
        --path data/D-FAUST --subjects_file subjects_and_sequences.txt
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .meshsample import sample_surface_with_normals

SUBJECT_IDS = ["50002", "50004", "50007", "50009", "50020",
               "50021", "50022", "50025", "50026", "50027"]


def sample_surface_points(verts: np.ndarray, faces: np.ndarray,
                          n: int = 20000,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
    """(n, 6) float32 [point, face normal] — reference sample_faces
    contract (write_sequence_to_obj.py:20-23)."""
    return sample_surface_with_normals(verts, faces, n, rng)


def parse_subjects_file(path: str) -> dict[str, tuple[str, list[str]]]:
    """subjects_and_sequences.txt -> {sid: (gender, [sequences])}."""
    out: dict[str, tuple[str, list[str]]] = {}
    current = None
    with open(path) as f:
        for line in f.read().splitlines():
            parts = line.split()
            if len(parts) == 2:
                sid, gender = parts
                current = sid
                out[sid] = (gender.strip("()"), [])
            elif len(parts) == 1 and current is not None and parts[0]:
                out[current][1].append(parts[0])
    return out


def main(argv=None):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"prepare_dfaust needs h5py: {e}") from e

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path", default="data/D-FAUST",
                        help="directory with registrations_{m,f}.hdf5")
    parser.add_argument("--subjects_file",
                        default="subjects_and_sequences.txt")
    parser.add_argument("--n_points", type=int, default=20000)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(0)
    subjects = parse_subjects_file(args.subjects_file)
    for sid in SUBJECT_IDS:
        if sid not in subjects:
            continue
        gender, seqs = subjects[sid]
        reg_path = os.path.join(
            args.path, "registrations_m.hdf5" if gender == "male"
            else "registrations_f.hdf5")
        for seq in seqs:
            sidseq = f"{sid}_{seq}"
            with h5py.File(reg_path, "r") as f:
                if sidseq not in f:
                    print(f"sequence {seq} of {sid} not in {reg_path}")
                    continue
                verts = np.array(f[sidseq]).transpose([2, 0, 1])
                faces = np.array(f["faces"])

            save_dir = os.path.join(args.path, "surface", sid)
            os.makedirs(save_dir, exist_ok=True)
            sampled = np.stack([
                sample_surface_points(v, faces, args.n_points, rng)
                for v in verts])
            np.save(os.path.join(save_dir, seq + ".npy"), sampled)
            print(os.path.join(save_dir, seq), "saved")


if __name__ == "__main__":
    main()
