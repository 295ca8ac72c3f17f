"""Camera-label canonicalization for dataset preparation.

A copy of next3d_tpu/data/preprocess.py (numpy only), so that the port
imports nothing of the JAX package; tests/test_torch_data_tools.py holds it
to the original. Behavioral spec: dataset_preprocessing/ffhq/preprocess_face_cameras.py —
the piece of the offline pipeline the TRAINING framework needs (the full
FLAME/gaze fitting stack — Deep3DFaceRecon, DECA, FaceVerse — stays an
external GPU pipeline, per SURVEY 7.2; this module canonicalizes its pose
outputs into the 25-dim labels the dataset consumes).
"""

from __future__ import annotations

import json
import os

import numpy as np

FFHQ_FOCAL = 2985.29 / 700  # reference fix_intrinsics


def fix_intrinsics(intrinsics):
    """Normalize intrinsics to the FFHQ convention (reference fix_intrinsics)."""
    intrinsics = np.array(intrinsics, np.float64).copy()
    assert intrinsics.shape == (3, 3)
    intrinsics[0, 0] = FFHQ_FOCAL
    intrinsics[1, 1] = FFHQ_FOCAL
    intrinsics[0, 2] = 0.5
    intrinsics[1, 2] = 0.5
    return intrinsics


def fix_pose_orig(pose):
    """Normalize camera distance to radius 2.7 (reference fix_pose_orig)."""
    pose = np.array(pose, np.float64).copy()
    radius = np.linalg.norm(pose[:3, 3])
    pose[:3, 3] = pose[:3, 3] / radius * 2.7
    return pose


def fix_pose_cor(pose, center=(0, 0, 0.175)):
    """Normalize distance to 2.7 around a center-of-rotation
    (reference fix_pose)."""
    pose = np.array(pose, np.float64).copy()
    cor = np.asarray(center, np.float64)
    location = pose[:3, 3]
    direction = (location - cor) / np.linalg.norm(location - cor)
    pose[:3, 3] = direction * 2.7 + cor
    return pose


def flip_yaw(pose):
    """Mirror a cam2world pose for x-flipped images (reference flip_yaw)."""
    flipped = np.array(pose, np.float64).copy()
    flipped[0, 1] *= -1
    flipped[0, 2] *= -1
    flipped[1, 0] *= -1
    flipped[2, 0] *= -1
    flipped[0, 3] *= -1
    return flipped


def camera_label(pose, intrinsics, expression=None):
    """25-dim label (16 cam2world + 9 intrinsics), optionally + 50-dim
    expression coefficients (the DualLabel path)."""
    label = np.concatenate([np.asarray(pose, np.float32).reshape(16),
                            np.asarray(intrinsics, np.float32).reshape(9)])
    if expression is not None:
        label = np.concatenate([label,
                                np.asarray(expression, np.float32).reshape(-1)])
    return label


def canonicalize_cameras_json(source, dest=None, mode='orig'):
    """cameras.json {name: {pose (16), intrinsics (9)}} -> dataset.json
    labels (reference preprocess_face_cameras.py __main__)."""
    with open(os.path.join(source, 'cameras.json')) as f:
        cameras = json.load(f)
    fix = fix_pose_orig if mode == 'orig' else fix_pose_cor
    labels = []
    for name, entry in sorted(cameras.items()):
        pose = fix(np.asarray(entry['pose'], np.float64).reshape(4, 4))
        K = fix_intrinsics(np.asarray(entry['intrinsics'],
                                      np.float64).reshape(3, 3))
        labels.append([name, camera_label(pose, K).tolist()])
    out = {'labels': labels}
    if dest:
        with open(os.path.join(dest, 'dataset.json'), 'w') as f:
            json.dump(out, f)
    return out
