"""The port's copy of the video-clip dataset (next3d_tpu_torch/data/
video_dataset.py) against the JAX package's (next3d_tpu/data/
video_dataset.py): ``sample_frames`` for the same RandomState, and the
items, the conditioning draws and the batches of a clip dataset written
from the synthetic head, all equal."""

import numpy as np
import pytest

from next3d_tpu.data import dataset as jax_dataset
from next3d_tpu.data import video_dataset as jax_video
from next3d_tpu_torch.data import dataset
from next3d_tpu_torch.data import video_dataset

from test_torch_train_cli import toy_clips


@pytest.mark.parametrize('sampling', ['random', 'uniform', 'consecutive'])
def test_sample_frames_matches_jax(sampling):
    for num_available in (1, 2, 5, 40):
        for num_frames in (1, 2, 3, 8):
            for dist in (1, 4, 30):
                a = np.random.RandomState(num_available * 100 + num_frames)
                b = np.random.RandomState(num_available * 100 + num_frames)
                for _ in range(3):
                    np.testing.assert_array_equal(
                        video_dataset.sample_frames(num_available, num_frames,
                                                    sampling, dist, rng=a),
                        jax_video.sample_frames(num_available, num_frames,
                                                sampling, dist, rng=b))


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    return toy_clips(str(tmp_path_factory.mktemp('clips') / 'data'), n=3,
                     frames=4, size=32)


def _pair(root, **kw):
    return (video_dataset.VideoFramesFolderDataset(root, **kw),
            jax_video.VideoFramesFolderDataset(root, **kw))


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_items_match_jax(clips):
    """Three clips of 4 frames at 32^2: clips of 2 frames by each sampling,
    their images (T, 3, 32, 32) uint8, labels (T, 25) and verts with
    landmarks (T, 5091, 3); the dataset's size, resolution, label width and
    label std."""
    for sampling in ('random', 'uniform', 'consecutive'):
        port, jax = _pair(clips, num_frames=2, sampling=sampling,
                          max_frame_dist=3, max_num_frames=4)
        assert (len(port), port.resolution, port.label_dim) == \
            (len(jax), jax.resolution, jax.label_dim) == (3, 32, 25)
        np.testing.assert_array_equal(port.get_label_std(),
                                      jax.get_label_std())
        for idx in (0, 2, 1, 0):
            got, want = port[idx], jax[idx]
            assert got[0].shape == (2, 3, 32, 32) and got[1].shape == (2, 25)
            assert got[2].shape == (2, 5091, 3)
            _assert_equal(got, want)
    port, jax = _pair(clips, num_frames=1)
    assert port.resolution == 32
    _assert_equal(port[1], jax[1])


def test_conditioning_and_batches_match_jax(clips):
    """sample_conditioning for the same RandomState ((n, T, 25) and (n, T,
    5091, 3)), and the batch iterator's first batches (image (B, T, 3, H,
    W) in [-1, 1], c, v) over each package's own dataset."""
    port, jax = _pair(clips, num_frames=2)
    _assert_equal(port.sample_conditioning(np.random.RandomState(4), 5),
                  jax.sample_conditioning(np.random.RandomState(4), 5))
    port, jax = _pair(clips, num_frames=2)
    a = dataset.make_data_iterator(port, 2, seed=3, prefetch=0)
    b = jax_dataset.make_data_iterator(jax, 2, seed=3, prefetch=0)
    for _ in range(3):
        got, want = next(a), next(b)
        assert got['image'].shape == (2, 2, 3, 32, 32)
        assert sorted(got) == sorted(want)
        _assert_equal([got[k] for k in sorted(got)],
                      [want[k] for k in sorted(want)])
