"""The port's copy of the training dataset and its PNG reader, against the
JAX package's ImageFolderDataset, sampler and batch iterator and against
PIL, on toy datasets of the synthetic head (CPU)."""

import io
import os
import struct
import zipfile
import zlib

import numpy as np
import pytest
from PIL import Image

from next3d_tpu.data import dataset as jax_dataset
from next3d_tpu_torch.data import dataset
from next3d_tpu_torch.utils.png import read_png, write_png

from test_torch_train_cli import toy_dataset


def _png(img, filters):
    """A PNG of uint8 ``img`` (H, W, C) whose row y takes scanline filter
    ``filters[y % len(filters)]`` (PNG spec 9.2)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        kind = filters[y % len(filters)]
        x, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 3:
            pred = (left + up) // 2
        elif kind == 4:
            pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0 * x, left, up][kind]
        out.append(bytes([kind]) + ((x - pred) % 256).astype(np.uint8)
                   .tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(out)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_png_reader_every_filter(channels):
    """Rows of each of the 5 filter types, in 8-bit gray, gray + alpha, RGB
    and RGBA: the reader returns the pixels, and PIL agrees."""
    img = np.random.RandomState(channels).randint(
        0, 256, (23, 17, channels)).astype(np.uint8)
    data = _png(img, [0, 1, 2, 3, 4, 4, 3])
    got = read_png(io.BytesIO(data))
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  want)


@pytest.mark.parametrize('mode', ['L', 'LA', 'RGB', 'RGBA'])
def test_png_reader_matches_pil(mode, tmp_path):
    """Files PIL writes (its own choice of filters), and the port's own
    writer's files."""
    rs = np.random.RandomState(0)
    c = len(mode)
    yy, xx = np.mgrid[:40, :57]
    smooth = (128 + 60 * np.sin(xx / 5) * np.cos(yy / 7)).astype(np.uint8)
    img = np.repeat(smooth[..., None], c, 2)
    img[20:] = rs.randint(0, 256, img[20:].shape)
    img = img[..., 0] if c == 1 else img
    path = tmp_path / 'a.png'
    Image.fromarray(img, mode).save(path)
    np.testing.assert_array_equal(read_png(path),
                                  np.asarray(Image.open(path)))
    if mode in ('L', 'RGB'):
        write_png(path, img)
        np.testing.assert_array_equal(read_png(str(path)), img)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    data = bytearray(_png(img, [0]))
    data[28] = 1                  # the interlace byte of IHDR
    with pytest.raises(ValueError, match='interlaced'):
        read_png(io.BytesIO(bytes(data)))
    Image.fromarray(np.zeros((4, 5), np.uint16)).save(
        tmp_path / 'deep.png')
    with pytest.raises(ValueError, match='8-bit'):
        read_png(tmp_path / 'deep.png')
    Image.fromarray(np.zeros((4, 5), np.uint8), 'L').convert('P').save(
        tmp_path / 'palette.png')
    with pytest.raises(ValueError, match='color type 3'):
        read_png(tmp_path / 'palette.png')
    with pytest.raises(ValueError, match='not a PNG'):
        read_png(io.BytesIO(b'GIF89a'))


@pytest.fixture(scope='module')
def toy(tmp_path_factory):
    """A directory and a zip of the same 5 items at 64^2."""
    root = tmp_path_factory.mktemp('data')
    path = toy_dataset(str(root / 'toy'), n=5, size=64, seed=1)
    zpath = str(root / 'toyzip.zip')
    with zipfile.ZipFile(zpath, 'w') as z:
        for dirpath, _, names in os.walk(path):
            for name in names:
                full = os.path.join(dirpath, name)
                z.write(full, os.path.relpath(full, path))
    return path, zpath


@pytest.mark.parametrize('kind', ['dir', 'zip'])
@pytest.mark.parametrize('xflip', [False, True])
def test_dataset_matches_jax(toy, kind, xflip):
    """The same images, labels, verts and landmarks for every index, the
    same conditioning draws and the same batches in the same order."""
    path = toy[0] if kind == 'dir' else toy[1]
    got = dataset.ImageFolderDataset(path, resolution=64, xflip=xflip)
    want = jax_dataset.ImageFolderDataset(path, resolution=64, xflip=xflip)
    assert len(got) == len(want) == 5 * (1 + xflip)
    assert got.label_dim == want.label_dim == 25
    assert got.resolution == want.resolution == 64
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    np.testing.assert_array_equal(got.get_label_std(), want.get_label_std())
    for a, b in zip(got.sample_conditioning(np.random.RandomState(3), 7),
                    want.sample_conditioning(np.random.RandomState(3), 7)):
        np.testing.assert_array_equal(a, b)
    it_got = dataset.make_data_iterator(got, 3, seed=2, prefetch=2)
    it_want = jax_dataset.make_data_iterator(want, 3, seed=2, prefetch=0)
    for _ in range(4):
        a, b = next(it_got), next(it_want)
        for k in ('image', 'c', 'v'):
            np.testing.assert_array_equal(a[k], b[k])
    it_got.close()


def test_sampler_and_resumed_stream_match_jax():
    """The shuffled infinite index stream, strided by rank, and the batch
    stream started at an offset continues the full one."""
    for rank, replicas in ((0, 1), (1, 3)):
        a = iter(dataset.InfiniteSampler(11, rank, replicas, seed=4))
        b = iter(jax_dataset.InfiniteSampler(11, rank, replicas, seed=4))
        assert [next(a) for _ in range(40)] == [next(b) for _ in range(40)]

    class Items:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            return (np.full((1, 2, 2), i, np.uint8), np.float32([i]),
                    np.zeros((1, 3), np.float32))

    full = dataset.make_data_iterator(Items(), 2, seed=5, prefetch=0)
    batches = [next(full)['c'][:, 0].tolist() for _ in range(6)]
    later = dataset.make_data_iterator(Items(), 2, seed=5, prefetch=0,
                                       start=6)
    assert [next(later)['c'][:, 0].tolist() for _ in range(3)] == batches[3:]


def test_jpeg_datasets_are_refused(tmp_path):
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / 'a.jpg')
    with pytest.raises(ValueError, match='PNG'):
        dataset.ImageFolderDataset(str(tmp_path))
