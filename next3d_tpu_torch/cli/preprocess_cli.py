"""The image-only dataset-preparation stages as commands.

Counterpart of next3d_tpu/cli/preprocess_cli.py: ``preprocess {align,
crop,mirror,cameras}`` in ``cli/main.py``, with the JAX commands' options,
mirrors the image-only steps of the reference FFHQ pipeline
(dataset_preprocessing/ffhq/runme.py:21-77): align -> crop -> mirror, and
the camera-label canonicalization (``data/preprocess.py``); the final
packing is ``dataset-tool``. The 3DMM/FLAME fitting networks remain an
external pipeline. Host-only: numpy and PIL, no tensor.
"""

from __future__ import annotations


def add_options(sub):
    """The four subcommands under the ``preprocess`` parser's ``sub``."""
    p = sub.add_parser('align', help='FFHQ landmark-quad realignment '
                                     '(align_multiprocess.py)')
    p.add_argument('--source', required=True, help='wild-image folder')
    p.add_argument('--dest', required=True, help='aligned output folder')
    p.add_argument('--landmarks', dest='landmarks_json', required=True,
                   help='JSON {filename: [[x, y] * 68]} (FFHQ in-the-wild '
                        'face_landmarks)')
    p.add_argument('--output-size', type=int, default=1500)
    p.add_argument('--transform-size', type=int, default=4096)
    p.add_argument('--no-padding', action='store_true', default=False)
    p.add_argument('--max-images', type=int, default=None)

    p = sub.add_parser('crop', help='final 512^2 POS-aligned crops '
                                    '(crop_images.py)')
    p.add_argument('--indir', dest='source', required=True)
    p.add_argument('--outdir', dest='dest', required=True)
    p.add_argument('--cropping-params', default=None,
                   help='cropping_params.json (default: '
                        '<indir>/cropping_params.json)')
    p.add_argument('--max-images', type=int, default=None)

    p = sub.add_parser('mirror', help='x-flip images (+ yaw-flipped labels '
                                      'when dataset.json is present)')
    p.add_argument('--source', required=True)
    p.add_argument('--dest', default=None,
                   help='defaults to in-place (like the reference)')
    p.add_argument('--max-images', type=int, default=None)

    p = sub.add_parser('cameras', help='canonicalize camera labels '
                                       '(preprocess_face_cameras.py)')
    p.add_argument('--source', required=True, help='folder with '
                                                   'cameras.json')
    p.add_argument('--dest', default=None)
    p.add_argument('--mode', choices=['orig', 'cor'], default='orig')


def align(source, dest, landmarks_json, output_size, transform_size,
          no_padding, max_images):
    """FFHQ landmark-quad realignment; returns the count of images."""
    from ..data.image_prep import align_dataset
    n = align_dataset(source, dest, landmarks_json, output_size=output_size,
                      transform_size=transform_size,
                      enable_padding=not no_padding, max_images=max_images)
    print(f'aligned {n} images -> {dest}')
    return n


def crop(source, dest, cropping_params, max_images):
    """Final POS-aligned crops; returns the count of images."""
    from ..data.image_prep import crop_dataset
    n = crop_dataset(source, dest, cropping_params=cropping_params,
                     max_images=max_images)
    print(f'cropped {n} images -> {dest}')
    return n


def mirror(source, dest, max_images):
    """x-flipped copies and their labels; returns the count of images."""
    from ..data.image_prep import mirror_dataset
    n = mirror_dataset(source, dest, max_images=max_images)
    print(f'mirrored {n} images')
    return n


def cameras(source, dest, mode):
    """Canonical camera labels; returns the dataset.json dict."""
    from ..data.preprocess import canonicalize_cameras_json
    out = canonicalize_cameras_json(source, dest, mode=mode)
    print(f'wrote {out}')
    return out


COMMANDS = {'align': align, 'crop': crop, 'mirror': mirror,
            'cameras': cameras}
