"""The port's CLI:

    python -m next3d_tpu_torch.cli.main {gen-samples,gen-videos,reenact,train,
                                         calc-metrics,dataset-tool,
                                         preprocess} ...

The options and their defaults are those of the JAX package's commands
(next3d_tpu/cli/gen_samples.py, gen_videos.py, reenact.py, train.py,
calc_metrics.py, dataset_tool.py, preprocess_cli.py), plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain versions of the kernels)
for the commands that run a model. ``dataset-tool`` and ``preprocess
{align,crop,mirror,cameras}`` touch no tensor and take no ``--device``. The
mesh options default to the reference's demo FLAME files; a mesh file that
does not exist stops the command with a ``FileNotFoundError`` that names
its option.
"""

from __future__ import annotations

import argparse
import os
import sys

from .common import DEMO_LMS, DEMO_OBJ, parse_range


def _bool(s):
    """A boolean option value as click reads one."""
    value = str(s).strip().lower()
    if value in ('1', 'true', 't', 'yes', 'y', 'on'):
        return True
    if value in ('0', 'false', 'f', 'no', 'n', 'off'):
        return False
    raise argparse.ArgumentTypeError(f'{s!r} is not a valid boolean')


def _common(p, seeds):
    p.add_argument('--network', dest='network_path', required=True)
    p.add_argument('--seeds', type=parse_range, default=parse_range(seeds))
    p.add_argument('--trunc', dest='truncation_psi', type=float, default=0.7)
    p.add_argument('--trunc-cutoff', dest='truncation_cutoff', type=int,
                   default=14)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m next3d_tpu_torch.cli.main',
        description='Next3D on PyTorch: 3D-aware generative head '
                    'avatars.')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('gen-samples', help='images (and shapes) per seed')
    _common(p, '0-3')
    p.add_argument('--outdir', type=str, required=True)
    p.add_argument('--shapes', type=_bool, default=False)
    p.add_argument('--shape-res', type=int, default=512)
    p.add_argument('--fov-deg', type=float, default=18.837)
    p.add_argument('--obj-path', type=str, default=DEMO_OBJ)
    p.add_argument('--lms-path', type=str, default=DEMO_LMS)
    p.add_argument('--shape-format', choices=['.mrc', '.ply'],
                   default='.mrc')
    p.add_argument('--batch', dest='max_batch', type=int, default=1000000)

    p = sub.add_parser('gen-videos', help='a latent-interpolation video')
    _common(p, '0-3')
    p.add_argument('--grid', type=str, default='2x2')
    p.add_argument('--outdir', type=str, required=True)
    p.add_argument('--w-frames', type=int, default=120)
    p.add_argument('--fps', type=int, default=60)
    p.add_argument('--obj-path', type=str, default=DEMO_OBJ)
    p.add_argument('--lms-path', type=str, default=DEMO_LMS)

    p = sub.add_parser('reenact', help='a FLAME-driven reenactment video')
    p.add_argument('--network', dest='network_path', required=True)
    p.add_argument('--drive-root', type=str, required=True,
                   help='driving dir: dataset.json + per-frame .obj + '
                        '_kpt2d.txt')
    p.add_argument('--seeds', type=parse_range, default=parse_range('166'))
    p.add_argument('--trunc', dest='truncation_psi', type=float, default=0.7)
    p.add_argument('--trunc-cutoff', dest='truncation_cutoff', type=int,
                   default=14)
    p.add_argument('--outdir', type=str, required=True)
    p.add_argument('--fps', type=int, default=30)
    p.add_argument('--topology-path', type=str, default=DEMO_OBJ)

    from .train import add_options
    add_options(sub.add_parser('train', help='GAN training on one device'),
                _bool)
    from . import calc_metrics
    calc_metrics.add_options(sub.add_parser(
        'calc-metrics', help='quality metrics of a checkpoint'))

    for p in sub.choices.values():
        p.add_argument('--device', type=str, default='cuda',
                       help='torch device (default cuda; cpu runs the '
                            'kernels\' plain versions)')

    p = sub.add_parser('dataset-tool', help='pack a dataset folder or zip')
    p.add_argument('--source', required=True,
                   help='folder/zip with images+meshes+lms, cifar10 tar.gz, '
                        'or mnist idx file')
    p.add_argument('--dest', required=True, help='output folder or .zip')
    p.add_argument('--resolution', type=int, default=None)
    p.add_argument('--transform', choices=['center-crop', 'center-crop-wide'],
                   default=None)
    p.add_argument('--max-images', type=int, default=None)

    from . import preprocess_cli
    preprocess_cli.add_options(sub.add_parser(
        'preprocess', help='image-only dataset preparation (align / crop / '
                           'mirror / cameras)').add_subparsers(
        dest='stage', required=True))
    return parser


def _require(opts, *names):
    for name in names:
        path = getattr(opts, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f'--{name.replace("_", "-")}: no file at {path}')


def run(argv=None):
    """Run one command; returns its timings (see each command's function)."""
    opts = build_parser().parse_args(argv)
    kw = {k: v for k, v in vars(opts).items() if k not in ('command',
                                                          'stage')}
    if opts.command == 'dataset-tool':
        from .dataset_tool import convert_dataset
        return convert_dataset(**kw)
    if opts.command == 'preprocess':
        from .preprocess_cli import COMMANDS
        return COMMANDS[opts.stage](**kw)
    if opts.command == 'gen-samples':
        from .gen_samples import generate_images
        _require(opts, 'obj_path', 'lms_path')
        return generate_images(**kw)
    if opts.command == 'gen-videos':
        from .gen_videos import generate_video
        _require(opts, 'obj_path', 'lms_path')
        return generate_video(**kw)
    _require(opts, 'topology_path')
    if opts.command == 'calc-metrics':
        from .calc_metrics import calc_metrics
        return calc_metrics(**kw)
    if opts.command == 'train':
        from .train import train
        return train(**kw)
    from .reenact import reenact
    return reenact(**kw)


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
