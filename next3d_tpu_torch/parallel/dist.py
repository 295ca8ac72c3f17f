"""Data parallelism over ``torch.distributed``: one process a card.

Counterpart of next3d_tpu/parallel/mesh.py:26-70 (reference:
training_loop.py:241-245, :352-356, torch_utils/misc.py:139, :185-196).
The JAX package runs one program over a 1-D ``'data'`` mesh and XLA
inserts the ``pmean``; here each rank is a process with its own card, the
parameters are the same on every rank, each rank takes its own rows of the
global batch, and each training phase all-reduces its gradients to their
mean in one flat bucket before ``nan_to_num`` and Adam.

The process group is ``torch.distributed``'s default group: ``init``
creates it, ``teardown`` destroys it, and every function here reads it.
Without one (a world of 1, the one-card path) the functions are the
identity, so that path runs no collective. Backends: NCCL where each rank
has its own card, gloo for CPU ranks (and for ranks that share one card,
which NCCL refuses). Gloo takes CUDA tensors in ``broadcast``,
``all_reduce`` and ``barrier`` only, so a gather here is an ``all_reduce``
of zero-filled slots, one for each rank, on every backend.

``split_over_devices`` is the one-process split: a batch's rows over the
cards of one process (the JAX package shards ``calc-metrics``' generator
batches and ``gen-samples``' sigma grid over every local device).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist


def init(rank, world, backend, init_file):
    """Join the process group of ``world`` ranks as ``rank``, over
    ``backend`` ('nccl' or 'gloo'), meeting at the file ``init_file``
    (a ``file://`` rendezvous: every rank names the same path, which must
    not exist before the first rank arrives)."""
    dist.init_process_group(backend, init_method=f'file://{init_file}',
                            rank=rank, world_size=world)


def teardown():
    """Leave the process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def active():
    """Whether a process group exists (collectives run)."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if active() else 0


def world():
    return dist.get_world_size() if active() else 1


def is_main():
    """Rank 0: the rank that writes files and prints."""
    return rank() == 0


def _comm_device(like):
    """Where a collective's buffer lives: the rank's card under NCCL, else
    the device of ``like``."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return like.device


def _to(x, device):
    x = torch.as_tensor(x)
    return x if device is None else x.to(device)


def split_rows(n):
    """The rows of each rank in a batch of ``n``: ``np.array_split``'s
    sizes, the first ``n % world`` ranks one row more."""
    return [len(part) for part in np.array_split(np.arange(n), world())]


def shard_batch(x, device=None):
    """This rank's rows of ``x`` (numpy or torch), a global-size batch that
    every rank drew alike from a shared stream (JAX ``shard_batch``): rank r
    takes the r-th of ``world`` equal blocks. As a tensor on ``device``."""
    n = x.shape[0]
    if n % world():
        raise ValueError(f'a batch of {n} does not split over {world()} '
                         f'ranks')
    rows = n // world()
    return _to(x[rank() * rows:(rank() + 1) * rows], device)


def local_batch(x, device=None):
    """``x`` (numpy or torch), rows of which each rank holds only its own,
    such as the real images of its strided sampler (JAX
    ``shard_host_local_batch``), as a tensor on ``device``."""
    return _to(x, device)


def _flat(tensors, device):
    return torch.cat([t.detach().reshape(-1).to(device) for t in tensors])


def _unflat(flat, tensors):
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean(tensors):
    """Replace each of ``tensors`` (one dtype, any shapes and devices) by
    its mean over the ranks: one flat bucket, one ``all_reduce`` of the
    sum, then a division by the world size (the reference's all_reduce and
    division, JAX's ``pmean``). Returns the bucket's bytes (0 without a
    process group, where the tensors stay as they are)."""
    tensors = list(tensors)
    if not active() or not tensors:
        return 0
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f'all_reduce_mean takes one dtype, got '
                         f'{sorted({str(t.dtype) for t in tensors})}')
    flat = _flat(tensors, _comm_device(tensors[0]))
    dist.all_reduce(flat)
    flat /= world()
    _unflat(flat, tensors)
    return flat.numel() * flat.element_size()


def gather_rows(x, counts=None):
    """Every rank's rows of ``x`` in rank order, on every rank: rank r
    holds ``counts[r]`` rows (default: as many as this rank's ``x``, alike
    on every rank). An ``all_reduce`` of zero-filled slots, one a rank, so
    each value is added to zeros only and arrives exactly."""
    if not active():
        return x
    counts = counts or [x.shape[0]] * world()
    if x.shape[0] != counts[rank()]:
        raise ValueError(f'rank {rank()} holds {x.shape[0]} rows, not '
                         f'{counts[rank()]}')
    slots = torch.zeros((world(), max(counts)) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=_comm_device(x))
    slots[rank(), :x.shape[0]] = x
    dist.all_reduce(slots)
    return torch.cat([slots[r, :n] for r, n in enumerate(counts)]).to(
        x.device)


def _state_tensors(module_or_optimizer):
    """(name, tensor) of a module's parameters and buffers, or of an
    optimizer's per-parameter state, in a fixed order."""
    if isinstance(module_or_optimizer, torch.nn.Module):
        return list(module_or_optimizer.state_dict(keep_vars=True).items())
    out = []
    params = [p for g in module_or_optimizer.param_groups
              for p in g['params']]
    for i, p in enumerate(params):
        for key, value in sorted(module_or_optimizer.state.get(p,
                                                               {}).items()):
            if torch.is_tensor(value):
                out.append((f'{i}.{key}', value))
    return out


def _bytes(tensors, device):
    """The tensors' bytes, concatenated, on ``device``."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      .to(device) for t in tensors])


def broadcast_module(*objects, src=0):
    """Give every rank ``src``'s parameters and buffers of each module, and
    per-parameter state of each optimizer, in ``objects`` (the reference's
    startup broadcast, training_loop.py:241-245; JAX's ``replicate``), one
    bucket of bytes an object. Every rank must hold the same structure."""
    if not active():
        return
    for obj in objects:
        tensors = [t for _, t in _state_tensors(obj)]
        if not tensors:
            continue
        flat = _bytes(tensors, _comm_device(tensors[0]))
        dist.broadcast(flat, src)
        offset = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel() * t.element_size()
                # a copy of the slice starts aligned for any dtype
                t.copy_(flat[offset:offset + n].clone().view(t.dtype)
                        .view_as(t))
                offset += n


def check_replica_consistency(modules, optimizers):
    """Compare each rank's parameters and buffers of ``modules`` and
    per-parameter state of ``optimizers`` (each a dict name -> object) with
    rank 0's, bit for bit (NaN included), and raise on every rank, naming
    the first tensor that differs on some rank (JAX training_loop.py:27-41,
    the reference's check_ddp_consistency). Nothing to compare without a
    process group."""
    if not active():
        return
    bad = []
    for name, obj in {**modules, **optimizers}.items():
        named = _state_tensors(obj)
        if not named:
            continue
        mine = _bytes([t for _, t in named], _comm_device(named[0][1]))
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        # the first byte that differs on any rank
        where = (mine != theirs).nonzero()
        first = torch.tensor([int(where[0]) if len(where) else mine.numel()],
                             device=mine.device)
        dist.all_reduce(first, op=dist.ReduceOp.MIN)
        offset = 0
        for key, t in named:
            offset += t.numel() * t.element_size()
            if int(first) < offset:
                bad.append(f'{name}.{key}')
                break
    if bad:
        raise RuntimeError(f'replicas differ from rank 0: {bad}')


def local_devices(device):
    """The cards one process splits a batch over: every visible card for
    ``cuda`` without an index, else ``device`` alone."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [device]


def replicas(module, devices):
    """``module`` on ``devices[0]`` (its own device) and a copy on each
    other device."""
    return [module] + [copy.deepcopy(module).to(d) for d in devices[1:]]


def split_over_devices(fn, tensors, devices):
    """``fn(i, *chunks)`` on each device's rows of ``tensors`` (the rows
    split as ``torch.tensor_split`` splits them, each chunk moved to
    ``devices[i]``), the results concatenated in row order on
    ``devices[0]``. With one device, ``fn(0, *tensors)``. The devices'
    calls are issued in turn and run concurrently as far as ``fn`` does
    not wait on its device."""
    if len(devices) == 1:
        return fn(0, *tensors)
    chunks = [torch.tensor_split(t, len(devices)) for t in tensors]
    outs = [fn(i, *(c[i].to(d) for c in chunks))
            for i, d in enumerate(devices) if len(chunks[0][i])]
    return torch.cat([o.to(devices[0]) for o in outs])
