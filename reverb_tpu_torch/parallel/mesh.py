"""Process groups, the device mesh, the sharding rules and the batch.

Counterpart of reverb_tpu/parallel/mesh.py.  One process drives one device
(`init_distributed`, the counterpart of `jax.distributed.initialize`), and
`make_mesh` lays the world's ranks out as the JAX package lays out its
devices: ('pipe', 'data', 'seq', 'expert', 'model'), rank r where JAX's
device r stands (row-major), as a `torch.distributed.device_mesh.
DeviceMesh`.  The port trains over every axis: 'data' (data
parallelism, ZeRO), 'model' (tensor parallelism), 'seq' (the encoder's
time axis), 'expert' (the MoE feed-forward's experts) and 'pipe' (GPipe
stages of the encoder's middle stack, parallel/pipeline.py).
`axis_group` gives a process group over several axes at once (the ranks
that differ only there), for the gradient sums of parallel/sharding.py.

`TP_RULES` and `param_pspec` are the JAX package's table over the JAX
tree's dotted paths (`convert.tree_key` of a parameter's name), with one
row more: the conformer conv module's BatchNorm is split with the channels
it normalises (XLA's partitioner splits it there by itself; the port's
eager layers need the rule).  `param_shardings` and `opt_state_shardings`
give each parameter's layout as JAX's do: the rule's 'model' axis, and
over 'data' the first free axis whose length the data size divides, for
every moment (ZeRO-1/2) and, with `zero3`, for every parameter of at least
`zero3_min_size` elements (ZeRO-3).  A layout is a tuple with one entry
per axis: 'model', 'data' or None.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ('pipe', 'data', 'seq', 'expert', 'model')


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device='cuda',
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this process's device.

    `coordinator` is JAX's 'host:port' (or a `tcp://` / `file://` init
    method), with `num_processes` and `process_id`; without one the
    group comes from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK).  A 'cuda' device is `cuda:<local
    rank>` (LOCAL_RANK, else the process id modulo the card count) over
    NCCL; 'cpu' runs over gloo.  `backend` overrides that choice for the
    library's own callers; nothing falls back to another backend or
    device."""
    from reverb_tpu_torch.utils.common import resolve_device
    dev = resolve_device(device)
    env = coordinator is None
    if env and 'RANK' not in os.environ:
        raise ValueError('init_distributed needs a coordinator or '
                         "torchrun's environment (RANK, WORLD_SIZE, ...)")
    rank = int(os.environ['RANK']) if env else int(process_id)
    world = int(os.environ['WORLD_SIZE']) if env else int(num_processes)
    if dev.type == 'cuda' and dev.index is None:
        local = (int(os.environ['LOCAL_RANK']) if 'LOCAL_RANK' in os.environ
                 else rank % torch.cuda.device_count())
        dev = torch.device('cuda', local)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if env:
        init_method = 'env://'
    elif '://' in coordinator:
        init_method = coordinator
    else:
        init_method = f'tcp://{coordinator}'
    kwargs = {}
    if backend == 'nccl':
        kwargs['device_id'] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return dev


def make_mesh(data: int = -1, model: int = 1, seq: int = 1, expert: int = 1,
              pipe: int = 1):
    """The ('pipe','data','seq','expert','model') mesh over the world's
    ranks, rank r where JAX's device r stands (row-major); data=-1 takes
    the ranks the other axes leave.  The process group must be
    initialised (`init_distributed`)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError('make_mesh needs an initialised process group '
                         '(parallel.mesh.init_distributed)')
    n = dist.get_world_size()
    if data == -1:
        if n % (model * seq * expert * pipe):
            raise ValueError(f'{n} ranks do not split into model={model} '
                             f'seq={seq} expert={expert} pipe={pipe}')
        data = n // (model * seq * expert * pipe)
    if data * model * seq * expert * pipe != n:
        raise ValueError(f'mesh pipe={pipe} data={data} seq={seq} '
                         f'expert={expert} model={model} != {n} ranks')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    ranks = torch.arange(n).reshape(pipe, data, seq, expert, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def dropout_generator(seed: int, mesh, device) -> torch.Generator:
    """This rank's dropout generator: seeded by (seed, data coordinate),
    so data-parallel ranks draw different masks (identical masks on every
    rank would drop the same units of every shard of the batch).  The
    ranks of one data coordinate ('model', 'seq', 'expert' and 'pipe'
    groups) share it: their replicated activations take one mask, and
    their split ones (heads, hidden units, time blocks, experts) each the
    rank's block of one unsplit mask (models/modules.py:keep_mask).  Data
    rank 0 takes `seed` itself, the single-process generator."""
    r = axis_rank(mesh, 'data')
    s = seed if r == 0 else int(
        np.random.SeedSequence([seed, r]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh[name].size()


def axis_rank(mesh, name: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(name)


def axis_ranks(mesh, name: str) -> list:
    """The global ranks of this rank's group along `name`, in the
    axis's order."""
    return dist.get_process_group_ranks(mesh.get_group(name))


def axis_group(mesh, names: Sequence[str]):
    """The process group of the ranks that differ from this one only
    along `names` (None when they are this rank alone).  Collective: every
    rank of the world calls it with the same names, since each group of
    the partition is created on every rank."""
    names = tuple(a for a in AXES if a in names and axis_size(mesh, a) > 1)
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    ranks = mesh.mesh
    order = [AXES.index(a) for a in AXES if a not in names] + \
        [AXES.index(a) for a in names]
    n = int(np.prod([ranks.shape[AXES.index(a)] for a in names]))
    mine = None
    for block in ranks.permute(*order).reshape(-1, n).tolist():
        g = dist.new_group(block)
        if dist.get_rank() in block:
            mine = g
    return mine


# (regex over the JAX tree's dotted path) → layout.  First match wins.  A
# Linear weight is (out, in): 'model' on `out` is column-parallel, on `in`
# row-parallel.
TP_RULES = [
    # attention QKV: column-parallel (heads split across 'model')
    (r'.*self_attn\.linear_[qkv]\.weight$', ('model', None)),
    (r'.*self_attn\.linear_[qkv]\.bias$', ('model',)),
    (r'.*src_attn\.linear_[qkv]\.weight$', ('model', None)),
    (r'.*src_attn\.linear_[qkv]\.bias$', ('model',)),
    (r'.*attn\.linear_pos\.weight$', ('model', None)),
    (r'.*attn\.pos_bias_[uv]$', ('model', None)),
    # attention output: row-parallel
    (r'.*attn\.linear_out\.weight$', (None, 'model')),
    # FFN: w_1 column-parallel, w_2 row-parallel
    (r'.*feed_forward(_macaron)?\.w_1\.weight$', ('model', None)),
    (r'.*feed_forward(_macaron)?\.w_1\.bias$', ('model',)),
    (r'.*feed_forward(_macaron)?\.w_2\.weight$', (None, 'model')),
    # conformer conv module: channel-sharded pointwise/depthwise
    (r'.*pointwise_conv1\.weight$', ('model', None, None)),
    (r'.*pointwise_conv1\.bias$', ('model',)),
    (r'.*depthwise_conv\.weight$', ('model', None, None)),
    (r'.*depthwise_conv\.bias$', ('model',)),
    (r'.*pointwise_conv2\.weight$', (None, 'model', None)),
    # the port's row: the conv module's BatchNorm with its channels (a
    # LayerNorm there stays replicated, as JAX's table leaves it:
    # parallel/sharding.py gives its paths the layout () in `overrides`)
    (r'.*\.norm\.(weight|bias|running_mean|running_var)$', ('model',)),
    # vocab projections: column-parallel over vocab
    (r'.*output_layer\.weight$', ('model', None)),
    (r'.*output_layer\.bias$', ('model',)),
    (r'.*ctc_lo\.weight$', ('model', None)),
    (r'.*ctc_lo\.bias$', ('model',)),
    (r'.*embed\.0\.weight$', ('model', None)),   # token embedding (V, d)
]


def param_pspec(path: str, ndim: int) -> Tuple:
    """The rule's layout of the parameter at JAX tree path `path`, cut to
    `ndim` axes; () when no rule matches (replicated)."""
    for pat, spec in TP_RULES:
        if re.match(pat, path):
            return tuple(spec[:ndim])
    return ()


def _full_spec(path, shape, overrides=None):
    spec = list(overrides[path] if overrides and path in overrides
                else param_pspec(path, len(shape)))
    return spec + [None] * (len(shape) - len(spec))


def _free_data_axis(spec, shape, data_size: int) -> Optional[int]:
    for ax, n in enumerate(shape):
        if spec[ax] is None and n % data_size == 0 and n >= data_size:
            return ax
    return None


def param_shardings(shapes: Dict[str, Sequence[int]], mesh,
                    zero3: bool = False, zero3_min_size: int = 65536,
                    overrides=None) -> Dict[str, Tuple]:
    """{JAX path: layout} of the parameters {JAX path: global shape}: the
    rule's 'model' axis, and with `zero3` 'data' on the first free
    divisible axis of every parameter of at least `zero3_min_size`
    elements (reverb_tpu/parallel/mesh.py:param_shardings).  `overrides`
    {path: layout} replaces the rule's layout of a path (the port's split
    forms and what it keeps whole, parallel/sharding.py: a conv module's
    LayerNorm, which the port's BatchNorm row would otherwise match,
    takes ())."""
    data_size = axis_size(mesh, 'data')
    out = {}
    for path, shape in shapes.items():
        spec = _full_spec(path, shape, overrides)
        if zero3 and int(np.prod(shape)) >= zero3_min_size:
            ax = _free_data_axis(spec, shape, data_size)
            if ax is not None:
                spec[ax] = 'data'
        out[path] = tuple(spec)
    return out


def opt_state_shardings(shapes: Dict[str, Sequence[int]], mesh,
                        zero: bool = True, overrides=None) -> Dict[str, Tuple]:
    """{JAX path: layout} of each parameter's moments: the rule's 'model'
    axis, and with `zero` (ZeRO-1/2) 'data' on the first free divisible
    axis; 0-d leaves are replicated
    (reverb_tpu/parallel/mesh.py:opt_state_shardings)."""
    data_size = axis_size(mesh, 'data')
    out = {}
    for path, shape in shapes.items():
        if len(shape) == 0:
            out[path] = ()
            continue
        spec = _full_spec(path, shape, overrides)
        if zero:
            ax = _free_data_axis(spec, shape, data_size)
            if ax is not None:
                spec[ax] = 'data'
        out[path] = tuple(spec)
    return out


def local_rows(batch: Dict, mesh) -> Dict:
    """This rank's rows of a global batch: the block of its 'data'
    coordinate, as JAX's 'data'-sharded placement gives device r its
    block (ranks that differ only in 'model', 'seq', 'expert' or 'pipe'
    get the same rows).  Leaves
    whose leading axis the data size does not divide (a batch-level
    vector) go whole to every rank, as JAX replicates them."""
    n, r = axis_size(mesh, 'data'), axis_rank(mesh, 'data')
    out = {}
    for k, v in batch.items():
        if hasattr(v, 'shape') and len(v.shape) >= 1 and \
                v.shape[0] % n == 0:
            m = v.shape[0] // n
            out[k] = v[r * m:(r + 1) * m]
        else:
            out[k] = v
    return out


def put_batch(batch: Dict, mesh, device) -> Dict:
    """A host batch (numpy arrays) on `device`: with a mesh the global
    batch's `local_rows` for this rank, without one the whole batch (a
    process that reads its own partition holds its rows already, as
    each JAX process hands `put_batch` its slice).  Host-only fields
    (keys, langs) are dropped; int32 becomes int64, the loss's index
    dtype; CUDA copies go from pinned memory."""
    keep = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    if mesh is not None:
        keep = local_rows(keep, mesh)
    device = torch.device(device)
    out = {}
    for k, v in keep.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.to(torch.int64)
        if device.type == 'cuda':
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out
