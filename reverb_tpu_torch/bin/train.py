"""Training entry point: `python -m reverb_tpu_torch.bin.train`.

Counterpart of reverb_tpu/bin/train.py (reference asr/wenet/bin/train.py:
64-216), with its flags and order: config and overrides → the tokenizer →
train.yaml → the datasets (CV without augmentation) → the model with the
global CMVN stats inside its parameters (or the `--checkpoint`'s
parameters) → `--enc_init` → the optimizer and schedule → resume (epoch and
step from the checkpoint's yaml, the optimizer from the port's
`.torch_opt.pt` or the JAX package's `.opt.npz`) → the device frontend of
`dataset_conf.device_feats` → the tracker, the watchdog and the
profiler → the epoch loop {train with mid-epoch snapshots, CV,
`epoch_N.npz` + `.yaml`} → the dataset statistics.

`--device` (default cuda) is where the model and every step run; without a
card it raises unless `--device cpu` is given.  Dropout draws from a
`torch.Generator` on the device, seeded from `--seed` (and the rank's data
coordinate: parallel/mesh.py:dropout_generator).

Several processes train one model as the JAX package's do: each process
drives one device (`cuda:<local rank>`, NCCL; gloo with `--device cpu`),
joined by `--coordinator host:port --num_processes N --process_id r` or by
torchrun's environment.  The processes form the mesh
(parallel/mesh.py:make_mesh) with `--num_devices_model` ranks of tensor
parallelism, `--num_devices_seq` of the encoder's time axis,
`--num_devices_expert` of the MoE experts and `--num_devices_pipe` GPipe
stages (in `--pipeline_microbatches` microbatches; `encoder_conf.
pipeline_stages` defaults to the stage count, as in the JAX package), and
the rest data-parallel; the optimizer's moments are split over 'data'
(ZeRO-1/2, as the JAX package always splits them) and, with `--zero3`,
the large parameters too (parallel/sharding.py).  Each rank reads its
data coordinate's partition of the training list and the whole CV list;
rank 0 logs and writes the checkpoints, gathered to the single-process
layout.

A config of another family than the conformer asr_model — `model:
k2_model | transducer | bitransducer | paraformer | ctl_model | bestrq |
wav2vec2 | w2vbert | whisper`, or an asr_model with `encoder:
branchformer | e_branchformer | squeezeformer | efficient_conformer` — is
built by `models/registry.py:init_model` and trained through its bundle's
loss.  A `ts_conf` (teacher-student distillation) builds its teacher from
`teacher_yaml` and `teacher_checkpoint`, frozen, and trains the student on
`train/teacher_student.py:ts_loss` (the teacher whole and frozen on
every rank, outside the sharding).  Both train under every axis, as the
asr_model does: each loss is the rank's share of the global
(micro-)batch's (parallel/global_batch.py, accum_grad too); under
'model' the layers with a split form split and the rest run whole
(parallel/sharding.py); under 'seq' the conformer and Branchformer
encoders split their time axis and the others run whole on every rank;
under 'expert' an MoE conformer splits its experts; under 'pipe' a
conformer encoder whose config asks for the stages runs its GPipe
region, and trains it under 'seq' and 'expert' as well (each stage on
the rank's time block, its experts split inside the stage): every mix of
the four axes trains, as in the JAX package.  The MoE feed-forward
(`encoder_conf.positionwise_layer_type: moe`) is a conformer option and
trains as any conformer.  `--prng_impl` other than auto raises
NotImplementedError.
"""

from __future__ import annotations

import argparse
import logging
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description='train a reverb model (PyTorch)')
    p.add_argument('--config', required=True)
    p.add_argument('--data_type', default='raw', choices=['raw', 'shard'])
    p.add_argument('--train_data', required=True)
    p.add_argument('--cv_data', required=True)
    p.add_argument('--model_dir', required=True)
    p.add_argument('--checkpoint', default=None,
                   help='resume/init checkpoint (.npz of either package or '
                        'a reverb .pt)')
    p.add_argument('--override_config', action='append', default=[])
    p.add_argument('--max_epoch', type=int, default=None)
    p.add_argument('--steps_per_epoch', type=int, default=None)
    p.add_argument('--num_devices_model', type=int, default=1,
                   help="tensor-parallel size (the mesh's 'model' axis)")
    p.add_argument('--num_devices_seq', type=int, default=1,
                   help="sequence-parallel size (the mesh's 'seq' axis: "
                        "the encoder's time axis split)")
    p.add_argument('--num_devices_expert', type=int, default=1,
                   help="expert-parallel size (the mesh's 'expert' axis: "
                        'the MoE feed-forward\'s experts split)')
    p.add_argument('--num_devices_pipe', type=int, default=1,
                   help="GPipe stages (the mesh's 'pipe' axis): the "
                        'homogeneous middle conformer stack runs as N '
                        'stages (sets encoder_conf.pipeline_stages unless '
                        'the config pins it)')
    p.add_argument('--pipeline_microbatches', type=int, default=None,
                   help='GPipe microbatches (default '
                        'encoder_conf.pipeline_microbatches or 2)')
    p.add_argument('--zero3', action='store_true',
                   help='ZeRO-3: split the large parameters over the data '
                        'ranks too')
    p.add_argument('--stall_timeout_s', type=float, default=1800.0,
                   help='straggler watchdog: abort/diagnose when no step '
                        'completes for this long (0 disables; '
                        'REVERB_STALL_EXIT=1 hard-exits for supervisor '
                        'restart — the wenet_join timeout equivalent)')
    p.add_argument('--coordinator', default=None,
                   help='host:port of the process group (or a tcp:// or '
                        "file:// init method); without it torchrun's "
                        'environment, when set')
    p.add_argument('--num_processes', type=int, default=1)
    p.add_argument('--process_id', type=int, default=0)
    p.add_argument('--tensorboard_dir', default=None)
    p.add_argument('--seed', type=int, default=777)
    p.add_argument('--prng_impl', default='auto',
                   choices=['auto', 'threefry2x32', 'rbg'],
                   help="the JAX package's PRNG choice (only auto: the "
                        "port's dropout draws from torch's generator)")
    p.add_argument('--log_interval', type=int, default=100)
    p.add_argument('--enc_init', default=None,
                   help='partial-init checkpoint (load_trained_modules)')
    p.add_argument('--enc_init_mods', default='encoder.',
                   help='comma-separated module prefixes for --enc_init')
    p.add_argument('--profile_dir', default=None,
                   help='write a torch.profiler trace here')
    p.add_argument('--profile_start_step', type=int, default=10)
    p.add_argument('--profile_num_steps', type=int, default=5)
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    return p.parse_args(argv)


SPLIT_FLAGS = ('num_devices_model', 'num_devices_seq', 'num_devices_expert',
               'num_devices_pipe')


def check_supported(args, configs):
    """The family `configs` trains (`registry.model_kind`), before any
    rendezvous: NotImplementedError for what the port does not train,
    ValueError for an unknown family."""
    from reverb_tpu_torch.models.registry import model_kind
    if args.prng_impl != 'auto':
        raise NotImplementedError(
            f"--prng_impl {args.prng_impl}: the JAX package's PRNG choice; "
            f"the port's dropout draws from torch's generator")
    return model_kind(configs)


def teacher_student_loss(ts_conf, dev):
    """The distillation loss of a `ts_conf` (train/teacher_student.py):
    the teacher from its config (`teacher_yaml`) and checkpoint
    (`teacher_checkpoint`, a `.npz` or a reverb `.pt`), frozen in eval
    mode on `dev`; the loss replaces the student's."""
    import dataclasses

    from reverb_tpu_torch.convert import (load_flat_checkpoint,
                                          state_dict_from_jax)
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.train.teacher_student import TSConfig, ts_loss
    from reverb_tpu_torch.utils.config import load_config
    teacher = build_model(
        ModelConfig.from_config(load_config(ts_conf['teacher_yaml'])), dev,
        state_dict_from_jax(load_flat_checkpoint(
            ts_conf['teacher_checkpoint'])))
    fields = {f.name for f in dataclasses.fields(TSConfig)}
    tsc = TSConfig(**{k: v for k, v in ts_conf.items() if k in fields})
    logging.info('teacher-student distillation (teacher %s)',
                 ts_conf['teacher_checkpoint'])

    def loss_fn(model, batch, generator=None):
        return ts_loss(model, teacher, batch, tsc, generator)
    return loss_fn


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(filename)s %(levelname)s: %(message)s')
    import torch

    from reverb_tpu_torch.convert import (load_flat_checkpoint,
                                          state_dict_from_jax)
    from reverb_tpu_torch.data.dataset import Dataset
    from reverb_tpu_torch.data.pipeline import mystats
    from reverb_tpu_torch.frontend.cmvn import load_cmvn_from_configs
    from reverb_tpu_torch.frontend.device_feats import frontend_from_configs
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.models.registry import init_model
    from reverb_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                dropout_generator,
                                                init_distributed, make_mesh)
    from reverb_tpu_torch.parallel.sharding import Sharding
    from reverb_tpu_torch.text.tokenizer import init_tokenizer
    from reverb_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   load_trained_modules)
    from reverb_tpu_torch.train.executor import Executor
    from reverb_tpu_torch.train.trainer import (TrainConfig,
                                                build_optimizer,
                                                make_eval_step,
                                                make_train_step)
    from reverb_tpu_torch.train.watchdog import epoch_barrier
    from reverb_tpu_torch.utils.common import resolve_device
    from reverb_tpu_torch.utils.config import (check_modify_and_save_config,
                                               load_config, override_config)
    from reverb_tpu_torch.utils.tracking import init_tracking

    configs = override_config(load_config(args.config), args.override_config)
    kind = check_supported(args, configs)
    if args.num_devices_pipe > 1:
        # the GPipe region runs when encoder_conf.pipeline_stages is the
        # mesh's 'pipe' size (models/encoder.py), as in the JAX package
        enc_conf = dict(configs.get('encoder_conf', {}) or {})
        enc_conf.setdefault('pipeline_stages', args.num_devices_pipe)
        if args.pipeline_microbatches:
            enc_conf['pipeline_microbatches'] = args.pipeline_microbatches
        configs['encoder_conf'] = enc_conf
    mesh = sharding = None
    if args.coordinator or args.num_processes > 1 or \
            int(os.environ.get('WORLD_SIZE', '1')) > 1:
        dev = init_distributed(args.coordinator if args.coordinator or
                               args.num_processes > 1 else None,
                               args.num_processes, args.process_id,
                               args.device)
        mesh = make_mesh(model=args.num_devices_model,
                         seq=args.num_devices_seq,
                         expert=args.num_devices_expert,
                         pipe=args.num_devices_pipe)
    elif any(getattr(args, f) > 1 for f in SPLIT_FLAGS) or args.zero3:
        raise ValueError('--num_devices_model / _seq / _expert / _pipe and '
                         '--zero3 need several processes (--coordinator / '
                         '--num_processes, or torchrun)')
    else:
        dev = resolve_device(args.device)
    first = torch.distributed.get_rank() == 0 if mesh is not None else True
    # the data coordinate's partition: ranks of one 'model' group read the
    # same rows
    rank, world = axis_rank(mesh, 'data'), axis_size(mesh, 'data')

    tokenizer = init_tokenizer(configs)
    configs = check_modify_and_save_config(
        args if first else argparse.Namespace(), configs,
        tokenizer.symbol_table)

    ds_conf = configs['dataset_conf']
    cv_conf = dict(ds_conf)
    # CV disables augmentation (train_utils.py:301-349)
    for k in ('spec_aug', 'spec_sub', 'spec_trim', 'speed_perturb',
              'apply_telephony', 'apply_rir'):
        cv_conf[k] = False
    cv_conf['shuffle'] = False
    cv_conf['cycle'] = 1

    def make_train_ds(epoch):
        return Dataset(args.data_type, args.train_data, tokenizer, ds_conf,
                       partition=True, rank=rank, world_size=world,
                       seed=args.seed + epoch).prefetch(8)

    def make_cv_ds():
        return Dataset(args.data_type, args.cv_data, tokenizer, cv_conf,
                       partition=False)

    tc = TrainConfig.from_config(configs)
    loss_fn = None
    if kind != 'asr_model':
        # a registry family: its bundle's model and loss; the
        # checkpoint's parameters (CMVN stats or their absence included)
        # replace the initial ones
        bundle = init_model(
            configs, torch.Generator(device=dev).manual_seed(args.seed), dev,
            state_dict=(state_dict_from_jax(load_flat_checkpoint(
                args.checkpoint)) if args.checkpoint else None))
        model, loss_fn = bundle.model, bundle.loss_fn
        if args.enc_init:
            load_trained_modules(model, args.enc_init,
                                 args.enc_init_mods.split(','))
        logging.info('training registry model %r', bundle.kind)
    elif args.checkpoint:
        # the checkpoint's parameters replace the initial ones, its CMVN
        # stats (or their absence) included, as in the JAX package
        model = build_model(
            ModelConfig.from_config(configs), dev,
            state_dict_from_jax(load_flat_checkpoint(args.checkpoint)),
            train=True)
    else:
        # GlobalCMVN stats live IN the parameters from construction
        # (init_model.py:102-104), so a trained checkpoint normalizes with
        # the stats the serving CLI applies
        model = build_model(
            ModelConfig.from_config(configs), dev,
            generator=torch.Generator(device=dev).manual_seed(args.seed),
            train=True, cmvn=load_cmvn_from_configs(configs))
        if args.enc_init:
            load_trained_modules(model, args.enc_init,
                                 args.enc_init_mods.split(','))
    if configs.get('ts_conf'):
        loss_fn = teacher_student_loss(configs['ts_conf'], dev)
    cfg = model.cfg
    optimizer, schedule = build_optimizer(tc, model)

    start_epoch, start_step = 0, 0
    if args.checkpoint:
        info = load_checkpoint(args.checkpoint, model, optimizer)
        start_epoch = int(info.get('epoch', 0))
        start_step = int(info.get('step', 0))
        logging.info('resumed from %s at epoch %d step %d', args.checkpoint,
                     start_epoch, start_step)

    if mesh is not None:
        # every rank holds the whole state here (one seed, one
        # checkpoint): split it over the mesh
        sharding = Sharding(mesh, zero=True, zero3=args.zero3).apply(
            model, optimizer)

    # dataset_conf.device_feats: fbank and SpecAugment on the device inside
    # the step; the host pipeline ships the padded PCM only
    frontend = frontend_from_configs(configs)
    train_step = make_train_step(cfg, optimizer, tc.accum_grad,
                                 grad_clip=tc.grad_clip, frontend=frontend,
                                 sharding=sharding, loss_fn=loss_fn)
    eval_step = make_eval_step(cfg, frontend=frontend, loss_fn=loss_fn)

    # experiment tracking (wandb/tensorboard/jsonl; train_utils.py:495-533)
    tracker = None
    if first:
        tracker = init_tracking(args.model_dir, configs,
                                train_data=args.train_data,
                                cv_data=args.cv_data,
                                tensorboard_dir=args.tensorboard_dir)

    snap_conf = configs.get('snapshot_saving_conf', {}) or {}
    ex = Executor(train_step=train_step, eval_step=eval_step,
                  model_dir=args.model_dir,
                  log_interval=args.log_interval,
                  save_interval=snap_conf.get('save_interval', 0),
                  save_optimizer_every=snap_conf.get('save_optimizer_every',
                                                     4),
                  schedule=schedule, writer=tracker,
                  save_to_tracker=bool(snap_conf.get('save_to_wandb')),
                  use_named_snapshots=bool(
                      snap_conf.get('use_named_snapshots', True)),
                  run_tag=snap_conf.get('run_tag'),
                  device=dev, step=start_step, sharding=sharding)
    if args.stall_timeout_s > 0:
        from reverb_tpu_torch.train.watchdog import StepWatchdog
        ex.watchdog = StepWatchdog(args.stall_timeout_s)
    if args.profile_dir:
        from reverb_tpu_torch.utils.profiling import ProfileWindow
        ex.profiler = ProfileWindow(args.profile_dir,
                                    args.profile_start_step,
                                    args.profile_num_steps)

    max_epoch = args.max_epoch or configs.get('max_epoch', 100)
    generator = dropout_generator(args.seed, mesh, dev)
    try:
        for epoch in range(start_epoch, max_epoch):
            ex.train(model, optimizer, make_train_ds(epoch), epoch,
                     generator,
                     cv_dataset=make_cv_ds() if snap_conf.get(
                         'save_interval') else None,
                     max_steps=(args.steps_per_epoch * (epoch + 1)
                                if args.steps_per_epoch else None))
            epoch_barrier(f'epoch_{epoch}')
            cv_metrics = ex.cv(model, make_cv_ds())
            logging.info('epoch %d CV: %s', epoch, cv_metrics)
            ex.save(f'epoch_{epoch}', model, optimizer,
                    {'epoch': epoch, 'step': ex.step,
                     'frames_seen': ex.frames_seen,
                     'lr': float(schedule(ex.step)),
                     'cv_loss': cv_metrics.get('loss')})
    finally:
        if ex.watchdog is not None:
            ex.watchdog.stop()
    enc = getattr(model, 'encoder', None)
    if getattr(enc, 'seq_split', None) is not None:
        logging.info("'seq': %d training forwards ran split, %d whole (the "
                     'frames did not divide)', enc.seq_steps['split'],
                     enc.seq_steps['whole'])
    if tracker is not None:
        tracker.finish()
    logging.info('dataset statistics: %s', dict(mystats))
    return ex


if __name__ == '__main__':
    main()
