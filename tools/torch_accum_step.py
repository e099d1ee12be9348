"""ms a step of the PyTorch port's data-parallel training with gradient
accumulation, for one or more checkouts of the repo on the same card.

reverb_large's widths (1024 wide, 16 heads, 4096 units, V 10000) at
LAYERS encoder layers and 1 + 1 decoder blocks, bf16, no dropout; two
data ranks over gloo on one card (`Sharding` without ZeRO), accum_grad 2;
a global batch of 2·ROWS utterances of 1600-2051 frames, ROWS a rank in
two micro-batches.  Each rank takes one untimed step and STEPS timed
ones; the median is reported.

    python3 tools/torch_accum_step.py TREE [TREE ...]

imports `reverb_tpu_torch` from each TREE in turn (give the same tree
twice, and the trees in the order A B B A, to see the card's drift) and
prints, as its last line, {"runs": [{"tree", "ms": [rank 0, rank 1],
"loss": rank 0's first step}]}.  Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

LAYERS = 4
ROWS = 8
ACCUM = 2
STEPS = 5
SEED = 0


def child(rank: int, tree: str, workdir: str) -> None:
    sys.path.insert(0, tree)
    import torch
    from reverb_tpu_torch.models import presets
    from reverb_tpu_torch.models.asr_model import ModelConfig, build_model
    from reverb_tpu_torch.parallel import mesh as pm
    from reverb_tpu_torch.parallel.sharding import Sharding
    from reverb_tpu_torch.train.trainer import (TrainConfig, build_optimizer,
                                                make_train_step)
    dev = pm.init_distributed(f'file://{workdir}/pg', 2, rank, 'cuda:0',
                              backend='gloo')
    conf = presets.reverb_config(num_blocks=LAYERS, dec_blocks=1,
                                 r_blocks=1)
    cfg = ModelConfig.from_config(conf).with_compute_dtype(torch.bfloat16)
    model = build_model(cfg, dev, generator=torch.Generator(
        device=dev).manual_seed(SEED), train=True)
    opt, _ = build_optimizer(TrainConfig.from_config(conf), model)
    sh = Sharding(pm.make_mesh(data=2), zero=False).apply(model, opt)
    step = make_train_step(model.cfg, opt, ACCUM, 50.0, sharding=sh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, T, V = 2 * ROWS, 2051, conf['output_dim']
    lens = torch.randint(1600, T + 1, (B,), device=dev, generator=gen)
    feats = torch.randn(B, T, 80, device=dev, generator=gen)
    feats *= (torch.arange(T, device=dev)[None, :] < lens[:, None])[..., None]
    tlens = torch.randint(40, 81, (B,), device=dev, generator=gen)
    target = torch.randint(1, V - 1, (B, 80), device=dev, generator=gen)
    target[torch.arange(80, device=dev)[None, :] >= tlens[:, None]] = -1
    batch = pm.local_rows({'feats': feats, 'feats_lengths': lens,
                           'target': target, 'target_lengths': tlens,
                           'cat_embs': torch.tensor([[1.0, 0.0]] * B,
                                                    device=dev)}, sh.mesh)
    loss, walls = None, []
    for i in range(STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, batch, None)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
        else:
            loss = m['loss']
    with open(os.path.join(workdir, f'rank{rank}.json'), 'w') as f:
        json.dump({'ms': statistics.median(walls), 'loss': loss}, f)
    torch.distributed.destroy_process_group()


def run(tree: str) -> dict:
    workdir = tempfile.mkdtemp(prefix='accum_step_')
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               '--child', f'{r},{tree},{workdir}'])
             for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0, 0]:
        raise SystemExit(f'{tree}: ranks exited {codes}')
    ranks = [json.load(open(os.path.join(workdir, f'rank{r}.json')))
             for r in range(2)]
    out = {'tree': tree, 'ms': [r['ms'] for r in ranks],
           'loss': ranks[0]['loss']}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == '--child':
        rank, tree, workdir = sys.argv[2].split(',')
        child(int(rank), tree, workdir)
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    print(json.dumps({'runs': [run(os.path.abspath(t))
                               for t in sys.argv[1:]]}))


if __name__ == '__main__':
    main()
