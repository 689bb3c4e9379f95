"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size, in one process:

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds <n> ... [--control-seeds <n> ...] [--seconds 3]

For each of ``--seeds``, the program's numbers, as a run computes them.
For each of ``--control-seeds``, the control (the reference computed in
float8 e4m3, a step below the configuration's bfloat16) in the program's
place; for training cells also the faults planted in the reference in
the program's place: half of each batch left out, and one small leaf's
gradient doubled or zeroed at every step (``LEAF_FAULTS``). Each reading
is judged against the cell's limits as a run judges it (``correct``,
``failed``). One JSON line a reading, also appended to ``--out``.
"""

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))

from portbench.core import compare, inputs, manifest  # noqa: E402
from portbench.generators import assign, common, train  # noqa: E402
from portbench.reference import model, precision  # noqa: E402
from portbench.reference import train as reference  # noqa: E402


# (arm, leaf, factor): the leaf's gradient times the factor, every step
LEAF_FAULTS = (('fault_prior_logvars_x2', 'prior_logvars', 2.0),
               ('fault_prior_logvars_zero', 'prior_logvars', 0.0),
               ('fault_prior_means_zero', 'prior_means', 0.0))


def judged(cell, vals):
    """``vals`` against the cell's limits, as a run judges them."""
    checks = compare.checks(vals, cell.limits)
    return {**vals, 'correct': all(c.ok for c in checks),
            'failed': [c.name for c in checks if not c.ok]}


def scale_leaf(name, factor):
    return lambda grads: {k: g * factor if k == name else g
                          for k, g in grads.items()}


def _own(prog, ref, names):
    """For each of ``names``: (its norm gap over its own reference norm,
    the program's norm, the reference's)."""
    out = {}
    for k in names:
        a, b = float(prog[k].double().norm()), float(ref[k].double().norm())
        out[k] = [abs(a - b) / max(b, 1e-30), a, b]
    return out


def _worst(prog, ref, n=3):
    import statistics
    rn = {k: float(v.double().norm()) for k, v in ref.items()}
    med = statistics.median(rn.values())
    gaps = sorted(((abs(float(prog[k].double().norm()) - rn[k])
                    / max(rn[k], med), k, float(prog[k].double().norm()),
                    rn[k]) for k in ref), reverse=True)
    return [[k, g, a, b] for g, k, a, b in gaps[:n]] + [['median', med]]


def diagnose(p0, losses, grad, params, ref):
    """Where the numbers come from: each step's loss gap, the three worst
    leaves of the gradient and of the change (gap, program, reference),
    and the faulted leaves' own gaps."""
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    small = sorted({leaf for _, leaf, _ in LEAF_FAULTS})
    change_p = {k: params[k].cpu() - p0[k].cpu() for k in small}
    change_r = {k: ref.params[k].cpu() - p0[k].cpu() for k in small}
    grad_l, change_l = train.leaf_gaps(p0, cpu(grad), params, ref)
    return {
        'grad_leaves': grad_l, 'change_leaves': change_l,
        'err_leaves': compare.diff_gaps(cpu(grad), cpu(ref.first_grad)),
        'leaf_grad_own': _own(cpu(grad), cpu(ref.first_grad), small),
        'leaf_change_own': _own(change_p, change_r, small),
        'loss_steps': [abs(a - b) / abs(b) for a, b in
                       zip(losses, ref.losses)],
        'ref_losses': ref.losses,
        'grad_worst': _worst(cpu(grad), cpu(ref.first_grad)),
        'raw_norms': sorted(float(v.norm()) for v in ref.first_raw.values()),
        'change_worst': _worst(
            {k: params[k].cpu() - p0[k].cpu() for k in p0},
            {k: ref.params[k].cpu() - p0[k].cpu() for k in p0}),
    }


def train_readings(cell, seeds, control_seeds, device):
    for seed in seeds:
        st = train.start(cell, seed, device)
        st = st._replace(trainer=None, state=None, chunks=None)
        common.free(device)
        ref = reference.train_steps(cell.config, st.params0, st.train_u8,
                                    st.seed32, train.CHECK_STEPS, device)
        yield {'seed': seed, 'arm': 'program',
               **judged(cell, train.numbers(cell.config, st.params0,
                                            st.losses, st.grad1, st.params3,
                                            ref)),
               **diagnose(st.params0, st.losses, st.grad1, st.params3, ref)}
        del st
        common.free(device)
    cfg = cell.config
    for seed in control_seeds:
        seed32 = seed % 2 ** 32
        u8 = inputs.images_u8(cfg['train_examples'], cfg['image_shape'],
                              seed, device)
        p0 = model.make_params(cfg, seed, device)
        ref = reference.train_steps(cfg, p0, u8, seed32, train.CHECK_STEPS,
                                    device)
        arms = [('control_fp8', {'cast': precision.fp8_e4m3}),
                ('fault_half_batch', {'keep_rows': 0.5})]
        arms += [(arm, {'grad_fault': scale_leaf(leaf, f)})
                 for arm, leaf, f in LEAF_FAULTS]
        for arm, kw in arms:
            other = reference.train_steps(cfg, p0, u8, seed32,
                                          train.CHECK_STEPS, device, **kw)
            yield {'seed': seed, 'arm': arm, **judged(cell, train.numbers(
                cfg, p0, other.losses, other.first_grad, other.params,
                ref)),
                **diagnose(p0, other.losses, other.first_grad, other.params,
                           ref)}
        common.free(device)


def assign_readings(cell, seeds, control_seeds, seconds, device):
    for seed in seeds:
        out = assign.run(cell, seed, seconds, False, device,
                         time.perf_counter())
        yield {'seed': seed, 'arm': 'program',
               **judged(cell, out.readings), 'requests': out.attempted}
        common.free(device)
    cfg, batch = cell.config, int(cell.traffic['batch'])
    for seed in control_seeds:
        pool, _ = assign.pool_images(cfg, seed, batch, device)
        x = torch.from_numpy(pool[:cfg['test_examples']])
        p0 = model.make_params(cfg, seed, device)
        ref = reference.cluster_logits(cfg, p0, x, device).cpu()
        low = reference.cluster_logits(cfg, p0, x, device,
                                       cast=precision.fp8_e4m3).cpu()
        ids = low.argmax(dim=1).to(torch.int32).numpy()
        yield {'seed': seed, 'arm': 'control_fp8', **judged(
            cell, assign.numbers(assign.gaps(ref, [0], [ids],
                                             ids.shape[0])))}
        common.free(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.find_cell(manifest.load_manifest(), args.workload)
    if cell.traffic['generator'] == 'train':
        rows = train_readings(cell, args.seeds, args.control_seeds,
                              args.device)
    else:
        rows = assign_readings(cell, args.seeds, args.control_seeds,
                               args.seconds, args.device)
    for row in rows:
        line = json.dumps({'workload': args.workload, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')


if __name__ == '__main__':
    main()
