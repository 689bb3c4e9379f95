"""celeba_dp16 at batch 256: the one-cluster plateau, on the GPU.

Early in training celeba_dp16 (K=64) sits on a plateau where q(k|x) is
nearly uniform (the categorical KL ~1e-6 nats) and the eval puts every
image in one cluster; which way the symmetry breaks is set by differences
at the level of float32 rounding. This tool measures how often the first
steps leave the plateau, through the kernels and through the head's plain
version on the same noise; whether the two compute the same gradient
along the way; and where long runs through the kernels land:

    python -m gmvae_tpu_torch.tools.celeba_plateau --seeds 0 1 2 3 4 \
        --steps 1000 --grads 300 --long 10000 --long-seeds 2 3 4
    python -m gmvae_tpu_torch.tools.celeba_plateau --steps 0 \
        --long 10000 --long-seeds 0 --init STATE.pt

``--steps N``: for each of ``--seeds``, N steps through the kernels and
N through the plain head, evals at N/2 and N. ``--grads N``: along the
kernels' trajectory from seed 0, at steps 0..N, each leaf's gradient
through the kernels against the gradient through the plain head on the
same state, batch and keys (relative L2 difference, the five largest),
with the head's inputs' largest magnitudes. ``--long N``: N steps through
the kernels for each of ``--long-seeds``, evals every N/5, from the
seed's own parameters or from ``--init`` (a ``state_dict`` saved with
``torch.save``; the seed still sets the keys and the plan). Every run
prints one JSON line: its evals (step, ELBO, IWAE, ACC, NMI; the last over
the whole test set, the others over its first 2,048 images) and its wall
time. After the ``--steps`` runs, one more line counts the seeds that
left the plateau (NMI at the last eval >= ``LEFT_NMI``) through each head
and compares the counts with Fisher's exact test: two-sided, and one-sided
for the kernels leaving less often than the plain head.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gmvae_tpu_torch import configs, data, prng, training
from gmvae_tpu_torch.ops.kernels import fused_elbo

BATCH = 256
LEFT_NMI = 0.5   # a run at or above this NMI has left the plateau


def _trainer(ds, seed, plain, steps, every, name):
    cfg = configs.celeba_dp16(batch_size=BATCH, steps=steps, eval_every=every,
                              ckpt_every=0, seed=seed, name=name,
                              metrics_mode='stacked')
    tr = training.Trainer(cfg, dataset=ds, device='cuda')
    if plain:
        # eager steps: the plain head draws its noise from a key on the host
        tr.model.head_fn = fused_elbo.fused_mixture_elbo_plain
        tr.graphs = None
    return tr


def run(ds, seed, plain, steps, every, init=None):
    name = f'{"plain" if plain else "kernels"}_seed{seed}'
    tr = _trainer(ds, seed, plain, steps, every, name)
    st = tr.init_state()
    if init:
        sd = torch.load(init, weights_only=True)
        st = tr.fresh_state({k: sd[k].to(tr.device) for k in st.params})
        name += '_init'
    hist, t0 = [], time.perf_counter()
    for _, idx in tr.iter_chunk_plans(0, steps):
        st, _ = tr.run_chunk(st, idx)
        if st.step % every == 0:
            ev = tr.evaluate(st, max_examples=None if st.step == steps
                             else 2048)
            hist.append([st.step, ev['elbo_nats'], ev['iwae_nats'],
                         ev['acc'], ev['nmi']])
    print(json.dumps({'run': name, 'batch': BATCH, 'steps': steps,
                      'wall_s': time.perf_counter() - t0,
                      'evals': hist}), flush=True)
    return hist


def grads(ds, steps):
    tr = _trainer(ds, 0, False, steps, steps, 'grads')
    model, cfg = tr.model, tr.cfg
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    loss_fn = training.make_loss_fn(model, cfg)
    seen = {}

    def spy(head):
        def f(key, kl, qm, qlv, prior, tau, hard=False):
            seen.update(kl=float(kl.detach().abs().max()),
                        qm=float(qm.detach().abs().max()),
                        qlv=float(qlv.detach().abs().max()), tau=float(tau))
            return head(key, kl, qm, qlv, prior, tau, hard=hard)
        return f

    def grad_with(head, state, step):
        tr.bind(state)
        model.head_fn = spy(head)
        idx = tr.batch_plan(1, start_step=step)[0]
        batch = tr.x_all[idx].reshape(cfg.batch_size, *cfg.image_shape)
        key = prng.fold_in(prng.fold_in(tr.base_key, step), 0)
        k_pre, k_elbo = prng.split(key)
        x = data.preprocess_batch(k_pre, batch, cfg.binarize)
        with torch.enable_grad():
            loss, m = loss_fn(x, k_elbo, step)
            g = torch.autograd.grad(loss, params)
        model.head_fn = fused_elbo.fused_mixture_elbo
        return g, float(m['loss']), float(m['kl_cat'])

    state, step = tr.init_state(), 0
    for target in sorted({t for t in (0, 10, 25, 50) if t <= steps}
                         | set(range(100, steps + 1, 100))):
        if target > step:
            state, _ = tr.run_chunk(state, tr.batch_plan(target - step,
                                                         start_step=step))
            step = target
        gk, loss_k, klc_k = grad_with(fused_elbo.fused_mixture_elbo, state,
                                      step)
        gp, loss_p, klc_p = grad_with(fused_elbo.fused_mixture_elbo_plain,
                                      state, step)
        rel = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-30)), n)
                      for n, a, b in zip(names, gk, gp)), reverse=True)[:5]
        print(json.dumps({'step': step, 'loss': [loss_k, loss_p],
                          'kl_cat': [klc_k, klc_p],
                          'grad_rel_diff_top5': [[n, r] for r, n in rel],
                          'head_inputs_absmax': seen}), flush=True)


def escape_summary(nmi, steps):
    """The seeds that left the plateau through the kernels and through the
    plain head, from ``nmi[plain][seed]`` (the last eval's NMI), and
    Fisher's exact test of the two counts."""
    from scipy.stats import fisher_exact
    left = {plain: sorted(s for s, v in by_seed.items() if v >= LEFT_NMI)
            for plain, by_seed in nmi.items()}
    n = len(nmi[False])
    table = [[len(left[False]), n - len(left[False])],
             [len(left[True]), n - len(left[True])]]
    return {'summary': 'plateau escapes', 'steps': steps, 'seeds': n,
            'left_nmi': LEFT_NMI,
            'kernels_left': left[False], 'plain_left': left[True],
            'kernels_nmi': nmi[False], 'plain_nmi': nmi[True],
            'fisher_p_two_sided': float(fisher_exact(table)[1]),
            'fisher_p_kernels_less': float(
                fisher_exact(table, alternative='less')[1])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2, 3, 4])
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--grads', type=int, default=0)
    ap.add_argument('--long', type=int, default=0)
    ap.add_argument('--long-seeds', type=int, nargs='+', default=[0])
    ap.add_argument('--init', default=None)
    args = ap.parse_args(argv)
    training.resolve_device('cuda')
    torch.backends.cudnn.allow_tf32 = False
    ds = data.load('celeba')
    if args.grads:
        grads(ds, args.grads)
    if args.steps:
        nmi = {False: {}, True: {}}
        for seed in args.seeds:
            for plain in (False, True):
                hist = run(ds, seed, plain, args.steps, args.steps // 2)
                nmi[plain][seed] = hist[-1][4]
        print(json.dumps(escape_summary(nmi, args.steps)), flush=True)
    if args.long:
        for seed in args.long_seeds:
            run(ds, seed, False, args.long, args.long // 5, args.init)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
