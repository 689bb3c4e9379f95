"""Serving exports: the port of ``gmvae_tpu/serving.py``.

Each inference verb becomes a self-contained ``torch.export`` artifact:

- the trained parameters are baked into the program as its buffers, so one
  file is the whole model (no checkpoint, no model code);
- the batch dimension is symbolic (``torch.export.Dim``), so one artifact
  serves any batch size, 1 included;
- ``torch.export.load`` and a call run it in any process that has
  ``torch``; ``gmvae_tpu_torch`` is not needed there.

The verbs wrap the same model methods the live API calls (``api.py``), so
an artifact and the API agree by construction. The fused head is in no
export: the verbs do not reach it, and no artifact holds a custom kernel.

An artifact runs on the device it was exported on (the card by default)
unless it lists others. ``platforms=['cuda', 'cpu']``, the counterpart of
the reference's cross-lowering, records the devices the artifact may run
on; a host without a card can write one for the card (traced on the CPU).
``load_program`` puts such a program on the caller's device with
``torch.export.passes.move_to_device_pass`` and refuses a device it does
not list. The file stays a plain ``.pt2``: ``torch.export.load`` alone
runs it where it was traced.

A data-parallel artifact (``dp_batch=n``) is the reference's sharded
export in the port's idiom, one process for each device: a fixed-batch
program of ``n // world`` rows that every rank of a process group of that
size runs on its slice of the global batch; ``load_and_call`` gathers the
slices, so every rank returns the whole answer.

Usage::

    blob = serving.export_verb(trainer, state, 'assign', path='assign.pt2')
    # serving side, with torch only:
    #   prog = torch.export.load('assign.pt2').module()
    #   ids = prog(images_f32)         # [B,H,W,C] in [0,1] on its device
    # or, loaded once and called many times (tools/serve_http.py):
    #   prog = serving.load_program('assign.pt2')
    #   ids = prog(images_f32_numpy)   # numpy out; prog.spec the input shape
    # written on a CPU host for the card, and run there:
    #   export_verb(trainer, state, 'assign', device='cpu',
    #               platforms=['cuda', 'cpu'], path='assign.pt2')
    #   prog = serving.load_program('assign.pt2', device='cuda')
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from gmvae_tpu_torch import nets
from gmvae_tpu_torch.parallel import mesh
from gmvae_tpu_torch.training import resolve_device
from gmvae_tpu_torch.utils.profiling import span

VERBS = ('assign', 'probs', 'latent', 'reconstruct')
# the devices an artifact may list (``export_verb``'s ``platforms``)
PLATFORMS = ('cpu', 'cuda')
# the artifact's own record of its data-parallel layout and its devices,
# inside the file
_META = 'gmvae_serving.json'


class _VerbCall(nn.Module):
    """``forward(x)`` = one inference verb of ``model``."""

    def __init__(self, model: nn.Module, verb: str):
        super().__init__()
        if verb not in VERBS:
            raise ValueError(f'verb must be one of {VERBS}, got {verb!r}')
        self.model, self.verb = model, verb

    def forward(self, x: torch.Tensor):
        if self.verb == 'assign':
            return torch.argmax(self.model.cluster_logits(x),
                                dim=-1).to(torch.int32)
        if self.verb == 'probs':
            return torch.softmax(self.model.cluster_logits(x), dim=-1)
        if self.verb == 'latent':
            return self.model.latent(x)
        return self.model.reconstruct(x)


def _out_axes(model: nn.Module) -> Dict[str, int]:
    """The output-channel axis of each parameter with 2 or more dims: the
    axis the reference keeps when it takes the last axis of flax's layout.
    Linear ``[out, in]`` and conv ``[out, in, kh, kw]`` weights: 0;
    ``conv_transpose2d`` weights ``[in, out, kh, kw]``: 1; tensors that
    keep the reference's layout (the GMVAE's prior ``[K, D]``): the last."""
    axes = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if p.ndim < 2:
                continue
            name = f'{mod_name}.{leaf}' if mod_name else leaf
            if isinstance(mod, (nn.Linear, nets.Conv)):
                axes[name] = 0
            elif isinstance(mod, nets.ConvTranspose):
                axes[name] = 1
            else:
                axes[name] = p.ndim - 1
    return axes


def quantize_int8(w: np.ndarray, axis: int):
    """Weight-only int8 with one float32 scale per index of ``axis``, as
    the reference's ``_quantize_int8``: ``scale = absmax / 127 + 1e-12``
    over the other axes, ``codes = clip(rint(w / scale), -127, 127)``.
    Returns (int8 codes, scale shaped to broadcast against ``w``)."""
    w = np.asarray(w, np.float32)
    others = tuple(i for i in range(w.ndim) if i != axis)
    absmax = np.max(np.abs(w), axis=others, keepdims=True)
    scale = (absmax / 127.0 + 1e-12).astype(np.float32)
    codes = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return codes, scale


class _Program(nn.Module):
    """A verb over parameters held as this module's buffers: float32, or
    int8 codes with float32 scales that ``forward`` dequantizes on the
    device. The model is held outside the module tree, so its own
    parameters are not part of the program."""

    def __init__(self, model: nn.Module, verb: str,
                 params: Dict[str, torch.Tensor], quantize: Optional[str],
                 device: torch.device):
        super().__init__()
        self._call = [_VerbCall(model, verb)]
        self.names = list(params)
        axes = _out_axes(model) if quantize else {}
        for i, (name, t) in enumerate(params.items()):
            t = t.detach().to('cpu', torch.float32)
            if name in axes:
                codes, scale = quantize_int8(t.numpy(), axes[name])
                self.register_buffer(f'q{i}', torch.from_numpy(codes).to(
                    device))
                self.register_buffer(f's{i}', torch.from_numpy(scale).to(
                    device))
            else:
                self.register_buffer(f'p{i}', t.to(device))

    def forward(self, x: torch.Tensor):
        params = {}
        for i, name in enumerate(self.names):
            if hasattr(self, f'q{i}'):
                params['model.' + name] = (getattr(self, f'q{i}').to(
                    torch.float32) * getattr(self, f's{i}'))
            else:
                params['model.' + name] = getattr(self, f'p{i}')
        return torch.func.functional_call(self._call[0], params, (x,))


def check_platforms(platforms: Sequence[str]) -> List[str]:
    """``platforms`` as a list of the port's device names, in order,
    without repeats; ``ValueError`` naming ``PLATFORMS`` for any other
    name (``tpu`` among them) or an empty list."""
    names = list(dict.fromkeys(platforms))
    bad = [p for p in names if p not in PLATFORMS]
    if bad or not names:
        raise ValueError(f'unknown platform(s) {bad or names}: an artifact '
                         f'of the port lists some of {",".join(PLATFORMS)}')
    return names


def export_verb(trainer, state, verb: str, device='cuda',
                path: Optional[str] = None, dp_batch: Optional[int] = None,
                quantize: Optional[str] = None,
                platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export one inference verb as ``torch.export`` artifact bytes.

    ``trainer``/``state``: a ``training.Trainer`` and ``TrainState``, as
    every ``api`` verb takes. ``verb``: 'assign' (images -> int32 cluster
    ids [B]), 'probs' (-> [B,K] responsibilities), 'latent' (-> (z [B,D],
    probs [B,K])) or 'reconstruct' (-> [B,H,W,C] likelihood means).
    ``device``: where the artifact runs (the GPU by default; 'cpu' when
    asked).
    ``platforms``: None pins the artifact to ``device``. A list of the
    port's device names (``PLATFORMS``) records where the artifact may
    run: it is traced on ``device`` when that device's type is listed,
    else on the CPU (a host without a card writes an artifact for the
    card), and ``load_program`` moves it to any listed device.
    ``path``: also write the bytes there, with a JSON sidecar at
    ``path + '.json'``. ``quantize='int8'``: every weight with 2 or more
    dims stored as int8 codes with a float32 scale per output channel,
    dequantized on the device at each call.
    ``dp_batch``: None exports a one-device artifact for any batch b >= 1.
    An integer exports a data-parallel artifact for the current process
    group (``parallel.mesh.world()``): a fixed batch of ``dp_batch // world``
    rows a rank, which ``load_and_call`` runs on every rank of a group of
    the same size; ``dp_batch`` must divide by the group's size.

    The artifact's input is float32 ``[b, *image_shape]`` in [0, 1] on its
    device.
    """
    if quantize not in (None, 'int8'):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    _, world = mesh.world()
    if dp_batch is not None and dp_batch % world:
        raise ValueError(f'dp_batch {dp_batch} must divide by the process '
                         f'group\'s size {world}')
    cfg = trainer.cfg
    dev = torch.device(device)
    if platforms is not None:
        platforms = check_platforms(platforms)
        if dev.type not in platforms:
            dev = torch.device('cpu')
    dev = resolve_device(dev)
    prog = _Program(trainer.model, verb, state.params, quantize, dev).eval()
    if dp_batch is None:
        x = torch.zeros(2, *cfg.image_shape, device=dev)
        dynamic = ({0: torch.export.Dim('b', min=1)},)
    else:
        x = torch.zeros(dp_batch // world, *cfg.image_shape, device=dev)
        dynamic = None
    with torch.no_grad():
        exported = torch.export.export(prog, (x,), dynamic_shapes=dynamic)
    # the tracer's stack traces name the exporting host's source files and
    # are the graph's largest metadata; a served program does not read them
    for node in exported.graph.nodes:
        node.meta.pop('stack_trace', None)
    layout = {'dp_batch': dp_batch,
              'world_size': world if dp_batch is not None else 1,
              'device': dev.type}
    if platforms is not None:
        layout['platforms'] = platforms
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={_META: json.dumps(layout)})
    blob = buf.getvalue()
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, 'wb') as f:
            f.write(blob)
        meta = {
            'verb': verb,
            'config': cfg.name,
            'model_family': cfg.model_family,
            'image_shape': list(cfg.image_shape),
            'n_components': cfg.n_components,
            'trained_step': int(state.step),
            **layout,
            'quantize': quantize,
            'device': str(dev),
            'torch_version': torch.__version__,
        }
        with open(path + '.json', 'w') as f:
            json.dump(meta, f, indent=1)
    return blob


def _read_layout(src) -> dict:
    """The artifact's layout record (``_META`` in its archive), read
    without loading the program; an artifact without one is a one-device
    program. ``platforms`` is None where the artifact lists no devices."""
    with zipfile.ZipFile(src) as z:
        names = [n for n in z.namelist() if n.endswith('extra/' + _META)]
        layout = json.loads(z.read(names[0])) if names else {}
    if not isinstance(src, str):
        src.seek(0)
    return {'dp_batch': None, 'world_size': 1, 'platforms': None, **layout}


class Program:
    """An artifact loaded once (``load_program``): call it on float32
    ``[b, *image_shape]`` images in [0, 1] as many times as needed.

    ``spec``: the input shape it takes, ``None`` where a dimension is
    symbolic (any batch of a one-device artifact); a data-parallel
    artifact takes its whole ``dp_batch``. ``layout``: its data-parallel
    record. ``device``: where its inputs go."""

    def __init__(self, exported, layout: dict, device: torch.device):
        self.module = exported.module()
        self.layout, self.device = layout, device
        user = exported.graph_signature.user_inputs[0]
        shape = next(n for n in exported.graph.nodes
                     if n.op == 'placeholder' and n.name == user
                     ).meta['val'].shape
        spec = [s if isinstance(s, int) else None for s in shape]
        if layout['dp_batch'] is not None:
            spec[0] = layout['dp_batch']
        self.spec = tuple(spec)

    def __call__(self, x: np.ndarray):
        """The verb on ``x``: numpy arrays (a tuple for 'latent'). A
        data-parallel artifact runs on every rank of a process group of
        the size it was exported for, each rank on its contiguous slice of
        the same ``x``; the slices are gathered, so every rank returns the
        whole batch's answer."""
        with span('gmvae.serve.call'):
            x = np.ascontiguousarray(x, np.float32)
            dp_batch = self.layout['dp_batch']
            if dp_batch is not None:
                rank, world = mesh.world()
                if (world != self.layout['world_size']
                        or x.shape[0] != dp_batch):
                    raise ValueError(
                        f'a data-parallel artifact for '
                        f'{self.layout["world_size"]} rank(s) and batch '
                        f'{dp_batch}, called with a group of {world} and a '
                        f'batch of {x.shape[0]}')
                b = dp_batch // world
                x = x[rank * b:(rank + 1) * b]
            with torch.no_grad():
                x = torch.from_numpy(x).to(self.device)
                with span('gmvae.serve.run'):
                    out = self.module(x)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if dp_batch is not None:
                outs = [mesh.all_gather_rows(o) for o in outs]
            outs = tuple(o.cpu().numpy() for o in outs)
            return outs if isinstance(out, (tuple, list)) else outs[0]


def load_program(blob_or_path, device=None) -> Program:
    """Load an artifact (bytes or a path) once, for many calls, on
    ``device``.

    An artifact that lists devices (``export_verb``'s ``platforms``) runs
    on any of them: by default the card when it lists ``cuda`` and this
    host has one, else the CPU when listed (a ``cuda``-only artifact on a
    host without a card raises ``resolve_device``'s error), whatever the
    list's order. Where that is not the device it was traced on,
    ``move_to_device_pass`` moves its weights and graph there. A device it does not list is refused
    (``ValueError`` naming the listed ones). An artifact that lists none
    runs only where it was exported (the default), and refuses another
    device the same way. A card artifact needs a card here
    (``training.resolve_device``'s error otherwise)."""
    if isinstance(blob_or_path, (bytes, bytearray)):
        src = io.BytesIO(bytes(blob_or_path))
    elif isinstance(blob_or_path, str):
        src = blob_or_path
    else:
        raise TypeError(type(blob_or_path))
    layout = _read_layout(src)
    traced = layout.get('device')
    listed = layout['platforms'] or ([traced] if traced else None)
    if device is not None:
        dev = torch.device(device)
    elif layout['platforms']:
        card = 'cuda' in listed and torch.cuda.is_available()
        dev = torch.device('cuda' if card or 'cpu' not in listed else 'cpu')
    else:
        dev = torch.device(traced) if traced else None
    if dev is not None:
        if listed and dev.type not in listed:
            raise ValueError(
                f'this artifact runs on {",".join(listed)}, not on '
                f'{dev.type}' + ('' if layout['platforms'] else
                                 ' (exported without platforms)'))
        resolve_device(dev)
    exported = torch.export.load(src)
    if dev is None:   # no record: where its weights are
        dev = next(iter(exported.state_dict.values())).device
    elif traced and dev.type != traced:
        exported = move_to_device_pass(exported, dev)
    return Program(exported, layout, dev)


def load_and_call(blob_or_path, x: np.ndarray, device=None):
    """Load an artifact (bytes or a path) and run it on ``x`` (float32
    [b, *image_shape] in [0, 1]); returns numpy arrays (a tuple for
    'latent'). The program runs on ``device`` (``load_program``'s rule:
    by default where it was exported, or for an artifact that lists
    devices the card when listed and present, else the CPU).

    A data-parallel artifact needs a process group of the size it was
    exported for and ``x`` of its ``dp_batch`` rows, the same on every
    rank: each rank runs its contiguous slice and the slices are gathered,
    so every rank returns the whole batch's answer."""
    return load_program(blob_or_path, device)(x)
