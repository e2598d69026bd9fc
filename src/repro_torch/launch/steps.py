"""The training and serving steps of the LM substrate, the placed train
step, and the input specs and shardings of every arch x shape cell -- the
PyTorch counterpart of the JAX package's ``launch/steps.py``.

The step's loss is the streaming cross-entropy ``lse - gold`` over the
text positions, with the logits upcast to f32 inside the log-sum-exp, plus
the MoE auxiliary terms (zero for the other families).  The model's extra
inputs ride in the batch: ``image_embeds`` for a VLM, ``frames`` for an
encoder-decoder.  Gradients accumulate in f32 over
``n_micro`` micro-batches, are clipped to a global norm, and feed AdamW
under the learning-rate schedule ``lr_fn(step count)``.

The port's parameters live in the model, so the step updates the model and
the optimiser state in place, and the serving steps take no parameters.
The decode step's greedy token is the ``argmax`` of the last position's
logits (the first of equal maxima), as int32.

Placement (the JAX package lowers the step with in/out shardings and lets
GSPMD partition it; there is no GSPMD here): ``input_specs``,
``batch_logical``, ``abstract_opt_state`` and ``all_shardings`` resolve a
cell's placement on ``meta`` tensors, and ``make_placed_train_step`` runs
a step over placed parameters.  The mesh shards the parameters' and the
optimiser's storage by their resolved specs, and each position steps
AdamW on its own shards.  The products run in one of two layouts
(``train_step.layout``):

  * ``"tensor"``, under an ambient mesh (``launch.mesh.mesh_context``),
    for the attention-and-MLP decoders: the JAX package's activation
    layout (``parallel/tensor.py``).  Every position computes on its own
    parameter shards, the model axis joined by collectives (with
    ``seqshard``, the residual stream's sequence split over it too).  The
    loss is averaged over the data positions; each shard's gradient is
    summed over the data positions, and the copies of a leaf the model
    axis does not split (norm scales, biases, fallbacks) summed over the
    model positions too, so the applied gradient is the one-device
    gradient; the global norm counts each distinct shard once.
  * ``"storage"``, without an ambient mesh (or on a model axis of 1 for
    the families the tensor layout does not cover), ZeRO-3/FSDP style: a
    step gathers each parameter whole at one position a data index
    (coordinate 0 of the other mesh axes), runs the unchanged
    :func:`lm_loss` there on that index's rows of the batch, sums the
    gradients over the data positions (``psum``), clips them by the
    global norm of the whole gradients and sends each position its shard
    (``scatter``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import current_mesh, mesh_context
from repro_torch.models.layers import lm_objective, span, xent_parts
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.optim.adamw import OptState
from repro_torch.optim.grad import sum_of_squares
from repro_torch.parallel import collectives
from repro_torch.parallel import tensor as TP
from repro_torch.parallel.collectives import Note, PositionGroup
from repro_torch.parallel.placement import (
    NamedSharding,
    PlacedTensor,
    device_put,
    gather,
)
from repro_torch.parallel.sharding import activation_context, logical_to_spec
from repro_torch.runtime.elastic import specs_for_mesh, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "lm_loss", "model_extras", "input_specs", "batch_specs",
           "batch_logical", "abstract_opt_state", "all_shardings",
           "cell_shardings", "make_placed_train_step"]


# ----------------------------------------------------------------------
# input specs
# ----------------------------------------------------------------------


def batch_specs(cfg, kind: str, batch: int, seq: int) -> dict:
    """``meta`` tensors of a step's inputs (no allocation): ``tokens``
    and ``labels`` (B, S) int32 to train, ``tokens`` to prefill,
    ``tokens`` (B, 1) and ``pos`` (B,) to decode; a VLM's
    ``image_embeds`` and an encoder-decoder's ``frames`` (bf16) outside
    decode."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    out = {}
    if kind == "train":
        out["tokens"] = meta((batch, seq), i32)
        out["labels"] = meta((batch, seq), i32)
    elif kind == "prefill":
        out["tokens"] = meta((batch, seq), i32)
    elif kind == "decode":
        out["tokens"] = meta((batch, 1), i32)
        out["pos"] = meta((batch,), i32)
    else:
        raise ValueError(kind)
    if cfg.vlm_patches and kind != "decode":
        out["image_embeds"] = meta((batch, cfg.vlm_patches, cfg.d_model),
                                   bf16)
    if cfg.enc_dec and kind != "decode":
        out["frames"] = meta((batch, cfg.enc_frames, cfg.d_model), bf16)
    return out


def input_specs(arch: str, shape_id: str, *, smoke: bool = False) -> dict:
    """The cell's model inputs as ``meta`` tensors (the JAX package's
    ``ShapeDtypeStruct``\\ s)."""
    sh = SHAPES[shape_id]
    return batch_specs(get_config(arch, smoke), sh["kind"], sh["batch"],
                       sh["seq"])


def _batch_axes(specs: dict) -> dict:
    return {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in specs.items()}


def batch_logical(arch: str, shape_id: str, *, smoke: bool = False) -> dict:
    """Logical axes congruent with :func:`input_specs`: rows on
    ``"batch"``."""
    return _batch_axes(input_specs(arch, shape_id, smoke=smoke))


def model_extras(cfg, batch) -> dict:
    """The keyword inputs ``model.apply`` takes from ``batch`` beside the
    tokens: ``image_embeds`` (VLM), ``frames`` (encoder-decoder)."""
    kw = {}
    if cfg.vlm_patches and "image_embeds" in batch:
        kw["image_embeds"] = batch["image_embeds"]
    if cfg.enc_dec and "frames" in batch:
        kw["frames"] = batch["frames"]
    return kw


def lm_loss(model, cfg, batch):
    """(loss, (nll, aux)) of one batch: ``tokens`` and ``labels``, (B, S)
    int tensors on the model's device, and the extras of
    :func:`model_extras`."""
    logits, aux = model.apply(batch["tokens"], **model_extras(cfg, batch))
    labels = batch["labels"].long()
    # a VLM's prefix comes first
    lse, gold = xent_parts(logits[:, -labels.shape[1]:], labels)
    loss, nll = lm_objective(lse, gold, aux, cfg.moe_aux_weight)
    return loss, (nll, aux)


def _split_rows(v, n_micro: int):
    """``v``'s micro-batches on dim 0; a list (one tensor a position)
    gives one list a micro-batch."""
    if isinstance(v, list):
        return [list(p) for p in zip(*(torch.chunk(x, n_micro, dim=0)
                                        for x in v))]
    return torch.chunk(v, n_micro, dim=0)


def _accumulate(grad_fn, batch, n_micro):
    """``grad_fn(batch) -> (loss, nll, aux, grads)`` over ``n_micro``
    micro-batches of ``batch`` (tensors, or lists of one tensor a
    position): the gradients accumulate in f32 and everything is
    averaged.  One micro-batch is ``grad_fn(batch)`` as it is."""
    if n_micro == 1:
        return grad_fn(batch)
    micro = {k: _split_rows(v, n_micro) for k, v in batch.items()}
    acc = None
    loss = nll = aux = 0.0
    for i in range(n_micro):
        l, nl, a, g = grad_fn({k: v[i] for k, v in micro.items()})
        if acc is None:
            acc = [gi.float() for gi in g]
        else:
            for a_i, g_i in zip(acc, g):
                a_i += g_i.float()
        loss, nll, aux = loss + l, nll + nl, aux + a
    inv = 1.0 / n_micro
    return loss * inv, nll * inv, aux * inv, [g * inv for g in acc]


def _step_grads(model, cfg, leaves, batch, n_micro):
    """(loss, nll, aux, grads) of one batch, the gradients of ``leaves``
    (the model's parameter tensors, in order), over ``n_micro``
    micro-batches (:func:`_accumulate`)."""

    def grad_fn(mb):
        loss, (nll, aux) = lm_loss(model, cfg, mb)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), nll.detach(), aux.detach(), grads

    return _accumulate(grad_fn, batch, n_micro)


def make_train_step(model, cfg, *, lr_fn, grad_clip: float = 1.0,
                    weight_decay: float = 0.1, n_micro: int = 1):
    """``train_step(opt, batch) -> metrics``: one optimiser step on
    ``model``'s parameters and ``opt`` (an :class:`OptState` from
    ``adamw_init(dict(model.named_parameters()))``), both in place.

    ``batch`` holds ``tokens`` and ``labels`` on the model's device, and
    the model's extras (``image_embeds``, ``frames``).
    ``n_micro > 1`` splits the batch on dim 0 and accumulates the
    gradients in f32 (the same mathematics at 1/n_micro of the live
    activations).  The metrics are 0-d tensors on the device: ``loss``,
    ``nll``, ``grad_norm``, ``lr``, ``aux_load``, ``aux_z``.
    """
    params = dict(model.named_parameters())
    names, leaves = list(params), list(params.values())

    def train_step(opt: OptState, batch):
        loss, nll, aux, grads = _step_grads(model, cfg, leaves, batch,
                                            n_micro)
        grads = dict(zip(names, grads))
        with span("optim.update"):
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            lr = lr_fn(opt.count)
            adamw_update(grads, opt, params, lr=lr,
                         weight_decay=weight_decay)
        return {"loss": loss, "nll": nll, "grad_norm": gnorm, "lr": lr,
                "aux_load": aux[0], "aux_z": aux[1]}

    return train_step


def make_prefill_step(model, cfg, *, max_len=None):
    """``prefill_step(batch) -> (logits, cache)``: ``model.prefill`` over
    ``batch["tokens"]`` and the model's extras, the caches sized for
    ``max_len`` positions."""

    def prefill_step(batch):
        return model.prefill(batch["tokens"], max_len=max_len,
                             **model_extras(cfg, batch))

    return prefill_step


def make_decode_step(model, cfg):
    """``decode_step(cache, batch) -> (next_tok (B,) int32, logits, cache)``
    for ``batch`` = {``tokens`` (B, 1), ``pos`` (B,)}: one
    ``model.decode_step`` and its greedy next token."""

    def decode_step(cache, batch):
        logits, cache = model.decode_step(cache, batch["tokens"],
                                          batch["pos"])
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step


# ----------------------------------------------------------------------
# the placed train step
# ----------------------------------------------------------------------


def _meta_twin(model):
    """``model`` when it is on the ``meta`` device, else a ``meta`` model
    of its config and shapes: the module tree a placed step binds its
    gathered parameters into."""
    if model.device.type == "meta":
        return model
    kw = ({"max_dec_len": model.dec_pos.shape[0]} if model.cfg.enc_dec
          else {})
    return type(model)(model.cfg, device="meta", **kw)


def _bind(model, tensors: dict) -> None:
    """Point each named parameter slot of ``model`` at a tensor."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = t


def _data_positions(mesh, rules) -> list:
    """The compute positions of a placed step: one a data index -- every
    coordinate of the mesh axes ``"batch"`` maps to, in the order the
    batch's rows are split over them -- at coordinate 0 of the others."""
    spec = logical_to_spec(("batch",), None, mesh, rules=rules)
    data = spec[0]
    data = (data,) if isinstance(data, str) else tuple(data or ())
    coords = []
    for idx in np.ndindex(*(mesh.shape[a] for a in data)):
        at = dict(zip(data, idx))
        coords.append(tuple(at.get(a, 0) for a in mesh.axis_names))
    return coords


def make_placed_train_step(model, cfg, *, mesh, lr_fn, params=None,
                           shardings=None, grad_clip: float = 1.0,
                           weight_decay: float = 0.1, n_micro: int = 1):
    """``train_step(opt, batch) -> metrics`` over parameters placed on
    ``mesh`` (the module docstring has both layouts).

    Built under ``mesh_context(mesh)`` the step runs the tensor layout
    (``train_step.layout == "tensor"``); a family the layout does not
    cover raises ``NotImplementedError`` there when the mesh's model axis
    is above 1, and a different ambient mesh raises ``ValueError``.  Built
    without one it runs the storage schedule (``"storage"``).

    ``params`` (name -> tensor or :class:`PlacedTensor`; ``model``'s own
    parameters when None) are placed by ``shardings`` (name ->
    :class:`NamedSharding`; resolved from the parameters' logical axes
    and ``cfg.rules`` when None) and held as ``train_step.params``; the
    optimiser state is ``adamw_init(train_step.params)``.  ``model`` gives
    the module tree and may be a ``meta`` model: the step runs a ``meta``
    twin of it, with each position's parameters bound in (storage) or
    passed as views (tensor).  ``batch`` holds the global batch (tensors
    on any device, placed here by ``"batch"`` on dim 0) or placed
    tensors; its rows must split evenly over the data positions.

    A mesh whose devices are not all of one type (all CUDA, all host, or
    all ``meta``) raises ``ValueError``.  On a mesh of one position the
    step is the plain one: the same gradients, norm and update, bit for
    bit.  The metrics are :func:`make_train_step`'s: the loss, nll and
    aux terms averaged over the data positions, the global grad norm.
    ``train_step.communicate(batch)`` issues (storage) or counts (tensor)
    the step's collectives alone, for the dry run.
    """
    kinds = {d.type for d in mesh.devices.flat}
    if len(kinds) != 1:
        raise ValueError(f"a placed step needs one device type on the "
                         f"mesh, not {sorted(kinds)}")
    ambient = current_mesh()
    if ambient is not None and ambient != mesh:
        raise ValueError("the ambient mesh is not the step's mesh")
    tensor = ambient is not None and (TP.model_size(mesh) > 1
                                      or TP.unported(cfg) is None)
    names = [n for n, _ in model.named_parameters()]
    logical = {n: p.logical for n, p in model.named_parameters()}
    values = dict(model.named_parameters()) if params is None else params
    if shardings is None:
        shardings = specs_for_mesh(logical, values, mesh, cfg.rules)
    twin = _meta_twin(model)
    coords = _data_positions(mesh, cfg.rules)
    layout = (TP.TensorLayout(twin, cfg, mesh, shardings, coords)
              if tensor else None)
    placed = {n: device_put(values[n], shardings[n]) for n in names}
    source = coords[0]
    reducer = mesh.devices[source]

    def place_batch(batch):
        out = {}
        for k, v in batch.items():
            if not isinstance(v, PlacedTensor):
                spec = logical_to_spec(("batch",) + (None,) * (v.dim() - 1),
                                       tuple(v.shape), mesh,
                                       rules=cfg.rules, name=k)
                if len(coords) > 1 and spec[0] is None:
                    raise ValueError(f"batch {k!r}: {v.shape[0]} rows do "
                                     f"not split over {len(coords)} data "
                                     f"positions")
                v = device_put(v, NamedSharding(mesh, spec))
            out[k] = v
        return out

    def reduced(parts, what="metrics"):
        """The positions' tensors summed onto the first compute position
        and averaged (one position: its tensor as it is)."""
        if len(parts) == 1:
            return parts[0]
        with collectives.part(what):
            return collectives.psum(parts, device=reducer) * (
                1.0 / len(parts))

    if layout is not None:
        step = _tensor_step(twin, cfg, mesh, layout, placed, place_batch,
                            reduced, source, lr_fn=lr_fn,
                            grad_clip=grad_clip, weight_decay=weight_decay,
                            n_micro=n_micro)
    else:
        step = _storage_step(twin, cfg, mesh, names, placed, coords,
                             place_batch, reduced, lr_fn=lr_fn,
                             grad_clip=grad_clip, weight_decay=weight_decay,
                             n_micro=n_micro)
    step.params = placed
    step.data_positions = coords
    step.layout = "tensor" if layout is not None else "storage"
    return step


def _storage_step(twin, cfg, mesh, names, placed, coords, place_batch,
                  reduced, *, lr_fn, grad_clip, weight_decay, n_micro):
    """The storage schedule (ZeRO-3/FSDP style; the module docstring)."""
    empty = dict(twin.named_parameters())
    source = coords[0]

    def gathered(coord):
        """Each parameter whole at the compute position ``coord``."""
        dev = mesh.devices[coord]
        at = dict(zip(mesh.axis_names, coord))
        with collectives.part("parameters"):
            return {n: gather(placed[n], dev, at=at) for n in names}

    def scattered(grads):
        """Each position's shard of each whole gradient."""
        out = {}
        with collectives.part("gradients"):
            for n in names:
                p = placed[n]
                out[n] = PlacedTensor(p.sharding, p.shape, grads[n].dtype,
                                      collectives.scatter(
                                          grads[n], p.sharding,
                                          source=source))
        return out

    def summed(parts):
        return reduced(parts, "gradients")

    def train_step(opt: OptState, batch):
        batch = place_batch(batch)
        runs = []
        for coord in coords:
            whole = {n: t.detach().requires_grad_()
                     for n, t in gathered(coord).items()}
            _bind(twin, whole)
            try:
                runs.append(_step_grads(
                    twin, cfg, [whole[n] for n in names],
                    {k: v.shards[coord] for k, v in batch.items()},
                    n_micro))
            finally:
                _bind(twin, empty)
            del whole
        loss, nll, aux = (reduced([r[i] for r in runs]) for i in range(3))
        grads = {n: summed([r[3][j] for r in runs])
                 for j, n in enumerate(names)}
        del runs
        with span("optim.update"):
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            lr = lr_fn(opt.count.shard(source))
            sliced = scattered(grads)
            del grads
            adamw_update(sliced, opt, placed, lr=lr,
                         weight_decay=weight_decay)
        return {"loss": loss, "nll": nll, "grad_norm": gnorm, "lr": lr,
                "aux_load": aux[0], "aux_z": aux[1]}

    def communicate(batch):
        """The step's collectives alone, on shape-only gradients (a
        ``meta`` mesh): the gathers at every compute position, the
        gradient sum and the scatter, with no product and no update --
        what the dry run counts (``launch/dryrun.py``)."""
        place_batch(batch)

        def blank(shape, dtype, c):
            return torch.empty(shape, dtype=dtype, device=mesh.devices[c])

        for coord in coords:
            gathered(coord)
        for shape in ((), (), (2,)):  # loss, nll, aux
            reduced([blank(shape, torch.float32, c) for c in coords])
        scattered({n: summed([blank(placed[n].shape, placed[n].dtype, c)
                              for c in coords]) for n in names})

    train_step.communicate = communicate
    return train_step


def _tensor_step(twin, cfg, mesh, layout, placed, place_batch, reduced,
                 source, *, lr_fn, grad_clip, weight_decay, n_micro):
    """The tensor layout (the module docstring; ``parallel/tensor.py``)."""
    names = layout.names
    rows = layout.groups
    every = [c for row in rows for c in row]
    n_data, t = len(rows), layout.t

    def shape_of(batch):
        """(global rows, positions a row, text positions)."""
        b, text = batch["tokens"].shape
        seq = text + (cfg.vlm_patches if cfg.vlm_patches
                      and "image_embeds" in batch else 0)
        return b, seq, text

    def group_grads(row, leaves, batch):
        """(loss, nll, aux, {coord: {name: gradient}}) of one data index's
        positions: the forward and backward over its rows, over
        ``n_micro`` micro-batches (:func:`_accumulate`)."""
        b, seq, _ = shape_of(batch)
        views = [layout.view(leaves[c], c) for c in row]
        group = TP.Group(layout, row, views, batch=b, seq=seq)
        flat = [leaves[c][n] for c in row for n in names]

        def grad_fn(mb):
            # the backward's recompute inside too: it resolves the same
            # activations at their global sizes, once
            with activation_context(layout.sizes(b, seq), cfg.rules):
                logits, aux = twin.apply_tensor(
                    group, mb["tokens"], image_embeds=mb.get("image_embeds"))
                loss, nll = group.loss(logits, mb["labels"], aux)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(flat, grads)]
            return loss.detach(), nll.detach(), aux.detach(), grads

        parts = {k: [v.shards[c] for c in row] for k, v in batch.items()}
        loss, nll, aux, grads = _accumulate(grad_fn, parts, n_micro)
        k = len(names)
        return loss, nll, aux, {c: dict(zip(names, grads[i * k:(i + 1) * k]))
                                for i, c in enumerate(row)}

    def peers(name):
        """The groups of positions a gradient of ``name`` is summed over:
        the data positions of each model index for a split leaf, every
        position for a leaf the model axis does not split."""
        if layout.model_dim[name] is None:
            return [every]
        return [[row[m] for row in rows] for m in range(t)]

    def reduce_grads(grads):
        """Each position's gradient of each leaf summed over its peers,
        averaged over the data positions; ``grads`` is emptied leaf by
        leaf, so one leaf's parts at most are held twice."""
        out = {c: {} for c in every}
        for n in names:
            for cs in peers(n):
                g = PositionGroup(mesh, cs, part="gradients")
                summed = collectives.all_reduce(g, [grads[c].pop(n)
                                                    for c in cs])
                for c, x in zip(cs, summed):
                    out[c][n] = x * (1.0 / n_data) if n_data > 1 else x
        return out

    def owned(coord):
        """The leaves whose gradient norm ``coord`` counts: each distinct
        shard once (data index 0; the first position for unsplit
        leaves)."""
        first = every[0] == coord
        lead = coord in rows[0]
        return [n for n in names
                if (layout.model_dim[n] is None and first)
                or (layout.model_dim[n] is not None and lead)]

    def blocks(grads):
        """Each position's stored block of each gradient, as placed
        tensors shaped like the parameters' storage."""
        out = {}
        for n in names:
            p = placed[n]
            shards = np.empty(p.shards.shape, dtype=object)
            for c in np.ndindex(p.shards.shape):
                g = grads[c][n]
                if layout.other[n]:
                    sl = list(p.sharding.slices(tuple(p.shape), c))
                    if layout.model_dim[n] is not None:
                        sl[layout.model_dim[n]] = slice(None)
                    g = g[tuple(sl)]
                shards[c] = g
            out[n] = PlacedTensor(p.sharding, p.shape, shards.flat[0].dtype,
                                  shards)
        return out

    def train_step(opt: OptState, batch):
        batch = place_batch(batch)
        with mesh_context(mesh):
            leaves = {c: layout.leaves(placed, c) for c in every}
            runs = [group_grads(row, leaves, batch) for row in rows]
            del leaves
            loss, nll, aux = (reduced([r[i] for r in runs])
                              for i in range(3))
            grads = {c: g for r in runs for c, g in r[3].items()}
            del runs
            with span("optim.update"):
                grads = reduce_grads(grads)
                norm = PositionGroup(mesh, every, part="gradients")
                partial = []
                for c in every:
                    mine = {n: grads[c][n] for n in owned(c)}
                    partial.append(sum_of_squares(mine) if mine else
                                   torch.zeros((), dtype=torch.float32,
                                               device=mesh.devices[c]))
                gn = [torch.sqrt(x) for x in
                      collectives.all_reduce(norm, partial)]
                for i, c in enumerate(every):
                    grads[c], _ = clip_by_global_norm(grads[c], grad_clip,
                                                      norm=gn[i])
                lr = lr_fn(opt.count.shard(source))
                sliced = blocks(grads)
                del grads
                adamw_update(sliced, opt, placed, lr=lr,
                             weight_decay=weight_decay)
        return {"loss": loss, "nll": nll, "grad_norm": gn[0], "lr": lr,
                "aux_load": aux[0], "aux_z": aux[1]}

    def communicate(batch):
        """The step's collectives counted, not run (the dry run's: at 256
        ``meta`` positions running them takes minutes): each data
        index's activations (``TensorLayout.activation_notes``), the
        metrics' sums, each leaf's gradient sum over its peers and the
        norm's -- what a step records, note for note.  Parameters split
        over another mesh axis than the model axis are gathered as the
        step gathers them."""
        batch = place_batch(batch)
        b, seq, text = shape_of(batch)
        if any(layout.other.values()):
            for c in every:
                layout.leaves(placed, c)
        seqshard = layout.seqshard(b, seq)
        notes = layout.activation_notes(b // n_data // n_micro, seq, text,
                                        seqshard)
        collectives.record_notes(notes * (n_data * n_micro))

        def blank(shape, c):
            return torch.empty(shape, dtype=torch.float32,
                               device=mesh.devices[c])

        for shape in ((), (), (2,)):  # loss, nll, aux
            reduced([blank(shape, row[0]) for row in rows])
        grad_notes = []
        for n in names:
            for cs in peers(n):
                if len(cs) > 1:
                    grad_notes.append(Note("all-reduce",
                                           layout.grad_bytes(n), len(cs),
                                           "gradients"))
        if len(every) > 1:
            grad_notes.append(Note("all-reduce", 4, len(every), "gradients"))
        collectives.record_notes(grad_notes)

    train_step.communicate = communicate
    return train_step


# ----------------------------------------------------------------------
# a cell's placement
# ----------------------------------------------------------------------


def abstract_opt_state(abstract_params: dict) -> OptState:
    """The optimiser state's shapes on ``meta``: f32 moments beside each
    parameter, an int32 count."""
    def f32(t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")

    return OptState(mu={k: f32(t) for k, t in abstract_params.items()},
                    nu={k: f32(t) for k, t in abstract_params.items()},
                    count=torch.empty((), dtype=torch.int32, device="meta"))


def all_shardings(arch, shape_id, mesh, *, smoke=False, cfg=None) -> dict:
    """The placement of one cell: :class:`NamedSharding`\\ s for the
    parameters, the optimiser state, the batch and (decode) the cache,
    with their ``meta`` stand-ins, under the JAX package's keys.  ``cfg``
    replaces the arch's config (the dry run's knobs)."""
    sh = SHAPES[shape_id]
    return cell_shardings(cfg or get_config(arch, smoke), mesh, sh["kind"],
                          sh["batch"], sh["seq"])


def cell_shardings(cfg, mesh, kind: str, batch: int, seq: int) -> dict:
    """:func:`all_shardings` for a config and a batch of ``batch`` x
    ``seq`` tokens of ``kind`` (``train``, ``prefill``, ``decode``)."""
    model = build_model(cfg, device="meta")
    rules = cfg.rules
    aparams, logical = model.abstract_params()
    param_sh = specs_for_mesh(logical, aparams, mesh, rules)
    aopt = abstract_opt_state(aparams)
    opt_sh = OptState(mu=param_sh, nu=param_sh,
                      count=NamedSharding(mesh, logical_to_spec((), (),
                                                                mesh)))
    specs = batch_specs(cfg, kind, batch, seq)
    blog = _batch_axes(specs)
    batch_sh = {k: NamedSharding(mesh, logical_to_spec(
        blog[k], tuple(specs[k].shape), mesh, rules=rules, name=k))
        for k in specs}
    out = dict(cfg=cfg, model=model, abstract_params=aparams,
               param_sharding=param_sh, abstract_opt=aopt,
               opt_sharding=opt_sh, input_specs=specs,
               batch_sharding=batch_sh)
    if kind == "decode":
        acache = model.abstract_cache(batch, seq)
        clog = model.cache_logical(batch, seq)
        out["abstract_cache"] = acache
        out["cache_sharding"] = tree_map(
            lambda lg, t: NamedSharding(mesh, logical_to_spec(
                lg, tuple(t.shape), mesh, rules=rules, name="cache")),
            clog, acache, is_leaf=lambda t: isinstance(t, tuple))
    return out
