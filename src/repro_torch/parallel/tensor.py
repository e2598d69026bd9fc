"""The tensor layout: Megatron-style tensor parallelism, and with
``seqshard`` sequence parallelism, for the attention-and-MLP decoders --
what the JAX package's ``shard(...)`` constraints make GSPMD do under an
ambient mesh (``RULES``: ``heads``, ``kv_heads``, ``mlp`` and ``vocab``
on ``"model"``; ``seqshard`` adds ``seq_res`` on ``"model"``).

The port has no GSPMD, so the layout is written out: one process drives
every mesh position, each position computes on its own part of every
product, and explicit collectives over the model axis
(``parallel.collectives``: ``all_reduce``, ``all_gather_each``,
``reduce_scatter``, ``all_max``) join the parts.  The placed train step
runs it under ``launch.mesh.mesh_context`` (``launch/steps.py``).

From the parameters' resolved specs (their storage, which does not
change) :class:`TensorLayout` decides which products run split over the
model axis -- a dimension a spec splits over ``"model"`` is split, one its
divisibility fallback left whole is computed whole at every position --
and builds each position's view of the parameters:

  * ``wq``'s heads and the rows of ``wo`` for them (and ``bq``), at the
    heads' global offset, which ``attention._mask_pad_heads`` needs for
    padded heads;
  * the KV heads those query heads read: the position's shard when
    ``kv_heads`` is split, else sliced from the replicated whole; the
    GQA groups must align (a position's query heads cover whole groups,
    or lie in one);
  * the MLP's ``wi``/``wg`` columns and ``wo`` rows;
  * the embedding's (and an untied head's) vocabulary rows.

Dimensions a spec splits over another mesh axis (``rules.embed=data``)
are gathered at the position, as the storage schedule gathers them.

A sublayer whose product is split leaves a partial sum at every
position: without ``seqshard`` an all-reduce joins it into the residual,
which every position holds whole; with ``seqshard`` each position holds
its block of the residual's sequence, normalises it there, all-gathers
the sequence before each mixer and FFN and reduce-scatters their partial
outputs after (the output projection's bias is added once, after the
join).  A sublayer computed whole (a fallback) needs no join.  The
embedding is vocab-parallel: each position looks up the ids in its rows,
masks the others to zero and the parts are joined as a sublayer's output
(a VLM's image prefix, replicated over the model axis, rides on the first
position's part).  The loss is vocab-parallel: the logits (softcapped
first) stay split, the maximum over positions is taken without gradient,
the exp-sums are all-reduced in f32 and the gold logit comes from its
owner -- ``launch.steps.lm_loss``'s ``lse - gold`` on split logits.

Families and layers this slice does not lay out raise
``NotImplementedError`` under a mesh whose model axis is above 1
(:func:`check_scope`), naming the ROADMAP item that ports them; so do
prefill and decode.  A model axis of 1 splits nothing: the layout is then
the plain model at each data position.
"""
from __future__ import annotations

import math
import types

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import current_mesh
from repro_torch.models import layers as L
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import Note, PositionGroup
from repro_torch.parallel.placement import NamedSharding, PlacedTensor, gather
from repro_torch.parallel.sharding import PartitionSpec, logical_to_spec

__all__ = ["TensorLayout", "Group", "check_scope", "unported",
           "model_size", "TENSOR_AXIS", "IN_SCOPE"]

#: the mesh axis the layout splits products over
TENSOR_AXIS = "model"
#: the families whose training forward the layout covers
IN_SCOPE = ("dense", "vlm")
#: the logical axes a parameter may be split over the model axis by
_SPLIT = ("heads", "kv_heads", "mlp", "vocab")

_LATER = {
    "moe": "the MoE's expert layout, ROADMAP.md item 15.7",
    "ssm": "Mamba-2's heads, the RG-LRU's rnn axis and windowed attention, "
           "ROADMAP.md item 15.8",
    "audio": "Whisper's layout, ROADMAP.md item 15.9",
}
_LATER["hybrid"] = _LATER["ssm"]
SERVING_LATER = "prefill and decode under a mesh, ROADMAP.md item 15.10"


def model_size(mesh) -> int:
    """Positions along the model axis (1 without a mesh or that axis)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(TENSOR_AXIS, 1))


def unported(cfg) -> str | None:
    """Why ``cfg``'s training forward has no tensor layout yet (the
    ROADMAP item that ports it), or None when it has one."""
    if cfg.enc_dec or cfg.family == "audio":
        return _LATER["audio"]
    if cfg.family == "moe" or any(s.moe for s in cfg.pattern):
        return _LATER["moe"]
    if cfg.family not in IN_SCOPE or any(
            s.mixer != "attn" or s.window is not None for s in cfg.pattern):
        return _LATER["ssm"]
    return None


def check_scope(cfg, mesh=None, *, serving: bool = False) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` (the ambient mesh when
    None) has a model axis above 1 and ``cfg``'s training forward --
    any prefill or decode, with ``serving`` -- has no layout over it."""
    mesh = current_mesh() if mesh is None else mesh
    t = model_size(mesh)
    if t <= 1:
        return
    why = SERVING_LATER if serving else unported(cfg)
    if why:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) under a mesh with a {t}-way "
            f"model axis: no layout yet -- {why}")


def _entry_axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _view_tree(module, leaves: dict, prefix: str = ""):
    """A namespace mirroring ``module``'s tree, its parameter slots holding
    ``leaves[name]`` (None where the module's slot is None)."""
    ns = types.SimpleNamespace()
    for k, v in vars(module).items():  # optional slots left None
        if v is None and not k.startswith("_"):
            setattr(ns, k, None)
    for k, p in module._parameters.items():
        setattr(ns, k, None if p is None else leaves[prefix + k])
    for k, child in module._modules.items():
        if child is None:
            setattr(ns, k, None)
        elif isinstance(child, torch.nn.ModuleList):
            setattr(ns, k, [_view_tree(c, leaves, f"{prefix}{k}.{i}.")
                            for i, c in enumerate(child)])
        else:
            setattr(ns, k, _view_tree(child, leaves, f"{prefix}{k}."))
    return ns


class TensorLayout:
    """The tensor layout of ``model`` (a ``StackedLM``, e.g. a ``meta``
    twin) on ``mesh``, from the parameters' ``shardings`` (name ->
    ``NamedSharding``).  ``data_coords`` are the compute positions of the
    data indices (coordinate 0 on the model axis); each data index's
    group is its positions along the model axis."""

    def __init__(self, model, cfg, mesh, shardings, data_coords):
        check_scope(cfg, mesh)
        self.cfg, self.mesh, self.model = cfg, mesh, model
        self.t = model_size(mesh)
        names = [n for n, _ in model.named_parameters()]
        self.names = names
        logical = {n: p.logical for n, p in model.named_parameters()}
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.dtypes = {n: p.dtype for n, p in model.named_parameters()}
        batch_axes = set(_entry_axes(logical_to_spec(
            ("batch",), None, mesh, rules=cfg.rules)[0]))
        extra = set(mesh.axis_names) - batch_axes - {TENSOR_AXIS}
        if extra and any(mesh.shape[a] > 1 for a in extra):
            raise NotImplementedError(
                f"the tensor layout runs on mesh axes the batch or the "
                f"model axis use; {sorted(extra)} are neither")
        self.shardings = shardings
        self.model_dim, self.other = {}, {}
        for n in names:
            spec = shardings[n]._entries(len(self.shapes[n]))
            dim = None
            for i, entry in enumerate(spec):
                axes = _entry_axes(entry)
                if TENSOR_AXIS not in axes:
                    continue
                if len(axes) > 1 or logical[n][i] not in _SPLIT:
                    raise NotImplementedError(
                        f"{n}: the tensor layout splits only "
                        f"{'/'.join(_SPLIT)} over {TENSOR_AXIS!r}, alone; "
                        f"its spec is {shardings[n].spec}")
                dim = i
            self.model_dim[n] = dim
            self.other[n] = any(a != TENSOR_AXIS for e in spec
                                for a in _entry_axes(e))
        self.groups = []
        mi = (mesh.axis_names.index(TENSOR_AXIS)
              if TENSOR_AXIS in mesh.axis_names else None)
        for c in data_coords:
            row = []
            for m in range(self.t):
                c2 = list(c)
                if mi is not None:
                    c2[mi] = m
                row.append(tuple(c2))
            self.groups.append(row)
        c = cfg
        first = "layers.0."
        self.split = {
            "attn": self.model_dim.get(first + "attn.wq") is not None,
            "kv": self.model_dim.get(first + "attn.wk") is not None,
            "mlp": self.model_dim.get(first + "ffn.wi") is not None,
            "vocab": self.model_dim["embed"] is not None,
        }
        if not c.tie_embed and (self.model_dim["head"] is not None) != \
                self.split["vocab"]:
            raise NotImplementedError("an untied head split otherwise than "
                                      "the embedding")
        self.heads, self.kv = c.hq_padded, c.n_kv
        self.hloc = self.heads // self.t if self.split["attn"] else self.heads
        group = self.heads // self.kv
        if self.split["attn"] and not self.split["kv"] and not (
                self.hloc % group == 0 or group % self.hloc == 0):
            raise NotImplementedError(
                f"{c.name}: {self.hloc} query heads a position do not "
                f"align with GQA groups of {group}")
        self.vloc = c.vocab // self.t if self.split["vocab"] else c.vocab

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------
    def seqshard(self, batch: int, seq: int) -> bool:
        """Whether the residual stream's sequence is split over the model
        axis for a global batch of ``batch`` rows of ``seq`` positions:
        ``seq_res`` resolved as the JAX package resolves it (a sequence
        the model axis does not divide stays whole, logged)."""
        spec = logical_to_spec(("batch", "seq_res", "embed"),
                               (batch, seq, self.cfg.d_model), self.mesh,
                               rules=self.cfg.rules, name="act")
        axes = _entry_axes(spec[1])
        if axes and axes != (TENSOR_AXIS,):
            raise NotImplementedError(f"seq_res on {axes}: the layout splits "
                                      f"the sequence over {TENSOR_AXIS!r}")
        return self.t > 1 and axes == (TENSOR_AXIS,)

    def sizes(self, batch: int, seq: int) -> dict:
        """The global size of each logical axis, for ``shard``'s
        resolution of a position's part."""
        c = self.cfg
        return {"batch": batch, "seq": seq, "seq_res": seq,
                "heads": self.heads, "kv_heads": self.kv, "mlp": c.d_ff,
                "vocab": c.vocab, "embed": c.d_model}

    # ------------------------------------------------------------------
    # each position's parameters
    # ------------------------------------------------------------------
    def _model_index(self, coord) -> int:
        if TENSOR_AXIS not in self.mesh.axis_names:
            return 0
        return coord[self.mesh.axis_names.index(TENSOR_AXIS)]

    def _gathered(self, placed: PlacedTensor, coord) -> torch.Tensor:
        """The position's model block of ``placed``, whole over every
        other mesh axis, gathered onto its device."""
        sh = placed.sharding
        spec = sh._entries(placed.ndim)
        keep = [e if TENSOR_AXIS not in _entry_axes(e) else None
                for e in spec]
        dim = next((i for i, e in enumerate(spec)
                    if TENSOR_AXIS in _entry_axes(e)), None)
        shape = list(placed.shape)
        mi = self.mesh.axis_names.index(TENSOR_AXIS) \
            if dim is not None else None
        if dim is not None:
            shape[dim] //= self.t
        sub = np.empty(placed.shards.shape, dtype=object)
        for c in np.ndindex(placed.shards.shape):
            c2 = list(c)
            if mi is not None:
                c2[mi] = coord[mi]
            sub[c] = placed.shards[tuple(c2)]
        part = PlacedTensor(NamedSharding(self.mesh, PartitionSpec(*keep)),
                            torch.Size(shape), placed.dtype, sub)
        at = dict(zip(self.mesh.axis_names, coord))
        return gather(part, self.mesh.devices[coord], at=at)

    def leaves(self, placed: dict, coord) -> dict:
        """name -> the position's leaf tensor of each parameter (its
        stored shard, or its model block gathered over the other axes),
        detached and requiring a gradient."""
        out = {}
        for n in self.names:
            p = placed[n]
            t = (self._gathered(p, coord) if self.other[n]
                 else p.shards[coord])
            out[n] = t.detach().requires_grad_()
        return out

    def view(self, leaves: dict, coord):
        """The position's view of the model: a namespace tree of the
        model's modules holding ``leaves``, with each attention view's KV
        heads sliced to those its query heads read, its ``head_offset``,
        and its output bias moved to ``attn_bo`` (added after the
        join)."""
        m = self._model_index(coord)
        tree = _view_tree(self.model, leaves)
        h0 = m * self.hloc if self.split["attn"] else 0
        group = self.heads // self.kv
        lo = hi = None
        if self.split["attn"] and not self.split["kv"]:
            lo, hi = h0 // group, (h0 + self.hloc - 1) // group + 1
        for lv in tree.layers:
            a = lv.attn
            a.head_offset = h0
            if lo is not None:
                a.wk, a.wv = a.wk[:, lo:hi], a.wv[:, lo:hi]
                if a.bk is not None:
                    a.bk, a.bv = a.bk[lo:hi], a.bv[lo:hi]
            lv.attn_bo, a.bo = a.bo, None
        tree.vocab0 = m * self.vloc if self.split["vocab"] else 0
        return tree

    # ------------------------------------------------------------------
    # the step's collectives, counted
    # ------------------------------------------------------------------
    def grad_bytes(self, name: str) -> int:
        """Bytes of a position's gradient of ``name`` (its model block,
        whole over the other axes)."""
        shape = list(self.shapes[name])
        if self.model_dim[name] is not None:
            shape[self.model_dim[name]] //= self.t
        return int(np.prod(shape, dtype=np.int64)) * \
            self.dtypes[name].itemsize

    def activation_notes(self, rows: int, seq: int, text: int,
                         seqshard: bool) -> list:
        """The :class:`Note`\\ s one data group's forward and backward
        record for ``rows`` rows of ``seq`` positions (``text`` of them
        scored), in no particular order: the embedding's join, each
        sublayer's gather and join (twice forward in a remat period: the
        recompute), the logits' gather, the loss's three all-reduces and
        the backward's duals."""
        c, t = self.cfg, self.t
        if t == 1:
            return []
        n = rows * seq * c.d_model * c.compute_dtype.itemsize
        fwd_kind = "reduce-scatter" if seqshard else "all-reduce"
        bwd_kind = "all-gather" if seqshard else "all-reduce"

        def act(kind):
            return Note(kind, n, t, "activations")

        out = []
        if self.split["vocab"]:
            out += [act(fwd_kind), act(bwd_kind)]
        if seqshard:
            out += [act("all-gather"), act("reduce-scatter")]  # logits
        subs = []
        for spec in c.pattern:
            subs.append("attn")
            if spec.mlp:
                subs.append("mlp")
        per_fwd, per_bwd = [], []
        for sub in subs:
            if seqshard:
                per_fwd.append(act("all-gather"))
                per_bwd.append(act("reduce-scatter"))
            if self.split[sub]:
                per_fwd.append(act(fwd_kind))
                per_bwd.append(act(bwd_kind))
        runs = 2 if c.remat is not None else 1
        out += (per_fwd * runs + per_bwd) * c.n_periods
        tail = []
        for spec in c.tail_specs:
            for sub in ("attn", "mlp") if spec.mlp else ("attn",):
                if seqshard:
                    tail += [act("all-gather"), act("reduce-scatter")]
                if self.split[sub]:
                    tail += [act(fwd_kind), act(bwd_kind)]
        out += tail
        if self.split["vocab"]:
            nl = rows * text * 4
            out += [Note("all-reduce", nl, t, "loss")] * 5
        return out


class Group:
    """One data index's positions along the model axis, with their views
    of the parameters, for one batch of ``batch`` global rows of ``seq``
    positions: the joins, the vocab-parallel embedding, logits and loss
    that ``StackedLM.apply_tensor`` runs."""

    def __init__(self, layout: TensorLayout, coords, views, *, batch: int,
                 seq: int):
        self.layout, self.cfg = layout, layout.cfg
        self.coords, self.views = coords, views
        self.size = len(coords)
        self.devices = [layout.mesh.devices[c] for c in coords]
        self.act = PositionGroup(layout.mesh, coords, part="activations")
        self.red = PositionGroup(layout.mesh, coords, part="loss")
        self.split = layout.split
        self.seqshard = layout.seqshard(batch, seq)

    # ------------------------------------------------------------------
    # the residual stream's joins
    # ------------------------------------------------------------------
    def to_mixer(self, hs: list) -> list:
        """A sublayer's input at every position: the whole sequence (an
        all-gather of the blocks under ``seqshard``)."""
        if not self.seqshard:
            return hs
        return collectives.all_gather_each(self.act, hs, 1)

    def join(self, outs: list, partial: bool) -> list:
        """A sublayer's outputs in the residual's layout: partial sums
        all-reduced (reduce-scattered over the sequence under
        ``seqshard``); whole outputs kept (each position's block under
        ``seqshard``)."""
        if partial and self.size > 1:
            if self.seqshard:
                return collectives.reduce_scatter(self.act, outs, 1)
            return collectives.all_reduce(self.act, outs)
        if not self.seqshard:
            return outs
        k = outs[0].shape[1] // self.size
        return [o[:, m * k:(m + 1) * k] for m, o in enumerate(outs)]

    # ------------------------------------------------------------------
    # embedding, logits, loss
    # ------------------------------------------------------------------
    def embed(self, tokens: list, extra: list | None) -> list:
        """The residual stream's input at each position: the ids looked up
        in the position's vocabulary rows (the others masked to zero) and
        joined, a VLM's image prefix before them."""
        c, lay = self.cfg, self.layout
        cd = c.compute_dtype
        parts = []
        for m, (v, tok) in enumerate(zip(self.views, tokens)):
            table = v.embed.to(cd)
            if self.split["vocab"]:
                local = tok.long() - v.vocab0
                own = (local >= 0) & (local < lay.vloc)
                x = F.embedding(local.clamp(0, lay.vloc - 1), table)
                x = x * own[..., None].to(x.dtype)
            else:
                x = F.embedding(tok, table)
            if c.embed_scale:
                x = x * torch.tensor(math.sqrt(c.d_model), dtype=x.dtype,
                                     device=x.device)
            if c.vlm_patches and extra is not None:
                pre = extra[m].to(cd)
                if self.split["vocab"] and m > 0:
                    pre = torch.zeros_like(pre)
                x = torch.cat([pre, x], dim=1)
            parts.append(x)
        return self.join(parts, self.split["vocab"])

    def logits(self, norm, xs: list) -> list:
        """Each position's logits over its vocabulary rows, in the compute
        dtype, the softcap applied; ``norm(view, x)`` is the model's final
        norm.  A vocabulary the model axis does not split is scored whole
        at the first position alone (None at the others): the loss reads
        that one."""
        c = self.cfg
        cd = c.compute_dtype
        with L.span("logits"):
            hs = self.to_mixer([norm(v.final_norm, x)
                                for v, x in zip(self.views, xs)])
            out = []
            for m, (v, h) in enumerate(zip(self.views, hs)):
                if m > 0 and not self.split["vocab"]:
                    out.append(None)
                    continue
                w = v.embed.T if c.tie_embed else v.head
                lg = L.dense(h.to(cd), w.to(cd))
                if c.logit_softcap:
                    lg = torch.tanh(lg / c.logit_softcap) * c.logit_softcap
                out.append(lg.to(cd))
            return out

    def loss(self, logits: list, labels: list, aux):
        """(loss, nll) at the first position: ``launch.steps.lm_loss`` on
        the positions' logits, vocab-parallel when they are split."""
        n = labels[0].shape[1]
        if not self.split["vocab"] or self.size == 1:
            lse, gold = L.xent_parts(logits[0][:, -n:], labels[0].long())
        else:
            lay = self.layout
            lgs = [lg[:, -n:] for lg in logits]
            lfs = [lg.float() for lg in lgs]
            mx = collectives.all_max(self.red,
                                     [torch.amax(x, dim=-1) for x in lfs])
            se = collectives.all_reduce(self.red, [
                torch.sum(torch.exp(x - m[..., None]), dim=-1)
                for x, m in zip(lfs, mx)])
            lse = torch.log(se[0]) + mx[0]
            golds = []
            for v, lg, lab in zip(self.views, lgs, labels):
                local = lab.long() - v.vocab0
                own = (local >= 0) & (local < lay.vloc)
                g = torch.gather(lg, -1, local.clamp(0, lay.vloc - 1)[
                    ..., None])[..., 0].float()
                golds.append(g * own.float())
            gold = collectives.all_reduce(self.red, golds)[0]
        return L.lm_objective(lse, gold, aux, self.cfg.moe_aux_weight)
