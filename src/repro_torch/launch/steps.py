"""The training and serving steps of the LM substrate -- the PyTorch
counterpart of the JAX package's ``launch/steps.py`` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``).

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
logits (the first of equal maxima), as int32.  ``input_specs``,
``batch_logical`` and ``all_shardings`` are placement (ROADMAP.md, queue
1, item 15.4).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import span
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.optim.adamw import OptState

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "lm_loss", "model_extras"]


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
    logits = logits[:, -labels.shape[1]:]  # a VLM's prefix comes first
    # streaming xent: lse - gold; the f32 upcast lives only inside the
    # log-sum-exp
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0].float()
    nll = torch.mean(lse - gold)
    loss = nll + cfg.moe_aux_weight * aux[0] + 1e-3 * aux[1]
    return loss, (nll, aux)


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

    def grad_fn(mb):
        loss, (nll, aux) = lm_loss(model, cfg, mb)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), nll.detach(), aux.detach(), grads

    def train_step(opt: OptState, batch):
        if n_micro == 1:
            loss, nll, aux, grads = grad_fn(batch)
            grads = dict(zip(names, grads))
        else:
            micro = {k: torch.chunk(v, n_micro, dim=0)
                     for k, v in batch.items()}
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
            grads = {k: g * inv for k, g in zip(names, acc)}
            loss, nll, aux = loss * inv, nll * inv, aux * inv
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
