"""The R3M pretraining step: augment -> encode -> losses -> backward -> optimizer, the port
of ``r3m_tpu/training/trainer.py``.

The reference's `Trainer.update` (``trainer.py:25-162``) with the Adam its model owns
(``models_r3m.py:76``): a batch of 5-frame clips is augmented on the device, encoded
(ResNet BatchNorm in train mode, stem pool through kernels K1/K2; ViT attention through
K3/K4), scored by the frozen DistilBERT sentence embedding and the language-reward head,
and the TCN + language InfoNCE + L1/L2 loss is minimised. PyTorch runs it eagerly, one
step a call; the `TrainState` is updated in place and returned.

Random draws come from the `torch.Generator` the state carries, in the JAX step's order:
the crops, then the permutations. Tests hand in the JAX package's crops and permutations
(``crops=``, ``perms=``), since the two generators never agree.

With ``mesh=`` the step is data-parallel, one process a card, and computes what the JAX
step computes over a mesh (``trainer.py:343-356``): the global batch's crops and
permutations, drawn on every rank from generators that stay in step; BatchNorm statistics
over every rank's rows; the embeddings gathered, so the negatives span the global
(micro)batch; one global loss; the gradients averaged over the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from r3m_tpu_torch.data.augment import random_resized_crop_clips, sample_crop_params
from r3m_tpu_torch.losses import draw_permutations, r3m_loss
from r3m_tpu_torch.models.distilbert import DistilBert, sentence_embedding
from r3m_tpu_torch.models.r3m import (
    R3MConfig,
    R3MModel,
    full_f32,
    r3m_embed,
    r3m_init,
    resolve_device,
)
from r3m_tpu_torch.parallel.collectives import (
    all_gather_rows,
    assert_same_everywhere,
    average_gradients,
    broadcast_state,
)
from r3m_tpu_torch.parallel.mesh import local_rows
from r3m_tpu_torch.utils.misc import schedule_fn
from r3m_tpu_torch.utils.profiling import (
    STEP,
    STEP_AUGMENT,
    STEP_BACKWARD,
    STEP_ENCODE,
    STEP_LANGUAGE,
    STEP_LOSS,
    STEP_OPTIMIZER,
    span,
)

Batch = Mapping[str, Union[torch.Tensor, np.ndarray]]
Perms = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and updates: the model (parameters and BatchNorm running
    statistics), the optimizer (its moments), the step count and the generator of the
    crops and permutations."""

    model: R3MModel
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """BatchNorm running means and variances (empty for the ViT)."""
        return {k: v for k, v in self.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}


class Lars(torch.optim.Optimizer):
    """``optax.lars`` with the JAX package's masks, written out for torch.

    Per parameter, in optax's order: add ``weight_decay * p`` where the mask holds; scale
    by the trust ratio ``0.001 * |p| / |u|`` where the mask holds (1 where either norm is
    0); multiply by ``-lr``; keep a momentum trace ``t = u + 0.9 * t`` and add it to the
    parameter. The mask holds for every parameter of more than one dimension: BatchNorm
    parameters and biases are exempt. The coefficient, optax's eps of 0 and the momentum
    are optax's defaults, which the JAX trainer uses.
    """

    TRUST_COEFFICIENT = 0.001
    MOMENTUM = 0.9

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if p.ndim > 1:
                    u = u + group["weight_decay"] * p
                    p_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(u)
                    ratio = self.TRUST_COEFFICIENT * p_norm / u_norm
                    ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, ratio)
                    u = u * ratio
                u = u * -group["lr"]
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.mul_(self.MOMENTUM).add_(u)
                p.add_(trace)


def make_optimizer(cfg: R3MConfig, params) -> torch.optim.Optimizer:
    """Adam with torch's defaults (betas 0.9/0.999, eps 1e-8; models_r3m.py:76), whose
    update is optax.adam's formula, or `Lars`. ``cfg.lr`` may be a schedule string
    (`schedule_fn`); the step sets each update's rate, the first update taking lr(0)."""
    lr = schedule_fn(cfg.lr)(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "lars":
        return Lars(params, lr=lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"optimizer must be 'adam'|'lars', got {cfg.optimizer!r}")


def create_train_state(
    cfg: R3MConfig, seed: int = 0, model: Optional[R3MModel] = None, device=None
) -> TrainState:
    """A fresh state on `device` (``"cuda"`` unless given): `model`, or one drawn by
    `r3m_init` from `seed`, a new optimizer, step 0, and a generator seeded with `seed`."""
    device = resolve_device(device)
    model = (model if model is not None else r3m_init(cfg, seed)).to(device)
    if cfg.size != 0:
        model.convnet.to(memory_format=torch.channels_last)
    return TrainState(
        model=model,
        optimizer=make_optimizer(cfg, model.parameters()),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v)
            .to(device) for k, v in batch.items()}


def _encode(cfg, model, images, lang_emb, lang_mask, train, prenormalized, group=None):
    """Shared forward: ``[B, 5, H, W, 3]`` images -> ``(emb [B, 5, D], lang_emb,
    lang_mask)``, the losses' inputs. With a process `group` the images are this rank's
    rows: BatchNorm (in train mode) takes the statistics of every rank's rows, and the
    embeddings and language are every rank's, gathered in rank order."""
    bs = images.shape[0]
    flat = images.reshape(bs * 5, *images.shape[2:])
    emb = r3m_embed(cfg, model.convnet, flat, train=train, prenormalized=prenormalized,
                    bn_group=group if train else None)
    emb = emb.reshape(bs, 5, -1)
    if group is not None:
        emb = all_gather_rows(emb, group)
        if lang_emb is not None:
            with torch.no_grad():
                lang_emb = all_gather_rows(lang_emb, group)
                lang_mask = all_gather_rows(lang_mask, group)
    return emb, lang_emb, lang_mask


def _encode_and_loss(cfg, model, images, lang_emb, lang_mask, perms, train, prenormalized,
                     group=None):
    """`_encode`, then the losses: ``(full_loss, metrics)``."""
    emb, lang_emb, lang_mask = _encode(cfg, model, images, lang_emb, lang_mask, train,
                                       prenormalized, group)
    return r3m_loss(cfg, model.lang_rew, emb, lang_emb, lang_mask, perms)


def _language(cfg, bert, batch):
    if cfg.langweight <= 0:
        return None, None
    lang_emb = sentence_embedding(bert, batch["token_ids"], batch["attn_mask"])
    return lang_emb, batch["lang_mask"].to(torch.float32)


def _check_bert(cfg: R3MConfig, bert: Optional[DistilBert], device) -> Optional[DistilBert]:
    if cfg.langweight > 0 and bert is None:
        raise ValueError("langweight > 0 requires bert_params (a frozen DistilBert)")
    return None if bert is None else bert.to(device).requires_grad_(False).eval()


def _precision(cfg: R3MConfig):
    """The step's precision scope: an f32 step runs in true f32 (TF32 off for cuDNN and
    for matmuls, whatever the caller's flags, which are restored after), the arithmetic the
    CPU comparison and `R3MEncoder`'s parity precision use; a bf16 step as it is."""
    return full_f32() if cfg.compute_dtype == "float32" else contextlib.nullcontext()


def _group(mesh):
    """The process group a ``mesh=`` names: ``True`` is the default group."""
    if mesh is None:
        return None
    if not dist.is_initialized():
        raise RuntimeError("a data-parallel step (mesh=...) needs a process group: join "
                           "one with r3m_tpu_torch.parallel.mesh.init_distributed")
    return dist.group.WORLD if mesh is True else mesh


def broadcast_train_state(state: TrainState, group=None) -> None:
    """Give every rank rank 0's state, in place: parameters, BatchNorm statistics, the
    optimizer's moments, the generator and the step."""
    tensors = list(state.model.state_dict().values())
    for per_param in state.optimizer.state.values():
        tensors.extend(v for _, v in sorted(per_param.items()) if torch.is_tensor(v))
    gen_state = state.generator.get_state()
    step = torch.tensor([state.step], dtype=torch.int64)
    broadcast_state(tensors + [gen_state, step], group=group)
    state.generator.set_state(gen_state)
    state.step = int(step)


def make_train_step(
    cfg: R3MConfig,
    bert_params: Optional[DistilBert] = None,
    doaug: str = "none",
    grad_accum: int = 1,
    device=None,
    mesh=None,
):
    """Build the train step ``step(state, batch, perms=None, crops=None) -> (state,
    metrics)``.

    `batch`: ``images`` ``[B, 5, H, W, 3]`` uint8/float in [0, 255] (NHWC frames), and when
    ``cfg.langweight > 0`` ``token_ids`` and ``attn_mask`` ``[B, T]`` and ``lang_mask``
    ``[B]`` (1.0 where the caption is non-empty); numpy or tensors, moved to `device`
    (``"cuda"`` unless given). `bert_params` is the frozen `DistilBert`.

    `doaug` in {"none", "rc", "rctraj"} applies RandomResizedCrop on the device, fused with
    the normalisation (data_loaders.py:47-52). `grad_accum=N` splits the batch into N
    microbatches in turn: InfoNCE negatives and BatchNorm statistics are per microbatch,
    and one update applies the mean of their gradients. `crops` (``[B, 4]`` for rctraj,
    ``[B, 5, 4]`` for rc) and `perms` (one `draw_permutations` dict, or a list of one per
    microbatch) replace the draws from the state's generator.

    Metrics (0-d tensors on the device): ``l2loss l1loss l0loss``, ``rewloss rewacc1..3``
    with language, ``tcnloss aligned`` with TCN, ``full_loss`` and ``grad_norm`` (the
    global L2 norm of the gradients), averaged over microbatches.

    With ``cfg.compute_dtype="float32"`` the step runs in true f32 (`_precision`).

    `mesh`, a process group (``True`` for the default one), makes the step data-parallel:
    `batch` holds this rank's rows of the global batch of ``B = W * local rows``, laid out
    by `local_rows`; `crops` are the global batch's and `perms` the global microbatches'.
    The crops and permutations are drawn for the global batch on every rank (the first
    call checks that the generators agree), BatchNorm and the loss span every rank's rows
    of a microbatch, and the gradients are averaged over the ranks before the update. The
    metrics are the global ones, the same on every rank.
    """
    if doaug not in ("none", "rc", "rctraj"):
        raise ValueError(
            f"doaug must be one of 'none'|'rc'|'rctraj', got {doaug!r}"
            " — an unknown value would silently train without augmentation"
        )
    device = resolve_device(device)
    bert = _check_bert(cfg, bert_params, device)
    lr_fn = schedule_fn(cfg.lr)
    prenorm = doaug in ("rc", "rctraj")
    group = _group(mesh)
    world, rank = (1, 0) if group is None else (dist.get_world_size(group),
                                                 dist.get_rank(group))
    unchecked = group is not None  # the generators are compared at the first call

    def step(state: TrainState, batch: Batch,
             perms: Optional[Union[Perms, Sequence[Perms]]] = None,
             crops: Optional[torch.Tensor] = None):
        with span(STEP), _precision(cfg):
            return _step(state, batch, perms, crops)

    def _step(state, batch, perms, crops):
        # the step's work runs inside its phase spans, which partition it (profiling.SPANS)
        with span(STEP_AUGMENT):
            batch, images, perms = _augment(state, batch, perms, crops)
        with span(STEP_LANGUAGE):
            lang_emb, lang_mask = _language(cfg, bert, batch)
        with span(STEP_OPTIMIZER):
            state.optimizer.zero_grad(set_to_none=True)
        micro = images.shape[0] // grad_accum
        sums: Dict[str, torch.Tensor] = {}
        for m in range(grad_accum):
            part = slice(m * micro, (m + 1) * micro)
            loss = _forward(state, part, images, lang_emb, lang_mask, perms[m], sums)
            with span(STEP_BACKWARD):
                (loss / grad_accum).backward()
        with span(STEP_LOSS):
            metrics = {k: v / grad_accum for k, v in sums.items()}
        with span(STEP_OPTIMIZER):
            if group is not None:
                average_gradients(state.model.parameters(), group)
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            metrics["grad_norm"] = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            for param_group in state.optimizer.param_groups:
                param_group["lr"] = lr_fn(state.step)
            state.optimizer.step()
            state.step += 1
        return state, metrics

    def _forward(state, part, images, lang_emb, lang_mask, perms, sums):
        """The encoder forward and losses of the microbatch `part` (a slice of the rows):
        its loss, its metrics added to `sums`."""
        with span(STEP_ENCODE):
            emb, lang_emb, lang_mask = _encode(
                cfg, state.model, images[part],
                None if lang_emb is None else lang_emb[part],
                None if lang_mask is None else lang_mask[part], True, prenorm, group,
            )
        with span(STEP_LOSS):
            loss, metrics = r3m_loss(cfg, state.model.lang_rew, emb, lang_emb, lang_mask,
                                     {k: v.to(device) for k, v in perms.items()})
            for k, v in metrics.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        return loss

    def _augment(state, batch, perms, crops):
        """``(batch, images, perms)``: the batch on the device, its images cropped and
        normalized where `doaug` says, and one permutation set a microbatch."""
        nonlocal unchecked
        if state.device != device:
            raise ValueError(f"state lives on {state.device}, the step on {device}")
        batch = _to_device(batch, device)
        images = batch["images"]
        bs = images.shape[0]
        rows = local_rows(bs * world, grad_accum, world, rank)  # checks the divisibility
        if unchecked:
            assert_same_everywhere(state.generator.get_state(), "the step's generator", group)
            unchecked = False
        if prenorm:
            if crops is None:
                b, f, hgt, wid = images.shape[:4]
                n = b * world if doaug == "rctraj" else b * world * f
                crops = sample_crop_params(state.generator, n, hgt, wid)
            if group is not None:
                crops = crops.reshape(bs * world, -1, 4)[torch.as_tensor(rows)]
            mean, std = cfg.norm_stats
            images = random_resized_crop_clips(
                images, cfg.image_size, doaug, rects=crops,
                compute_dtype=cfg.torch_compute_dtype, mean=mean, std=std,
            )
        micro = bs // grad_accum
        if perms is None:
            perms = [draw_permutations(state.generator, micro * world, cfg.num_negatives)
                     for _ in range(grad_accum)]
        elif isinstance(perms, Mapping):
            perms = [perms]
        if len(perms) != grad_accum:
            raise ValueError(f"{len(perms)} permutation sets for grad_accum={grad_accum}")
        return batch, images, perms

    return step


def make_eval_step(cfg: R3MConfig, bert_params: Optional[DistilBert] = None, device=None,
                   mesh=None):
    """The eval step ``eval_step(state, batch, generator=None, perms=None) -> metrics``:
    the same losses and metrics with BatchNorm in eval mode, no augmentation, no gradient,
    no update; the state is left as it was (the reference's ``update(eval=True)`` under
    no_grad, train_representation.py:114-117). The permutations come from `perms` or are
    drawn from `generator`, the counterpart of the JAX step's key. An f32 eval step runs
    in true f32, as the train step does. With `mesh` (as `make_train_step`'s) `batch` is
    this rank's block of the global batch, rank after rank: the embeddings are gathered
    and the permutations and metrics are the global batch's."""
    device = resolve_device(device)
    bert = _check_bert(cfg, bert_params, device)
    group = _group(mesh)
    world = 1 if group is None else dist.get_world_size(group)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  perms: Optional[Perms] = None):
        with _precision(cfg):
            return _eval(state, batch, generator, perms)

    def _eval(state, batch, generator, perms):
        batch = _to_device(batch, device)
        images = batch["images"]
        if perms is None:
            if generator is None:
                raise ValueError("eval_step needs a generator or perms")
            perms = draw_permutations(generator, images.shape[0] * world, cfg.num_negatives)
        lang_emb, lang_mask = _language(cfg, bert, batch)
        _, metrics = _encode_and_loss(
            cfg, state.model, images, lang_emb, lang_mask,
            {k: v.to(device) for k, v in perms.items()}, False, False, group,
        )
        return metrics

    return eval_step
