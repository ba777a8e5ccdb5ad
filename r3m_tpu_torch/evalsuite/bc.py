"""Behaviour-cloning probe: downstream evaluation of a frozen representation, the port of
``r3m_tpu/evalsuite/bc.py``.

The reference evaluates R3M by behaviour cloning on robot-manipulation suites (its
evaluation branch; arXiv:2203.12601 §4). This is the in-repo form of that protocol:
freeze the visual encoder, embed the demonstration frames, and train a small MLP policy
embedding(+proprio) -> action by MSE. The policy trains on `device` (the card unless the
caller names another) in true f32, with eager PyTorch, as the JAX package trains it with
XLA dots outside any kernel of its own.

Usage:
    r3m = load_r3m("resnet50")
    result = bc_probe(embed_fn=r3m, images=imgs, actions=acts)
    result["val_mse"], result["policy_params"]
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from r3m_tpu_torch.evalsuite.fixtures import _host
from r3m_tpu_torch.models.r3m import full_f32, resolve_device
from r3m_tpu_torch.utils.misc import pad_batch


def _mlp_init(sizes: Sequence[int], generator: torch.Generator, device) -> nn.ModuleList:
    """Linear layers of `sizes`, He-normal weights N(0, 2/fan_in) and zero biases, drawn
    layer by layer from `generator` (a CPU generator, so every device gets the same
    weights from one seed)."""
    layers = nn.ModuleList()
    for a, b in zip(sizes[:-1], sizes[1:]):
        layer = nn.Linear(a, b, device="meta").to_empty(device=device)  # no default draw
        with torch.no_grad():
            w = torch.randn((b, a), generator=generator) * np.sqrt(2.0 / a)
            layer.weight.copy_(w)
            layer.bias.zero_()
        layers.append(layer)
    return layers


def _mlp_apply(params: Sequence[nn.Linear], x: torch.Tensor) -> torch.Tensor:
    """ReLU between the layers, none after the last."""
    for i, layer in enumerate(params):
        x = layer(x)
        if i + 1 < len(params):
            x = torch.relu(x)
    return x


def _policy_apply(params: Sequence[nn.Linear], e) -> torch.Tensor:
    """The policy on embeddings `e` (array or tensor), in true f32 on its device."""
    with full_f32():
        return _mlp_apply(params, torch.as_tensor(e, dtype=torch.float32,
                                                  device=params[0].weight.device))


def _embed_chunked(embed_fn: Callable, images, chunk: int) -> np.ndarray:
    """Embed in fixed-size batches (tail padded by repetition, then cut), as host numpy.

    One forward over the whole demo set would not fit on the device at realistic sizes
    (50k frames of 224 px f32 are ~30 GB); fixed chunks also keep one input shape.
    `embed_fn` may return an array or a tensor on any device.
    """
    images = np.asarray(images)
    n = images.shape[0]
    if n <= chunk:
        return _host(embed_fn(images))
    outs = []
    for i in range(0, n, chunk):
        x = images[i: i + chunk]
        m = x.shape[0]
        outs.append(_host(embed_fn(pad_batch(x, chunk)))[:m])
    return np.concatenate(outs)


def bc_probe(
    embed_fn: Callable,
    images,
    actions,
    proprio: Optional[np.ndarray] = None,
    hidden: int = 256,
    steps: int = 100,
    lr: float = 1e-3,
    batch: int = 256,
    val_frac: float = 0.2,
    seed: int = 0,
    embed_batch: int = 256,
    device=None,
    init_params: Optional[List[Dict[str, np.ndarray]]] = None,
    batch_indices: Optional[np.ndarray] = None,
) -> Dict:
    """Train an MLP policy on frozen embeddings; returns train/val MSE.

    `embed_fn`: maps NCHW uint8-range images -> [N, D] embeddings, an array or a tensor
    (e.g. the encoder `load_r3m` returns). `images`: [N, 3, H, W] in [0, 255]. `actions`:
    [N, A]. Optional `proprio` [N, P] is concatenated to the embedding (the reference
    protocol feeds proprioception alongside).

    The split is the JAX package's: a numpy ``default_rng(seed)`` permutation, the first
    ``max(1, int(N * val_frac))`` rows held out. `steps` counts GRADIENT STEPS: each draws
    one `batch`-sized minibatch of training rows with replacement (not full passes over
    the data — size `steps` accordingly for large demo sets) and takes one Adam step on
    the MSE. torch's Adam is optax's ``adam(lr)`` (betas 0.9/0.999, eps 1e-8 added outside
    the square root, bias-corrected moments). Embedding runs in `embed_batch`-sized
    chunks so arbitrarily large demo sets fit on the device.

    The policy trains on `device` (``"cuda"`` unless given) in true f32 (TF32 off; the
    caller's flags are restored). Its initial weights (He-normal, zero biases) and the
    minibatch indices come from a `torch.Generator` seeded with `seed`, in that order,
    leaving torch's global generator alone; ``init_params`` (a JAX-layout ``[{"w": [a, b],
    "b": [b]}, ...]`` of arrays) and ``batch_indices`` (``[steps, batch]`` ints into the
    training rows) replace those draws, so the JAX package's draws can be fed in.

    Returns ``policy_params`` (an ``nn.ModuleList`` of ``nn.Linear``), ``train_mse_curve``
    ([steps] numpy), ``train_mse``, ``val_mse``, ``embed_dim`` and ``policy_apply(params,
    embeddings) -> actions`` (a tensor on the policy's device).
    """
    device = resolve_device(device)
    emb = _embed_chunked(embed_fn, images, embed_batch)
    if proprio is not None:
        emb = np.concatenate([emb, np.asarray(proprio)], axis=1)
    actions = np.asarray(actions, dtype=np.float32)
    n = emb.shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    val_idx, tr_idx = order[:n_val], order[n_val:]
    if tr_idx.size == 0:
        raise ValueError(
            f"no training samples left: n={n}, val_frac={val_frac} "
            "(need at least 2 samples with val_frac < 1)"
        )

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x_tr, y_tr = on_device(emb[tr_idx]), on_device(actions[tr_idx])
    x_val, y_val = on_device(emb[val_idx]), on_device(actions[val_idx])
    batch = min(batch, x_tr.shape[0])

    generator = torch.Generator().manual_seed(seed)
    sizes = [emb.shape[1], hidden, hidden, actions.shape[1]]
    if init_params is None:
        params = _mlp_init(sizes, generator, device)
    else:
        from r3m_tpu_torch.convert import policy_params_from_jax

        params = policy_params_from_jax(init_params).to(device)
    if batch_indices is None:
        batch_indices = torch.randint(0, x_tr.shape[0], (steps, batch), generator=generator)
    batch_indices = torch.as_tensor(np.asarray(batch_indices), dtype=torch.long,
                                    device=device)
    if batch_indices.shape != (steps, batch):
        raise ValueError(f"batch_indices of shape {tuple(batch_indices.shape)}, expected "
                         f"{(steps, batch)}")
    opt = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    losses = []
    with full_f32():
        for idx in batch_indices:
            loss = torch.mean((_mlp_apply(params, x_tr[idx]) - y_tr[idx]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            val_mse = torch.mean((_mlp_apply(params, x_val) - y_val) ** 2)
    curve = torch.stack(losses).cpu().numpy()
    return {
        "policy_params": params,
        "train_mse_curve": curve,
        "train_mse": float(curve[-1]),
        "val_mse": float(val_mse),
        "embed_dim": int(emb.shape[1]),
        "policy_apply": _policy_apply,
    }
