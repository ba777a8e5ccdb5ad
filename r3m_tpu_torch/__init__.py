"""r3m_tpu_torch — R3M pretrained visual representations on PyTorch and CUDA.

The PyTorch port of `r3m_tpu`, for an NVIDIA H100 (sm_90a). It serves: the reference's
public API, `load_r3m(modelid)` / `load_r3m_reproduce(modelid)` /
`load_r3m_from_files(path)`, returns an `R3MEncoder` (alias `R3M`) that maps NCHW images
in [0, 255] to embeddings. Reference ``model.pt`` files load natively, and so do native
``.npz`` snapshots of either package (`load_r3m_from_snapshot`). And it pretrains:
`r3m_tpu_torch.training.trainer.make_train_step` is the R3M pretraining step, whose state
`r3m_tpu_torch.checkpoint` saves and resumes in the JAX package's format. It scores the
language-conditioned reward of a trained model (`R3MRewardModel`, with the WordPiece
tokenizer and the frozen DistilBERT); `Workspace` (``python -m
r3m_tpu_torch.train_representation``) trains on Ego4D-layout data end to end, with
evaluation, snapshots and resume; `bc_probe` and ``python -m r3m_tpu_torch.probe_delta``
score a frozen representation downstream; and it has the CLIs ``python -m
r3m_tpu_torch.{embed,convert,prepare_language,verify_parity}``. The ResNet
stem pool and the ViT attention, forward and backward, run hand-written CUDA kernels
(``r3m_tpu_torch/csrc``), built at first use.

Every serving entry point takes ``precision=`` ("parity" or "fast"), ``mesh=`` (a
`r3m_tpu_torch.parallel.mesh.make_mesh` result: serving split over several cards), and
every entry point ``device=``; the device is ``"cuda"`` unless the caller names another,
and with no card a CUDA request raises. Training runs data-parallel over several cards
with one process a card (`make_train_step(mesh=...)`, ``torchrun`` or ``n_devices=N``).
This package imports neither `jax` nor `r3m_tpu`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from r3m_tpu_torch.convert import remove_language_head  # noqa: F401
from r3m_tpu_torch.models.r3m import (  # noqa: F401
    R3MConfig,
    R3MEncoder,
    r3m_embed,
    r3m_init,
    sim,
)

__version__ = "0.1.0"

__all__ = [
    "R3M",
    "R3MConfig",
    "R3MEncoder",
    "R3MRewardModel",
    "VALID_ARGS",
    "Workspace",
    "bc_probe",
    "cleanup_config",
    "load_r3m",
    "load_r3m_from_files",
    "load_r3m_from_snapshot",
    "load_r3m_reproduce",
    "r3m_embed",
    "r3m_init",
    "remove_language_head",
    "sim",
]


def __getattr__(name: str):
    """`R3MRewardModel`, `Workspace` and `bc_probe` are imported on first use, as in the
    JAX package."""
    if name == "R3MRewardModel":
        from r3m_tpu_torch.reward import R3MRewardModel

        return R3MRewardModel
    if name == "Workspace":
        from r3m_tpu_torch.training.workspace import Workspace

        return Workspace
    if name == "bc_probe":
        from r3m_tpu_torch.evalsuite.bc import bc_probe

        return bc_probe
    raise AttributeError(f"module 'r3m_tpu_torch' has no attribute {name!r}")


# Constructor args accepted from checkpoint configs (r3m/__init__.py:15).
VALID_ARGS = [
    "_target_",
    "device",
    "lr",
    "hidden_dim",
    "size",
    "l2weight",
    "l1weight",
    "langweight",
    "tcnweight",
    "l2dist",
    "bs",
]

# The reference exports the model class as `R3M`.
R3M = R3MEncoder


def cleanup_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Sanitize a checkpoint's config node (r3m/__init__.py:21-33).

    Filters to VALID_ARGS and forces langweight=0 — downstream use is as a visual
    representation, so the language head is dropped.
    """
    agent = dict(cfg.get("agent", cfg))
    agent = {k: v for k, v in agent.items() if k in VALID_ARGS}
    agent["langweight"] = 0
    agent.pop("_target_", None)
    agent.pop("device", None)
    return agent


def _config_from_yaml(configpath: str) -> R3MConfig:
    """`R3MConfig` from a checkpoint folder's training config.

    Real folders ship the TRAINING config, whose agent node holds OmegaConf
    interpolations ('lr: ${lr}'); they are resolved against the root config, and values
    whose referent is absent are dropped, so no literal '${lr}' reaches R3MConfig.
    """
    import yaml

    from r3m_tpu_torch.utils.config import _resolve, agent_to_r3m_config

    with open(configpath) as f:
        raw_cfg = yaml.safe_load(f) or {}
    resolved: Dict[str, Any] = {}
    for k, v in cleanup_config(raw_cfg).items():
        try:
            v = _resolve(v, raw_cfg)
        except (KeyError, ValueError):
            continue
        if isinstance(v, str) and "${" in v:
            continue  # unsupported resolver form (e.g. ${oc.env:...})
        resolved[k] = v
    return agent_to_r3m_config(resolved)


def load_r3m_from_files(
    modelpath: str, configpath: str = None, precision: str = "parity", device=None,
    mesh=None,
) -> R3MEncoder:
    """Load from explicit artifact paths (offline hosts, local copies).

    `modelpath` is a reference ``model.pt``/``snapshot.pt``, or a native ``.npz``
    snapshot (`load_r3m_from_snapshot`, which takes the architecture from the snapshot);
    `configpath`, if given, its ``config.yaml`` (which needs pyyaml). The weights decide
    the backbone and, for a ViT, the crop size, whatever the config says. `mesh` serves
    over several devices in place of `device` (`R3MEncoder`).
    """
    from r3m_tpu_torch.checkpoint import load_torch_checkpoint
    from r3m_tpu_torch.models.r3m import resolve_device

    if modelpath.endswith(".npz"):
        return load_r3m_from_snapshot(modelpath, precision=precision, device=device,
                                      mesh=mesh)
    device = resolve_device(device if mesh is None else mesh.devices[0])  # fail early
    cfg = _config_from_yaml(configpath) if configpath is not None else R3MConfig()
    bundle = load_torch_checkpoint(modelpath)
    cfg = dataclasses.replace(
        cfg,
        size=bundle["size"],
        langweight=0.0,
        image_size=bundle["image_size"] or cfg.image_size,
    )
    return R3MEncoder(cfg, bundle["convnet"], precision=precision, device=device, mesh=mesh)


def load_r3m_from_snapshot(path: str, precision: str = "parity", device=None,
                           mesh=None) -> R3MEncoder:
    """An encoder from a native training snapshot (``.npz``, written by either package).

    The architecture comes from the snapshot's ``config`` metadata; the encoder serves in
    `precision` whatever dtype the run trained in, and the language head is dropped, as
    `load_r3m` drops it.
    """
    from r3m_tpu_torch.checkpoint import load_snapshot, r3m_config_from_meta
    from r3m_tpu_torch.convert import state_dict_from_jax, strip_prefix
    from r3m_tpu_torch.models.r3m import resolve_device

    device = resolve_device(device if mesh is None else mesh.devices[0])
    tree, meta = load_snapshot(path)
    if not meta.get("config"):
        raise ValueError(
            f"snapshot {path!r} carries no 'config' metadata, so its architecture cannot be "
            "rebuilt; write it with save_train_snapshot(..., cfg) or "
            "save_snapshot(..., meta={'config': dataclasses.asdict(cfg), ...})"
        )
    cfg = r3m_config_from_meta(meta, langweight=0, compute_dtype="float32")
    sd = state_dict_from_jax({"convnet": tree["params"]["convnet"]},
                             tree.get("batch_stats", {}), cfg.size, data_parallel=False)
    return R3MEncoder(cfg, strip_prefix(sd, "convnet."), precision=precision, device=device,
                      mesh=mesh)


def load_r3m(modelid: str, precision: str = "parity", device=None, mesh=None) -> R3MEncoder:
    """Load a pretrained R3M visual encoder ("resnet50"/"resnet34"/"resnet18").

    Same registry and ``$R3M_HOME`` (default ``~/.r3m``) cache layout as the reference
    (r3m/__init__.py:44-75). The returned module takes NCHW images in [0, 255] and
    returns [B, out_dim] embeddings. `precision="parity"` (default) serves f32 with TF32
    off; `"fast"` serves the same folded weights in bfloat16. `mesh` serves over several
    devices (`r3m_tpu_torch.parallel.mesh.make_mesh`).
    """
    from r3m_tpu_torch.fetch import ensure_artifacts

    modelpath, configpath = ensure_artifacts(modelid, reproduce=False)
    return load_r3m_from_files(modelpath, configpath, precision=precision, device=device,
                               mesh=mesh)


def load_r3m_reproduce(modelid: str, precision: str = "parity", device=None,
                       mesh=None) -> R3MEncoder:
    """Load paper-reproduction checkpoints ("r3m"/"r3m_noaug"/"r3m_nol1"/"r3m_nolang")
    — r3m/__init__.py:77-113, with its `modelif` typo fixed."""
    from r3m_tpu_torch.fetch import ensure_artifacts

    modelpath, configpath = ensure_artifacts(modelid, reproduce=True)
    return load_r3m_from_files(modelpath, configpath, precision=precision, device=device,
                               mesh=mesh)
