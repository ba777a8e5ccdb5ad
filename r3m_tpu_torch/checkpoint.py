"""Reading reference torch artifacts (``model.pt`` / ``snapshot.pt``).

The port reads them natively: the state dict keeps the reference's names and layouts,
and only the ``module.convnet.`` prefix comes off (`r3m_tpu_torch.convert.convnet_state`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from r3m_tpu_torch.convert import convnet_state


def load_torch_payload(path: str):
    """Guarded ``torch.load`` of a reference artifact; returns the raw payload."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        # Retry the unsafe path ONLY for weights_only rejections (payloads with
        # non-tensor globals, e.g. OmegaConf nodes in old snapshots); a corrupt file
        # raises UnpicklingError too, but without the weights_only wording, and must
        # surface its real error.
        msg = str(e)
        if "weights_only" not in msg and "Weights only" not in msg:
            raise
        return torch.load(path, map_location="cpu", weights_only=False)


def torch_payload_state_dict(payload) -> Dict:
    """The model state dict of a reference payload (``{"r3m": sd, "global_step": ...}``
    for snapshots, a bare state dict for model.pt — train_representation.py:123-138)."""
    if isinstance(payload, dict) and "r3m" in payload:
        return payload["r3m"]
    return payload


def load_convnet(path: str) -> Tuple[Dict[str, Any], int, Optional[int]]:
    """``(backbone state dict, size, image size or None)`` of a reference artifact."""
    return convnet_state(torch_payload_state_dict(load_torch_payload(path)))
