"""Language-conditioned reward head G(e0, eg, lang) -> score, the port of
``r3m_tpu/models/language_reward.py``.

The reference's trainable 5-layer ReLU MLP (``models_language.py:37-55``): input
``concat([e0, eg, le], -1)`` of ``im_dim*2 + lang_dim`` features, four hidden layers of
``hidden_dim`` and a scalar output. `LanguageReward` keeps the reference's names,
``pred.{0,2,4,6,8}``, so ``lang_rew.pred.*`` entries of a reference state dict load as
they are. The loss batches every pair-score of a step into one application.
"""

from __future__ import annotations

import torch
from torch import nn


class LanguageReward(nn.Module):
    """``pred`` = Linear, ReLU, Linear, ReLU, Linear, ReLU, Linear, ReLU, Linear; torch's
    default Linear initialisation (U(+-1/sqrt(fan_in)) for weights and biases), drawn
    from torch's global generator."""

    def __init__(self, im_dim: int, hidden_dim: int, lang_dim: int = 768):
        super().__init__()
        dims = [im_dim * 2 + lang_dim] + [hidden_dim] * 4 + [1]
        layers = []
        for i in range(5):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
            if i < 4:
                layers.append(nn.ReLU())
        self.pred = nn.Sequential(*layers)

    def forward(self, e0: torch.Tensor, eg: torch.Tensor, le: torch.Tensor) -> torch.Tensor:
        """Score ``[N, D], [N, D], [N, L] -> [N]`` (any leading batch shape), in f32."""
        x = torch.cat([e0, eg, le], dim=-1).to(torch.float32)
        return self.pred(x).squeeze(-1)


def language_reward_from_state(sd, im_dim: int) -> LanguageReward:
    """A `LanguageReward` holding the state dict `sd` (``pred.*``) on the CPU; its hidden
    and language widths are read from the weights."""
    hidden, width = sd["pred.0.weight"].shape
    model = LanguageReward(im_dim, int(hidden), int(width) - 2 * im_dim)
    model.load_state_dict(sd)
    return model
