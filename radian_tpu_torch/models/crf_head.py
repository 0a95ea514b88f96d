"""The CRF head both Bonito families end in (``bonito/crf/model.py``'s
``LinearCRFEncoder``): a linear layer to ``4^state_len·4`` move scores,
``tanh`` times ``scale``, and the constant ``blank_score`` put in front
of each state's 4 moves, ``[..., 4^state_len·5]``.  The transformer's
head has no bias, the LSTM's has one (``crf.bias`` in the config)."""

from __future__ import annotations

import torch
from torch import nn

from radian_tpu_torch.config import DotDict


class CrfHead(nn.Linear):
    """The head of a config's ``crf`` section over ``insize`` features;
    its parameters are the linear layer's (``weight``, ``bias``)."""

    def __init__(self, insize: int, crf: DotDict):
        if crf.n_base != 4:
            raise ValueError(f"n_base {crf.n_base}: the CRF decode takes 4")
        super().__init__(insize, 4 ** crf.state_len * 4,
                         bias=bool(crf.get("bias", False)))
        self.state_len = crf.state_len
        self.scale, self.blank_score = crf.scale, crf.blank_score

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """``[..., insize]`` → ``[..., 4^state_len·5]`` in ``h``'s dtype."""
        lin = super().forward(h).view(*h.shape[:-1], -1, 4)
        scores = torch.empty((*lin.shape[:-1], 5), dtype=lin.dtype,
                             device=lin.device)
        scores[..., 0] = self.blank_score
        torch.tanh(lin, out=scores[..., 1:])
        scores[..., 1:] *= self.scale
        return scores.view(*h.shape[:-1], -1)
