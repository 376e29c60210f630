"""Plain PyTorch versions of the standalone integer softmax.

Port of ``repro.kernels.int_softmax.ref``: ``int_softmax_ref`` is the
two-pass ITA integer softmax (``core.ita.int_softmax``), the version the
Hopper kernel (``csrc/int_softmax.cu``) is held to bit for bit on the card;
``softmax_float_ref`` is the float softmax it approximates.
"""

from __future__ import annotations

import torch

from repro_torch.core import ita


def int_softmax_ref(logits_q: torch.Tensor, *, logit_scale: float
                    ) -> torch.Tensor:
    """int8 logits [..., C] → uint8 probabilities [..., C] (scale 1/255)."""
    probs, _ = ita.int_softmax(logits_q, ita.SoftmaxSpec(logit_scale), axis=-1)
    return probs


def softmax_float_ref(logits_q: torch.Tensor, *, logit_scale: float
                      ) -> torch.Tensor:
    return torch.softmax(logits_q.to(torch.float32) * logit_scale, dim=-1)
