"""CLAM_SB's gated-attention head in plain PyTorch (mahmoodlab/CLAM
models/model_clam.py; scjjb/HIPT_ABMIL_ATEC23 keeps it): h = ReLU(fc(x)),
scores = W_c(tanh(W_a h) * sigmoid(W_b h)), softmax over the bag's
instances, the attention-weighted sum of h, then the classifier and a
softmax over classes. f32; ``precision`` rounds each product's operands
for a control."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from port_bench.reference.precision import linear, matmul


def clam_sb(bag: torch.Tensor, w: Dict[str, torch.Tensor],
            prec: str = "f32"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bag [N, D] -> (scores [N] before the softmax, logits [C],
    probabilities [C])."""
    s = "attention_net.2."
    h = torch.relu(linear(bag, w["attention_net.0.weight"],
                          w["attention_net.0.bias"], prec))
    a = torch.tanh(linear(h, w[s + "attention_a.0.weight"],
                          w[s + "attention_a.0.bias"], prec))
    g = torch.sigmoid(linear(h, w[s + "attention_b.0.weight"],
                             w[s + "attention_b.0.bias"], prec))
    scores = linear(a * g, w[s + "attention_c.weight"],
                    w[s + "attention_c.bias"], prec)[:, 0]
    pooled = matmul(torch.softmax(scores, 0)[None], h, prec)
    logits = linear(pooled, w["classifiers.weight"], w["classifiers.bias"],
                    prec)[0]
    return scores, logits, torch.softmax(logits, 0)
