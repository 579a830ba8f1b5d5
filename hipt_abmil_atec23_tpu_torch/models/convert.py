"""Checkpoint bridges for the port.

The port's modules keep the reference's torch layouts (DINO ViTs,
models/model_clam.py), so reference ``.pth``/``.pt`` files load as they are
once their wrapper keys are stripped. The ``*_from_jax`` bridges invert the
JAX package's converters (hipt_abmil_atec23_tpu/models/convert.py), turning
its parameter trees (nested dicts of arrays) into this package's state
dicts, so one set of weights drives both packages.

Importing the JAX package's convert module would load jax (its package
__init__ imports flax), so the loader is ported here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def load_torch_state_dict(path: str, checkpoint_key: str = "teacher"
                          ) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint with the reference's DINO conventions
    (HIPT_4K/hipt_model_utils.py:39-110): take the ``checkpoint_key``
    entry when present ('teacher'; None for a bare state dict such as a
    CLAM checkpoint) and strip leading 'module.'/'backbone.' prefixes,
    which may stack. Values come back as f32 CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if checkpoint_key and checkpoint_key in sd:
        sd = sd[checkpoint_key]
    out = {}
    for k, v in sd.items():
        while k.startswith(("module.", "backbone.")):
            k = k.split(".", 1)[1]
        out[k] = torch.as_tensor(v).detach().float().cpu()
    return out


# --------------------------------------------------------------------------
# ViTs / HIPT_4K
# --------------------------------------------------------------------------

def _linear_from_jax(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["kernel"]).t().contiguous(),
            f"{prefix}.bias": _t(p["bias"])}


def _ln_from_jax(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def block_state_dict_from_jax(b: Mapping) -> Dict[str, torch.Tensor]:
    """One flax Block's params -> a models.vit.Block state dict."""
    sd = _ln_from_jax(b["norm1"], "norm1")
    sd.update(_ln_from_jax(b["norm2"], "norm2"))
    sd.update(_linear_from_jax(b["attn"]["qkv"], "attn.qkv"))
    sd.update(_linear_from_jax(b["attn"]["proj"], "attn.proj"))
    sd.update(_linear_from_jax(b["mlp"]["fc1"], "mlp.fc1"))
    sd.update(_linear_from_jax(b["mlp"]["fc2"], "mlp.fc2"))
    return sd


def _blocks_from_jax(p: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"block{i}" in p:
        sd.update({f"blocks.{i}.{k}": v for k, v in
                   block_state_dict_from_jax(p[f"block{i}"]).items()})
        i += 1
    return sd


def vit256_state_dict_from_jax(p: Mapping) -> Dict[str, torch.Tensor]:
    """VisionTransformer params (the 'params' level) -> DINO state dict.
    The patch-GEMM kernel [(16*16*3), D] in (kh, kw, c) tap order goes back
    to the conv weight [D, 3, 16, 16] (inverse of convert.py:90)."""
    k = np.asarray(p["patch_kernel"], np.float32)
    d = k.shape[1]
    ps = int(round((k.shape[0] // 3) ** 0.5))
    sd = {"patch_embed.proj.weight":
          _t(k.reshape(ps, ps, 3, d).transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": _t(p["patch_bias"]),
          "cls_token": _t(p["cls_token"]), "pos_embed": _t(p["pos_embed"])}
    sd.update(_ln_from_jax(p["norm"], "norm"))
    sd.update(_blocks_from_jax(p))
    return sd


def vit4k_state_dict_from_jax(p: Mapping) -> Dict[str, torch.Tensor]:
    """VisionTransformer4K params -> DINO ViT-4K state dict (phi.0)."""
    sd = {"cls_token": _t(p["cls_token"]), "pos_embed": _t(p["pos_embed"])}
    sd.update(_linear_from_jax(p["phi"], "phi.0"))
    sd.update(_ln_from_jax(p["norm"], "norm"))
    sd.update(_blocks_from_jax(p))
    return sd


def hipt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX HIPT4K variables ({'params': {'vit256', 'vit4k'}}) -> the port's
    HIPT4K state dict; inverts hipt_params_from_torch."""
    p = params["params"]
    sd = {f"vit256.{k}": v
          for k, v in vit256_state_dict_from_jax(p["vit256"]).items()}
    sd.update({f"vit4k.{k}": v
               for k, v in vit4k_state_dict_from_jax(p["vit4k"]).items()})
    return sd


def load_dino_(model, sd256: Mapping[str, torch.Tensor],
               sd4k: Mapping[str, torch.Tensor]):
    """Load DINO ViT-256 / ViT-4K checkpoints (load_torch_state_dict
    output) into a models.hipt.HIPT4K. Keys the ViTs do not hold (a DINO
    head) are ignored; a missing ViT key raises."""
    for vit, sd in ((model.vit256, sd256), (model.vit4k, sd4k)):
        missing, _ = vit.load_state_dict(dict(sd), strict=False)
        if missing:
            raise KeyError(f"checkpoint lacks {missing}")
    return model


# --------------------------------------------------------------------------
# CLAM_SB
# --------------------------------------------------------------------------

def clam_state_dict_from_torch(sd: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Reference-layout CLAM_SB checkpoint -> the port's CLAM_SB state
    dict, with the reference's eval-time key cleanup (utils/
    eval_utils.py:51-57): '.module' wrappers and 'instance_loss_fn' buffers
    drop; the gated scorer of a dropout build (attention_net.3) moves to
    attention_net.2; instance classifiers (training only) drop."""
    sd = {k.replace(".module", ""): v for k, v in sd.items()
          if "instance_loss_fn" not in k}
    src = "attention_net.3." if any(
        k.startswith("attention_net.3.") for k in sd) else "attention_net.2."
    out = {}
    for k, v in sd.items():
        if k.startswith("instance_classifiers."):
            continue
        if k.startswith(src):
            k = "attention_net.2." + k[len(src):]
        out[k] = torch.as_tensor(v).detach().float().cpu()
    return out


def clam_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CLAM_SB params -> the port's CLAM_SB state dict: the reference
    layout that the JAX package's clam_params_to_torch writes
    (convert.py:177-207), single-branch and gated."""
    p = params["params"]
    att = p["attention"]
    sd = _linear_from_jax(p["fc"], "attention_net.0")
    sd.update(_linear_from_jax(att["attn_a"], "attention_net.2.attention_a.0"))
    sd.update(_linear_from_jax(att["attn_b"], "attention_net.2.attention_b.0"))
    sd.update(_linear_from_jax(att["attn_c"], "attention_net.2.attention_c"))
    sd.update(_linear_from_jax(p["classifier"], "classifiers"))
    return sd
