"""Checkpoint bridges for the port.

The port's modules keep the reference's torch layouts (DINO ViTs,
ResNets, models/model_clam.py), so reference ``.pth``/``.pt`` files load as
they are once their wrapper keys are stripped (LeViT's folded layout has
its own converters in models/levit.py). The ``*_from_jax`` bridges invert the
JAX package's converters (hipt_abmil_atec23_tpu/models/convert.py), turning
its parameter trees (nested dicts of arrays) into this package's state
dicts, so one set of weights drives both packages.

Importing the JAX package's convert module would load jax (its package
__init__ imports flax), so the loader is ported here.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def load_torch_state_dict(path: str, checkpoint_key: str = "teacher"
                          ) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint with the reference's loading conventions:
    DINO (the ``checkpoint_key`` entry when present, 'teacher'; None for a
    bare state dict such as a CLAM checkpoint; leading 'module.'/'backbone.'
    prefixes, which may stack - HIPT_4K/hipt_model_utils.py:39-110), the
    Histo self-supervised ResNet layout ({'state_dict': ...} whose keys
    also lose leading 'model.'/'resnet.' prefixes -
    models/resnet_custom.py:112-135), and a pickled module (its
    ``state_dict()``). Only prefixes strip: an interior '.model.' stays.
    Values come back as f32 CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    histo_layout = False
    if checkpoint_key and checkpoint_key in sd:
        sd = sd[checkpoint_key]
    elif isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
        histo_layout = True
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    prefixes = ("module.", "backbone.") + (
        ("model.", "resnet.") if histo_layout else ())
    out = {}
    for k, v in sd.items():
        while k.startswith(prefixes):
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


def stacked_blocks_from_jax(p: Mapping, prefix: str = "block"
                            ) -> Tuple[torch.Tensor, ...]:
    """The per-block params ``{prefix}0``, ``{prefix}1``, ... of a flax
    VisionTransformer (the 'params' level) stacked on a leading depth axis
    in the order and JAX layout of ops/fused_network.py ``ORDER`` (ln1_g,
    ln1_b, wqkv [T, D, 3D], bqkv, wproj [T, D, D], bproj, ln2_g, ln2_b,
    w1 [T, D, H], b1, w2 [T, H, D], b2), as f32 tensors."""
    blocks = []
    while f"{prefix}{len(blocks)}" in p:
        blocks.append(p[f"{prefix}{len(blocks)}"])
    leaves = lambda b: (
        b["norm1"]["scale"], b["norm1"]["bias"],
        b["attn"]["qkv"]["kernel"], b["attn"]["qkv"]["bias"],
        b["attn"]["proj"]["kernel"], b["attn"]["proj"]["bias"],
        b["norm2"]["scale"], b["norm2"]["bias"],
        b["mlp"]["fc1"]["kernel"], b["mlp"]["fc1"]["bias"],
        b["mlp"]["fc2"]["kernel"], b["mlp"]["fc2"]["bias"])
    per = [leaves(b) for b in blocks]
    return tuple(_t(np.stack([np.asarray(lv[i], np.float32) for lv in per]))
                 for i in range(12))


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


def load_vit_(vit, sd: Mapping[str, torch.Tensor]):
    """Load a DINO ViT checkpoint (load_torch_state_dict output) into a
    models.vit ViT. Keys the ViT does not hold (a DINO head) are ignored;
    a missing ViT key raises."""
    missing, _ = vit.load_state_dict(dict(sd), strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    return vit


def load_dino_(model, sd256: Mapping[str, torch.Tensor],
               sd4k: Mapping[str, torch.Tensor]):
    """Load DINO ViT-256 / ViT-4K checkpoints into a models.hipt.HIPT4K,
    each as ``load_vit_`` does."""
    load_vit_(model.vit256, sd256)
    load_vit_(model.vit4k, sd4k)
    return model


# --------------------------------------------------------------------------
# ResNet trunks (models/resnet.py)
# --------------------------------------------------------------------------

def resnet_state_dict_from_jax(variables: Mapping, layers=(3, 4, 6),
                               bottleneck: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """JAX ResNetTrunk variables ({'params', 'batch_stats'}) -> the
    reference / torchvision state dict models.resnet.ResNetTrunk holds;
    inverts the JAX package's resnet_params_from_torch (convert.py
    :229-252). Flax conv kernels are HWIO, torch's OIHW."""
    p, st = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def convbn(pp, ss, conv, bn):
        sd[f"{conv}.weight"] = _t(np.asarray(pp["conv"]["kernel"])
                                  .transpose(3, 2, 0, 1))
        sd[f"{bn}.weight"] = _t(pp["bn"]["scale"])
        sd[f"{bn}.bias"] = _t(pp["bn"]["bias"])
        sd[f"{bn}.running_mean"] = _t(ss["bn"]["mean"])
        sd[f"{bn}.running_var"] = _t(ss["bn"]["var"])

    convbn(p["stem"], st["stem"], "conv1", "bn1")
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            name, tp = f"layer{li + 1}_{bi}", f"layer{li + 1}.{bi}"
            for k in range(1, (3 if bottleneck else 2) + 1):
                convbn(p[name][f"cb{k}"], st[name][f"cb{k}"],
                       f"{tp}.conv{k}", f"{tp}.bn{k}")
            if "down" in p[name]:
                convbn(p[name]["down"], st[name]["down"],
                       f"{tp}.downsample.0", f"{tp}.downsample.1")
    return sd


# --------------------------------------------------------------------------
# MIL heads (CLAM_SB, CLAM_MB, MIL_fc, MIL_fc_mc)
# --------------------------------------------------------------------------

# a Linear inside an indexed slot that moves with the dropout build: the
# ungated scorer's last layer (attention_net.N.module.{2,3}) and MIL_fc's
# instance classifier (classifier.{2,3})
_SLOT = re.compile(r"^(attention_net\.\d\.module|classifier)\.([23])\.")


def mil_state_dict_from_torch(sd: Mapping[str, Any], *,
                              with_dropout: bool = False,
                              keep_instance: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """A reference-layout MIL checkpoint (CLAM_SB / CLAM_MB / MIL_fc /
    MIL_fc_mc) -> the port's state dict for a build with or without
    dropout, with the reference's eval-time key cleanup (utils/
    eval_utils.py:51-57): '.module' wrappers and 'instance_loss_fn' buffers
    drop. The scorer moves to attention_net.3 (dropout build) or .2, and
    the slots behind a Dropout (the ungated scorer's last Linear,
    MIL_fc's classifier) move with it. Instance classifiers drop unless
    ``keep_instance`` (training resumes with them)."""
    sd = {k.replace(".module", ""): v for k, v in sd.items()
          if "instance_loss_fn" not in k}
    src = "attention_net.3." if any(
        k.startswith("attention_net.3.") for k in sd) else "attention_net.2."
    dst = "attention_net.3." if with_dropout else "attention_net.2."
    out = {}
    for k, v in sd.items():
        if k.startswith("instance_classifiers.") and not keep_instance:
            continue
        if k.startswith(src):
            rest = k[len(src):]
            # the ungated scorer's Sequential lost its '.module' above
            k = dst + ("module." + rest if rest[0].isdigit() else rest)
        k = _SLOT.sub(lambda m: f"{m.group(1)}.{3 if with_dropout else 2}.",
                      k)
        out[k] = torch.as_tensor(v).detach().float().cpu()
    return out


def clam_state_dict_from_torch(sd: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Reference-layout CLAM checkpoint -> the port's state dict for a
    build without dropout, instance classifiers dropped (an inference
    head): ``mil_state_dict_from_torch`` with its defaults."""
    return mil_state_dict_from_torch(sd)


def mil_state_dict_from_jax(params: Mapping, model_type: str = "clam_sb",
                            n_classes: int = 2, *, with_dropout: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """JAX MIL-head params (any ``build_mil_model`` head) -> the port's
    state dict in the reference layout, the inverse of the JAX package's
    clam_params_from_torch and the layout its clam_params_to_torch writes
    (convert.py:177-207): ``instance_w`` [C, L, 2] to
    ``instance_classifiers.{c}``, CLAM_MB's ``bag_w`` / ``bag_b`` to
    ``classifiers.{c}``, MIL_fc's ``fc`` / ``classifier`` to
    ``classifier.{0,2}`` and MIL_fc_mc's to ``fc.0`` / ``classifiers.{c}``.
    ``with_dropout`` gives the layout of a dropout build."""
    p = params["params"]
    last = 3 if with_dropout else 2
    per_class = lambda w, b, prefix: {
        k: v for c in range(n_classes) for k, v in (
            (f"{prefix}.{c}.weight", _t(w[c])[None, :]),
            (f"{prefix}.{c}.bias", _t(b[c]).reshape(1)))}
    if model_type == "mil":
        if n_classes > 2:
            sd = _linear_from_jax(p["fc"], "fc.0")
            k, b = np.asarray(p["classifier"]["kernel"]), p["classifier"]["bias"]
            sd.update(per_class(k.T, b, "classifiers"))
            return sd
        sd = _linear_from_jax(p["fc"], "classifier.0")
        sd.update(_linear_from_jax(p["classifier"], f"classifier.{last}"))
        return sd
    if model_type not in ("clam_sb", "clam_mb"):
        raise ValueError(f"unknown model_type {model_type!r}")
    a = f"attention_net.{last}"
    att = p["attention"]
    sd = _linear_from_jax(p["fc"], "attention_net.0")
    if "attn_b" in att:
        sd.update(_linear_from_jax(att["attn_a"], f"{a}.attention_a.0"))
        sd.update(_linear_from_jax(att["attn_b"], f"{a}.attention_b.0"))
        sd.update(_linear_from_jax(att["attn_c"], f"{a}.attention_c"))
    else:
        sd.update(_linear_from_jax(att["attn_a"], f"{a}.module.0"))
        sd.update(_linear_from_jax(att["attn_c"], f"{a}.module.{last}"))
    if model_type == "clam_mb":
        sd.update(per_class(p["bag_w"], p["bag_b"], "classifiers"))
    else:
        sd.update(_linear_from_jax(p["classifier"], "classifiers"))
    if "instance_w" in p:
        for c in range(n_classes):
            sd[f"instance_classifiers.{c}.weight"] = \
                _t(p["instance_w"][c]).t().contiguous()
            sd[f"instance_classifiers.{c}.bias"] = _t(p["instance_b"][c])
    return sd


def clam_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CLAM_SB params -> the port's CLAM_SB state dict: the reference
    layout that the JAX package's clam_params_to_torch writes
    (convert.py:177-207), single-branch and gated."""
    return mil_state_dict_from_jax(params, "clam_sb",
                                   params["params"]["classifier"]["bias"]
                                   .shape[0])


def hipt_lgp_state_dict_from_jax(params: Mapping, depth: int = 2
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's HIPT_LGP global-branch params (hipt_mil.py, the
    layout its ``hipt_lgp_params_from_torch`` makes) -> the reference's
    state-dict names of models/hipt_mil.HIPTGlobalAggregator."""
    sd = _linear_from_jax(params["phi"], "global_phi.0")
    for i, layer in enumerate(params["layers"][:depth]):
        p = f"global_transformer.layers.{i}"
        sd[f"{p}.self_attn.in_proj_weight"] = _t(
            layer["attn"]["in_proj_kernel"]).t().contiguous()
        sd[f"{p}.self_attn.in_proj_bias"] = _t(layer["attn"]["in_proj_bias"])
        sd.update(_linear_from_jax(layer["attn"]["out_proj"],
                                   f"{p}.self_attn.out_proj"))
        for name in ("linear1", "linear2"):
            sd.update(_linear_from_jax(layer[name], f"{p}.{name}"))
        for name in ("norm1", "norm2"):
            sd.update(_ln_from_jax(layer[name], f"{p}.{name}"))
    for jax_name, prefix in (("attn_a", "global_attn_pool.attention_a.0"),
                             ("attn_b", "global_attn_pool.attention_b.0"),
                             ("attn_c", "global_attn_pool.attention_c"),
                             ("rho", "global_rho.0")):
        sd.update(_linear_from_jax(params[jax_name], prefix))
    return sd
