"""Patch augmentation transform presets + Macenko stain normalization.

The port's own copy of hipt_abmil_atec23_tpu/ops/augment.py (numpy and cv2
host code; the same presets give the same bytes at the same seed).

Capability parity with the reference's 10 named transform pipelines
(reference: extract_features_fp.py:41-140): none / HIPT / HIPT_blur /
HIPT_wang / HIPT_augment / HIPT_augment01 / HIPT_augment_colour / all /
spatial / macenko. The reference composes torchvision transforms per patch on
CPU workers; here each preset is a batched numpy/cv2 function applied to a
whole uint8 batch [B, H, W, 3] on the host decode worker (the
normalization stays on the device, inside the encoder — engine/encode.py).

Macenko is implemented in numpy (the reference wraps torchstain), with the
reference's failure fallback: patches where stain estimation fails pass
through unnormalized and are counted (extract_features_fp.py:41-58).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

TRANSFORM_PRESETS = (
    "none", "HIPT", "HIPT_blur", "HIPT_wang", "HIPT_augment",
    "HIPT_augment01", "HIPT_augment_colour", "all", "spatial", "macenko",
)


# --------------------------------------------------------------------------
# batched elementary ops (uint8 in/out)
# --------------------------------------------------------------------------

def _rand_flips(batch, rng):
    flips_h = rng.random(len(batch)) < 0.5
    flips_v = rng.random(len(batch)) < 0.5
    out = batch.copy()
    out[flips_h] = out[flips_h, :, ::-1]
    out[flips_v] = out[flips_v, ::-1]
    return out


def _rand_affine(batch, rng, degrees, translate=0.0, scale=0.0, shear=0.0):
    import cv2
    out = np.empty_like(batch)
    h, w = batch.shape[1:3]
    for i, img in enumerate(batch):
        ang = rng.uniform(-degrees, degrees)
        s = 1.0 + rng.uniform(-scale, scale)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, s)
        if shear:
            sh = rng.uniform(-shear, shear)
            m[0, 1] += sh
        if translate:
            m[0, 2] += rng.uniform(-translate, translate) * w
            m[1, 2] += rng.uniform(-translate, translate) * h
        out[i] = cv2.warpAffine(img, m, (w, h), borderValue=(255, 255, 255))
    return out


def _color_jitter(batch, rng, brightness=0.0, contrast=0.0, saturation=0.0,
                  hue=0.0):
    import cv2
    out = batch.astype(np.float32)
    n = len(batch)
    if brightness:
        f = rng.uniform(1 - brightness, 1 + brightness, size=(n, 1, 1, 1))
        out = out * f
    if contrast:
        f = rng.uniform(1 - contrast, 1 + contrast, size=(n, 1, 1, 1))
        mean = out.mean(axis=(1, 2, 3), keepdims=True)
        out = (out - mean) * f + mean
    out = np.clip(out, 0, 255).astype(np.uint8)
    if saturation or hue:
        res = np.empty_like(out)
        for i, img in enumerate(out):
            hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
            if saturation:
                hsv[..., 1] *= rng.uniform(1 - saturation, 1 + saturation)
            if hue:
                hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue) * 180) % 180
            res[i] = cv2.cvtColor(
                np.clip(hsv, 0, 255).astype(np.uint8), cv2.COLOR_HSV2RGB)
        out = res
    return out


def _gaussian_blur(batch, rng, ksizes=(1, 3), sigma=(7.0, 9.0)):
    import cv2
    out = np.empty_like(batch)
    for i, img in enumerate(batch):
        k = int(rng.choice([s for s in range(ksizes[0], ksizes[1] + 1)
                            if s % 2 == 1]))
        s = rng.uniform(*sigma)
        out[i] = cv2.GaussianBlur(img, (k, k), s)
    return out


# --------------------------------------------------------------------------
# Macenko stain normalization (native numpy)
# --------------------------------------------------------------------------

# Standard target stain matrix / max concentrations (Macenko et al. 2009,
# same defaults torchstain uses).
_HE_REF = np.array([[0.5626, 0.2159],
                    [0.7201, 0.8012],
                    [0.4062, 0.5581]], np.float64)
_MAX_C_REF = np.array([1.9705, 1.0308], np.float64)


@dataclass
class MacenkoNormalizer:
    """Per-patch Macenko normalization with failure pass-through counting."""
    io: float = 240.0
    alpha: float = 1.0
    beta: float = 0.15
    failures: int = 0

    def fit(self, target: np.ndarray) -> None:
        he, maxc = _macenko_stains(target, self.io, self.alpha, self.beta)
        global _HE_REF, _MAX_C_REF
        _HE_REF, _MAX_C_REF = he, maxc

    def normalize_patch(self, img: np.ndarray) -> np.ndarray:
        try:
            return _macenko_normalize(img, self.io, self.alpha, self.beta)
        except Exception:
            self.failures += 1
            return img

    def __call__(self, batch: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return np.stack([self.normalize_patch(p) for p in batch])


def _macenko_stains(img, io, alpha, beta):
    od = -np.log(np.maximum(img.reshape(-1, 3).astype(np.float64), 1) / io)
    od_h = od[(od > beta).all(axis=1)]
    if len(od_h) < 10:
        raise ValueError("not enough stained pixels")
    cov = np.cov(od_h.T)
    evals, evecs = np.linalg.eigh(cov)
    v = evecs[:, 1:3]  # top-2 eigenvectors
    proj = od_h @ v
    phi = np.arctan2(proj[:, 1], proj[:, 0])
    mn, mx = np.percentile(phi, alpha), np.percentile(phi, 100 - alpha)
    v1 = v @ np.array([np.cos(mn), np.sin(mn)])
    v2 = v @ np.array([np.cos(mx), np.sin(mx)])
    he = np.stack([v1, v2], axis=1) if v1[0] > v2[0] \
        else np.stack([v2, v1], axis=1)
    conc = np.linalg.lstsq(he, od.T, rcond=None)[0]
    maxc = np.percentile(conc, 99, axis=1)
    return he, maxc


def _macenko_normalize(img, io, alpha, beta):
    h, w = img.shape[:2]
    he, maxc = _macenko_stains(img, io, alpha, beta)
    od = -np.log(np.maximum(img.reshape(-1, 3).astype(np.float64), 1) / io)
    conc = np.linalg.lstsq(he, od.T, rcond=None)[0]
    conc *= (_MAX_C_REF / np.maximum(maxc, 1e-8))[:, None]
    norm = io * np.exp(-_HE_REF @ conc)
    return np.clip(norm.T.reshape(h, w, 3), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# preset registry
# --------------------------------------------------------------------------

def build_transform(preset: str, seed: int = 0
                    ) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """uint8 batch -> uint8 batch host transform for a named preset.
    'none'/'HIPT' return None (normalization happens inside the encoder jit).
    """
    if preset in ("none", "HIPT"):
        return None
    rng = np.random.default_rng(seed)

    if preset == "HIPT_blur":
        return lambda b: _gaussian_blur(b, rng)
    if preset == "HIPT_wang":
        return lambda b: _color_jitter(
            _rand_affine(_rand_flips(b, rng), rng, degrees=90),
            rng, 0.125, 0.2, 0.2)
    if preset == "HIPT_augment":
        return lambda b: _color_jitter(
            _rand_affine(_rand_flips(b, rng), rng, 5, 0.025, 0.025, 0.025),
            rng, 0.2, 0.2, 0.2, 0.2)
    if preset == "HIPT_augment01":
        return lambda b: _color_jitter(
            _rand_affine(_rand_flips(b, rng), rng, 5, 0.025, 0.025, 0.025),
            rng, 0.1, 0.1, 0.1, 0.1)
    if preset == "HIPT_augment_colour":
        return lambda b: _color_jitter(_rand_flips(b, rng), rng,
                                       0.2, 0.2, 0.2, 0.2)
    if preset == "all":
        return lambda b: _color_jitter(
            _rand_affine(_rand_flips(b, rng), rng, 90, 0.1, 0.1, 0.1),
            rng, 0.1, 0.1, 0.1, 0.1)
    if preset == "spatial":
        return lambda b: _rand_affine(_rand_flips(b, rng), rng, 90, 0.1, 0.1, 0.1)
    if preset == "macenko":
        return MacenkoNormalizer()
    raise ValueError(f"unknown transform preset {preset!r}; "
                     f"available: {TRANSFORM_PRESETS}")
