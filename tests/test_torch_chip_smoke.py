"""chip_smoke.py's attention check, held on the CPU against outputs with
planted faults: the tolerance it holds the attention kernels to must pass
an output rounded as the flash kernel rounds and fail a kernel that drops a
key tile or normalises twice."""
import functools

import pytest
import torch

import chip_smoke
from hipt_abmil_atec23_tpu_torch.ops import flash_attention as fa

N = 16384       # long enough that unit logits give a near-uniform average
TILE = 64       # the flash kernel's key tile


def _emulated_flash(q, k, v, fault=None):
    """The flash kernel's rounding (p = exp(s - m) rounded to bf16 for
    P . V, l summed in f32) over all keys at once, with a planted fault:
    one key tile left out, or the output divided by l twice."""
    out = torch.empty_like(q)
    for i in range(0, q.shape[1], 2048):
        s = (q[:, i:i + 2048].float() @ k.float().transpose(-1, -2)
             * q.shape[-1] ** -0.5)
        if fault == "dropped_tile":
            s[..., 5 * TILE:6 * TILE] = fa.NEG_INF
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        o = (p.to(torch.bfloat16).float() @ v.float()) / l
        out[:, i:i + 2048] = (o / l if fault == "normalised_twice"
                              else o).to(q.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _case(q_scale):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, N, 64, generator=g) for _ in range(3))
    q, k, v = (t.to(torch.bfloat16) for t in (q * q_scale, k, v))
    return q, k, v, fa.flash_attention_reference(q, k, v)


@pytest.mark.parametrize("q_scale", [1.0, chip_smoke.Q_SCALE])
@pytest.mark.parametrize("fault", [None, "dropped_tile", "normalised_twice"])
def test_attention_check_rejects_planted_faults(fault, q_scale):
    """At unit logits and at chip_smoke's peaked ones, the kernel-like
    output passes _attn_check and each planted fault fails it."""
    q, k, v, want = _case(q_scale)
    got = _emulated_flash(q, k, v, fault)
    if fault is None:
        chip_smoke._attn_check("flash_attention", "kernel-like", got, want)
    else:
        with pytest.raises(SystemExit):
            chip_smoke._attn_check("flash_attention", fault, got, want)

