"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs an NVIDIA GPU (built for sm_90a) and
skips without one; the module imports neither jax nor the JAX package, so
on a machine without jax it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu_torch.models.abmil import (
    CLAM_SB, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.models.vit import Block, init_dino_
from hipt_abmil_atec23_tpu_torch.ops import flash_attention as fa
from hipt_abmil_atec23_tpu_torch.ops import fused_mlp as fm
from hipt_abmil_atec23_tpu_torch.ops import fused_network as fnw
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    fused_vit_block, fused_vit_block_reference)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# The block tiles' edges: M = B n_pad not a multiple of the 128-row GEMM
# tile (48, 528, 16, 960); D = 96 (QKV N = 288 past two 128-column tiles,
# K = 96 past one 64-deep step); D = 64 with one head of 64; n_pad 320;
# n_valid = n_pad (no padded key); and the most tokens the attention tile's
# K and V fit in shared memory for (LONGEST): 768 at hd 64, 1408 at hd 32.
LONGEST = [(2, 768, 701, 128, 2), (1, 1408, 1350, 64, 2)]
EDGE_SHAPES = [(3, 16, 9, 96, 3), (2, 264, 257, 192, 6),
               (4, 264, 257, 384, 6), (2, 8, 5, 64, 1),
               (3, 320, 301, 192, 3), (2, 264, 264, 384, 6), *LONGEST]
# one token-row chunk past LONGEST at each head size: K and V outgrow the
# 227 KB of shared memory a CTA may have
TOO_LONG = [(776, 128, 2), (1416, 64, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nv,d,heads", EDGE_SHAPES)
def test_block_kernel_matches_plain(b, n, nv, d, heads, cuda_device):
    """bf16 kernel against the plain version on the same card inputs:
    |kernel - plain| <= 3e-2 + 5e-2 |plain| (bf16 rounding of P and the
    head outputs at other summation orders)."""
    g = torch.Generator().manual_seed(0)
    blk = Block(d, heads, 4.0, 1e-6)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    blk = blk.to(cuda_device)
    x = torch.randn(b, n, d, generator=g).to(cuda_device, torch.bfloat16)
    before = fused_vit_block.launches
    with torch.inference_mode():
        got = fused_vit_block(x, blk, num_heads=heads, n_valid=nv)
        want = fused_vit_block_reference(x, blk, num_heads=heads,
                                         n_valid=nv).float()
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float()
    assert bool(((got - want).abs() <= 3e-2 + 5e-2 * want.abs()).all())


@pytest.mark.cuda
def test_block_kernel_refuses_what_it_does_not_take(cuda_device):
    """No quiet fallback: head size 96 and odd token counts raise."""
    blk = Block(192, 2, 4.0, 1e-6).to(cuda_device)
    x = torch.zeros(1, 16, 192, device=cuda_device)
    with pytest.raises(ValueError):
        fused_vit_block(x, blk, num_heads=2)            # hd 96
    with pytest.raises(ValueError):
        fused_vit_block(x[:, :9].bfloat16(), blk, num_heads=6)  # n_pad 9
    for n, d, heads in TOO_LONG:
        long = Block(d, heads, 4.0, 1e-6).to(cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            fused_vit_block(torch.zeros(1, n, d, device=cuda_device), long,
                            num_heads=heads)


def _random_blocks(depth, d, heads, g, dev):
    blocks = [Block(d, heads, 4.0, 1e-6) for _ in range(depth)]
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return [blk.to(dev) for blk in blocks]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nv,d,heads", [(3, 16, 9, 96, 3),
                                            (4, 264, 257, 384, 6),
                                            (2, 8, 5, 64, 1),
                                            (3, 320, 320, 192, 3),
                                            LONGEST[0]])
def test_block_kernel_takes_an_f32_residual(b, n, nv, d, heads, cuda_device):
    """f32 x: the kernel reads the f32 residual, rounds the GEMM operands
    to bf16 and writes f32, so it matches the plain version with bf16
    operands within the bf16 bound of the bf16 test."""
    g = torch.Generator().manual_seed(1)
    blk = _random_blocks(1, d, heads, g, cuda_device)[0]
    x = torch.randn(b, n, d, generator=g).to(cuda_device)
    before = fused_vit_block.launches
    with torch.inference_mode():
        got = fused_vit_block(x, blk, num_heads=heads, n_valid=nv)
        want = fused_vit_block_reference(x, blk, num_heads=heads,
                                         n_valid=nv,
                                         operand_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _within(got, want, 3e-2, 5e-2)


@pytest.mark.cuda
def test_f32_encoder_encodes_a_region_on_the_card(cuda_device):
    """build_encoder at f32 runs every block through the block kernel (12
    ViT-256 and 6 ViT-4K calls per batch) and gives finite features."""
    from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
    from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig
    enc = build_encoder(EncoderConfig(dtype="float32", batch_size=1),
                        device="cuda")
    g = torch.Generator().manual_seed(2)
    region = torch.randint(0, 256, (1, 4096, 4096, 3), generator=g,
                           dtype=torch.uint8).to(cuda_device)
    before = fused_vit_block.launches
    feats = enc.apply(region)
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 18
    assert feats.shape == (1, 192) and bool(torch.isfinite(feats).all())


def _dino_blocks(depth, d, heads, g, dev):
    """Blocks at DINO's init scale (init_dino_: weights of std 0.02) with
    LayerNorm parameters and biases moved off 1 and 0 by 0.02 std."""
    blocks = [init_dino_(Block(d, heads, 4.0, 1e-6), g)
              for _ in range(depth)]
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                if p.dim() == 1:
                    p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return [blk.to(dev) for blk in blocks]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,nv,d,heads,depth", [
    (4, 24, 20, 384, 6, 3), (2, 264, 257, 192, 6, 2),
    (2, 264, 257, 384, 6, 12), (3, 16, 9, 96, 3, 2), (2, 8, 5, 64, 1, 3),
    (3, 320, 320, 192, 3, 2), *[(*shape, 2) for shape in LONGEST]])
def test_network_kernel_matches_plain(b, n, nv, d, heads, depth, dtype,
                                      cuda_device):
    """One cooperative launch runs all T blocks: against the plain version
    (bf16 operands, f32 residual, one rounding at the end) within
    3e-2 + 5e-2 |plain|; one launch counted per call. Weights at DINO's
    init scale, as the encoder's: with _random_blocks' (std ~0.06) twelve
    384-wide blocks amplify a 1e-6 relative change of the residual per
    block past this bound in the plain version itself."""
    g = torch.Generator().manual_seed(3)
    ws = fnw.stack_blocks(_dino_blocks(depth, d, heads, g, cuda_device))
    x = torch.randn(b, n, d, generator=g).to(cuda_device, dtype)
    before = fnw.fused_vit_network.launches
    with torch.inference_mode():
        got = fnw.fused_vit_network(x, *ws, num_heads=heads, n_valid=nv,
                                    group=1)
        want = fnw.fused_vit_network_reference(x, *ws, num_heads=heads,
                                               n_valid=nv)
    torch.cuda.synchronize()
    assert fnw.fused_vit_network.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _within(got, want, 3e-2, 5e-2)


@pytest.mark.cuda
def test_network_kernel_refuses_what_it_does_not_take(cuda_device):
    """Head size 96 and an n_pad of 9 raise ValueError; a grid larger than
    the co-resident CTAs fails the cooperative launch with an error (never
    a hang), and the next call runs."""
    g = torch.Generator().manual_seed(4)
    ws = fnw.stack_blocks(_random_blocks(1, 192, 2, g, cuda_device))
    x = torch.zeros(1, 16, 192, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fnw.fused_vit_network(x, *ws, num_heads=2, group=1)       # hd 96
    with pytest.raises(ValueError):
        fnw.fused_vit_network(x[:, :9], *ws, num_heads=6, group=1)  # n_pad 9
    for n, d, heads in TOO_LONG:
        long = fnw.stack_blocks(_random_blocks(1, d, heads, g, cuda_device))
        with pytest.raises(ValueError, match="shared memory"):
            fnw.fused_vit_network(
                torch.zeros(1, n, d, device=cuda_device, dtype=torch.bfloat16),
                *long, num_heads=heads, group=1)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    with pytest.raises(RuntimeError, match="CUDA error"):
        fnw._launch(x, ws, num_heads=6, n_valid=16, eps=1e-6,
                    grid=8 * sms)  # 288-thread CTAs: at most 7 per SM
    out = fnw.fused_vit_network(x, *ws, num_heads=6, group=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,masked", [(4096, 97), (100_000, 97), (300, 300),
                                      (1, 0)])
def test_pool_kernel_matches_plain(n, masked, cuda_device):
    """f32 kernel against the plain version on the card: logits and scores
    within 1e-4 (f32 sums in another order); an all-masked bag gives the
    bias logits."""
    g = torch.Generator().manual_seed(0)
    model = CLAM_SB("hipt_smaller", 2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    p = gap.params_from_clam(model.to(cuda_device))
    bag = torch.randn(n, 192, generator=g).to(cuda_device)
    mask = torch.arange(n, device=cuda_device) < n - masked
    before = gap.gated_attention_pool.launches
    logits, scores = gap.gated_attention_pool(bag, p, mask=mask)
    ref_logits, ref_scores = gap.gated_attention_pool_reference(bag, mask, p)
    torch.cuda.synchronize()
    assert gap.gated_attention_pool.launches == before + 1
    assert (logits[0] - ref_logits).abs().max().item() <= 1e-4
    assert (scores - ref_scores).abs().max().item() <= 1e-4
    if masked == n:
        assert torch.allclose(logits[0], p.b_cls, atol=1e-7)


@pytest.mark.cuda
def test_pool_kernel_prefix_length_equals_mask(cuda_device):
    g = torch.Generator().manual_seed(1)
    model = CLAM_SB("hipt_smaller", 2).to(cuda_device)
    p = gap.params_from_clam(model)
    bag = torch.randn(5000, 192, generator=g).to(cuda_device)
    a = gap.gated_attention_pool(bag, p, n_valid=4321)
    b = gap.gated_attention_pool(
        bag, p, mask=torch.arange(5000, device=cuda_device) < 4321)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _head(size_arg, dev, seed=0):
    """Pool weights of a CLAM head at the reference init's scale (xavier)
    with non-zero biases."""
    g = torch.Generator().manual_seed(seed)
    model = init_reference_weights(CLAM_SB(size_arg, 2), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return gap.params_from_clam(model.to(dev)), g


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 20_000])
@pytest.mark.parametrize("size_arg", ["hipt_smaller", "tiny128", "small",
                                      "big"])
def test_pool_kernel_takes_every_clam_width(size_arg, n, cuda_device):
    """L = 16, 128 and 512 (D_att up to 384): logits and scores within
    1e-4 of the plain version, masked tail included."""
    p, g = _head(size_arg, cuda_device)
    bag = torch.randn(n, p.w_f.shape[0], generator=g).to(cuda_device)
    mask = torch.arange(n, device=cuda_device) < n - 37
    before = gap.gated_attention_pool.launches
    logits, scores = gap.gated_attention_pool(bag, p, mask=mask)
    ref_logits, ref_scores = gap.gated_attention_pool_reference(bag, mask, p)
    torch.cuda.synchronize()
    assert gap.gated_attention_pool.launches == before + 1
    assert (logits[0] - ref_logits).abs().max().item() <= 1e-4
    assert (scores - ref_scores).abs().max().item() <= 1e-4


def _partial_err(got, want):
    """max over |dm|, |dscores| and |dacc| / l, |dl| / l (acc and l are
    sums over the bag, the pooled vector is acc / l)."""
    acc, m, l, s = got
    racc, rm, rl, rs = want
    scale = max(rl.item(), 1e-30)
    return max((m - rm).abs().item(), (s - rs).abs().max().item(),
               (acc - racc).abs().max().item() / scale,
               (l - rl).abs().item() / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("masking", ["tail", "none", "all"])
@pytest.mark.parametrize("size_arg", ["hipt_smaller", "small"])
def test_pool_partial_kernel_matches_plain(size_arg, masking, cuda_device):
    """The partial mode against its plain version on the card within 1e-4
    (acc and l relative to l); an all-masked shard gives m = -1e30, l = 0,
    acc = 0."""
    p, g = _head(size_arg, cuda_device, seed=1)
    n = 5000
    bag = torch.randn(n, p.w_f.shape[0], generator=g).to(cuda_device)
    mask = {"tail": torch.arange(n, device=cuda_device) < 4000,
            "none": None,
            "all": torch.zeros(n, dtype=torch.bool, device=cuda_device)
            }[masking]
    before = gap.gated_attention_pool_partial.launches
    got = gap.gated_attention_pool_partial(bag, p, mask=mask)
    want = gap.gated_attention_pool_partial_reference(bag, mask, p)
    torch.cuda.synchronize()
    assert gap.gated_attention_pool_partial.launches == before + 1
    assert got[0].shape == (1, p.w_f.shape[1]) and got[3].shape == (n,)
    assert _partial_err(got, want) <= 1e-4
    if masking == "all":
        assert got[1].item() == torch.tensor(gap.NEG_INF).item()
        assert got[2].item() == 0 and not got[0].any()


@pytest.mark.cuda
def test_combine_partials_on_card_matches_full_bag_kernel(cuda_device):
    """Four shards through the partial kernel, one all-masked, combined
    with combine_partials: the full-bag kernel's logits within 1e-4."""
    p, g = _head("small", cuda_device, seed=2)
    n = 4 * 3000
    bag = torch.randn(n, 1024, generator=g).to(cuda_device)
    mask = torch.rand(n, generator=g).to(cuda_device) < 0.9
    mask[6000:9000] = False
    parts = [gap.gated_attention_pool_partial(bag[i:i + 3000], p,
                                              mask=mask[i:i + 3000])
             for i in range(0, n, 3000)]
    acc, m, l, _ = (torch.stack([q[j] for q in parts]) for j in range(4))
    got = gap.combine_partials(acc[:, 0], m, l, p)
    want, _ = gap.gated_attention_pool(bag, p, mask=mask)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("masking", ["tail", "all"])
@pytest.mark.parametrize("l_dim", [768, 512, 33, 32])
def test_pool_kernel_at_its_widest_heads(l_dim, masking, cuda_device):
    """The 'big' head's D_in 1024 and D_att 384 at the most columns the
    tensor-core pass holds (L 768), at 'big' itself (512), and across the
    narrow / tensor-core boundary (L 32 with D_att 32 takes the narrow
    pass, L 33 the tensor cores): both modes within 1e-4 of the plain
    version, a masked tail and an all-masked bag (bias logits; m = -1e30,
    l = 0)."""
    d_att = 384 if l_dim > 33 else 32
    g = torch.Generator().manual_seed(l_dim)
    lin = [torch.nn.Linear(1024, l_dim), torch.nn.Linear(l_dim, d_att),
           torch.nn.Linear(l_dim, d_att), torch.nn.Linear(d_att, 1),
           torch.nn.Linear(l_dim, 2)]
    for m in lin:
        torch.nn.init.xavier_normal_(m.weight, generator=g)
        with torch.no_grad():
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    t = [x for m in lin for x in (m.weight.detach().t().contiguous(),
                                  m.bias.detach())]
    p = gap.GatedPoolParams(*(x.to(cuda_device) for x in t))
    n = 20_000
    bag = torch.randn(n, 1024, generator=g).to(cuda_device)
    mask = (torch.arange(n, device=cuda_device) < n - 333
            if masking == "tail"
            else torch.zeros(n, dtype=torch.bool, device=cuda_device))
    logits, scores = gap.gated_attention_pool(bag, p, mask=mask)
    ref_logits, ref_scores = gap.gated_attention_pool_reference(bag, mask, p)
    got = gap.gated_attention_pool_partial(bag, p, mask=mask)
    want = gap.gated_attention_pool_partial_reference(bag, mask, p)
    torch.cuda.synchronize()
    assert (logits[0] - ref_logits).abs().max().item() <= 1e-4
    assert (scores - ref_scores).abs().max().item() <= 1e-4
    if masking == "all":
        assert torch.allclose(logits[0], p.b_cls, atol=1e-7)
        assert got[1].item() == torch.tensor(gap.NEG_INF).item()
        assert got[2].item() == 0 and not got[0].any()
    else:
        assert _partial_err(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("l_dim", [1024, 769])
def test_pool_kernel_refuses_a_head_past_shared_memory(l_dim, cuda_device):
    """No quiet fallback: a head of L = 1024, and one column past the 768
    the kernel's running sums hold in shared memory, raise."""
    shapes = [(64, l_dim), (l_dim,), (l_dim, 32), (32,), (l_dim, 32), (32,),
              (32, 1), (1,), (l_dim, 2), (2,)]
    p = gap.GatedPoolParams(*(torch.zeros(s, device=cuda_device)
                              for s in shapes))
    bag = torch.zeros(100, 64, device=cuda_device)
    with pytest.raises(ValueError):
        gap.gated_attention_pool(bag, p)
    with pytest.raises(ValueError):
        gap.gated_attention_pool_partial(bag, p)
    shapes = [(64, 1024), (1024,), (1024, 32), (32,), (1024, 32), (32,),
              (32, 1), (1,), (1024, 2), (2,)]
    p = gap.GatedPoolParams(*(torch.zeros(s, device=cuda_device)
                              for s in shapes))
    bag = torch.zeros(100, 64, device=cuda_device)
    with pytest.raises(ValueError):
        gap.gated_attention_pool(bag, p)
    with pytest.raises(ValueError):
        gap.gated_attention_pool_partial(bag, p)


@pytest.mark.cuda
def test_evaluate_fold_pools_every_full_bag_on_the_card(cuda_device,
                                                        tmp_path):
    """evaluate_fold's full-bag route on cuda (a gated clam_sb, bags not
    subsampled) launches the pool kernel once per slide, and its
    probabilities agree with the plain route (evaluate_split, the head's
    own forward on the card) within 1e-4."""
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        ckpt_path, save_params)
    from hipt_abmil_atec23_tpu_torch.engine.evaluate import evaluate_fold
    from hipt_abmil_atec23_tpu_torch.engine.train import (
        build_step_fns, evaluate_split)
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig
    rng = np.random.default_rng(0)
    bags = {f"s{i}": rng.standard_normal((n, 1024), dtype=np.float32)
            for i, n in enumerate((3000, 20_000, 517, 9000))}
    store = type("Store", (), {"load_features": lambda self, s: bags[s]})()
    cfg = ExperimentConfig.from_dict({
        "task": {"n_classes": 2}, "bags": {"max_patches_per_slide": None},
        "model": {"model_type": "clam_sb", "model_size": "small"}})
    ds = BagDataset(list(bags), np.array([0, 1, 0, 1]), store, cfg.bags)
    counts = np.array([2, 2])
    fns = build_step_fns(cfg, counts, 8, 1024, device=cuda_device)
    model = fns.init_params(torch.Generator().manual_seed(1))
    save_params(ckpt_path(str(tmp_path), 0), model)
    before = gap.gated_attention_pool.launches
    res = evaluate_fold(cfg, 0, ds, counts, str(tmp_path),
                        device=cuda_device)
    assert gap.gated_attention_pool.launches - before == len(bags)
    plain, _ = evaluate_split(fns, model, ds, ds.pad_size(),
                              np.random.default_rng(0))
    assert gap.gated_attention_pool.launches - before == len(bags)
    np.testing.assert_allclose(res.test_probs, plain, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def dct_slide():
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
        DctMemorySlide, he_like_planes)
    return DctMemorySlide(*he_like_planes(3, 2048)[1:])


@pytest.fixture(scope="module")
def edge_slide():
    """Hard edges at quality 92: AC values past int8 (the -128 sentinel and
    the int16 explicit tier) and dense escape bytes."""
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import DctMemorySlide
    y = np.zeros((512, 512), np.uint8)
    y[:, 256:] = 255
    y[::9] = 255
    c = np.full((256, 256), 128, np.uint8)
    c[:, 128:] = 20
    c[::5] = 240
    return DctMemorySlide(y, c, 255 - c, quality=92)


_WIDE = dict(cap_y_pb=62, cap_c_pb=62, cap_ge_y=992, cap_ge_c=992,
             cap_aesc_y=65536, cap_aesc_c=16384)


def _pack_on(r, qt, dev, valid=None):
    """A DctRegions read as the 30 pack tensors on ``dev``."""
    return [torch.from_numpy(a).to(dev) for a in r[:27]] + [
        torch.from_numpy(qt.astype(np.int32)).to(dev),
        torch.from_numpy(r.valid if valid is None
                         else np.asarray(valid, np.int32)).to(dev),
        torch.from_numpy(r.off).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("fixture,coords,size,caps,valid", [
    ("dct_slide", [[0, 0], [1024, 1024]], 1024, {}, None),
    ("dct_slide", [[8, 24], [1000, 2]], 512, {}, None),    # offset grid
    ("dct_slide", [[0, 0], [512, 256]], 256, dict(         # spilling caps
        cap_y_pb=4, cap_c_pb=2, cap_ge_y=4, cap_ge_c=2, cap_bm_y=2,
        cap_bm_c=1, cap_aesc_y=65536, cap_aesc_c=16384), None),
    ("edge_slide", [[0, 0], [256, 256]], 256, _WIDE, None),  # int16 escapes
    ("dct_slide", [[1800, 1796]], 256, {}, None),           # n 1, at the
    ("dct_slide", [[8, 24], [1000, 2], [1536, 512]], 512, {},  # slide edge
     [[511, 3], [1, 200], [0, 0]]),                     # n 3, short extents
    ("edge_slide", [[2, 6], [130, 256], [256, 0]], 256, _WIDE,
     [[255, 255], [37, 101], [256, 9]])])
def test_dct_decode_kernel_matches_plain(cuda_device, fixture, coords, size,
                                         caps, valid, request):
    """One launch decodes the three components: its coefficient tap equals
    the plain unpack bit for bit (integers times the quant table), and
    its planes (crop and white mask included) are within 1 LSB of the
    plain planes on at most 1e-3 of the samples (the IDCT sums in another
    order)."""
    from hipt_abmil_atec23_tpu_torch.ops import jpegdct
    slide = request.getfixturevalue(fixture)
    r = slide.read_regions_dct(np.array(coords), 0, (size, size), **caps)
    assert (r.status == 0).all()
    pack = _pack_on(r, slide.qt, cuda_device, valid)
    before = jpegdct.dct_regions_to_planes.launches
    with torch.inference_mode():
        *planes, taps = jpegdct.dct_regions_to_planes(*pack, tap=True)
        want = jpegdct.dct_regions_to_planes_reference(*pack)
        want_taps = [jpegdct._unpack_component(*pack[9 * c:9 * c + 9],
                                               pack[27][c])
                     for c in range(3)]
    torch.cuda.synchronize()
    assert jpegdct.dct_regions_to_planes.launches == before + 1
    for t, w in zip(taps, want_taps):
        assert t.shape == w.shape and torch.equal(t, w)
    for p, w in zip(planes, want):
        assert p.dtype == torch.uint8 and p.shape == w.shape
        d = (p.int() - w.int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3


@pytest.mark.cuda
def test_dct_decode_kernel_refuses_what_it_does_not_take(cuda_device,
                                                         dct_slide):
    """No quiet fallback: a wrong dtype, a non-contiguous stream, chroma
    that is not 4:2:0 or a stream that does not fit the block grid
    raises."""
    from hipt_abmil_atec23_tpu_torch.ops import jpegdct
    r = dct_slide.read_regions_dct(np.array([[0, 0]]), 0, (256, 256))
    pack = _pack_on(r, dct_slide.qt, cuda_device)
    bad = {"esc8 as uint8": {4: pack[4].to(torch.uint8)},
           "qt as f32": {27: pack[27].float()},
           "strided bmb": {2: torch.cat([pack[2], pack[2]], 1)[:, ::2]},
           "Y streams as Cb (4:4:4)": dict(enumerate(pack[:9], 9)),
           "short bmc": {1: pack[1][:, :-1].contiguous()},
           "valid [n, 3]": {28: torch.zeros(1, 3, dtype=torch.int32,
                                            device=cuda_device)}}
    for what, swap in bad.items():
        args = [swap.get(i, t) for i, t in enumerate(pack)]
        with pytest.raises(ValueError):
            jpegdct.dct_regions_to_planes(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape_y,shape_c", [
    ((2, 64, 256), (2, 32, 128)),      # 4:2:0, whole 16-pixel chunks
    ((3, 34, 50), (3, 17, 25)),        # 4:2:0, odd chroma edges
    ((2, 64, 256), (2, 64, 128)),      # 4:2:2
    ((1, 7, 38), (1, 7, 19))])         # 4:2:2, odd rows, ragged chunk
def test_colour_kernel_matches_plain(shape_y, shape_c, dtype, cuda_device):
    """The colour kernel keeps the plain version's f32 operations in their
    order (no FMA contraction, the reciprocal multiply of PyTorch's
    division by a scalar): equal bit for bit, bf16 and f32, at both
    chroma layouts, with H and W off its 16-pixel chunk."""
    from hipt_abmil_atec23_tpu_torch.ops import yuv
    g = torch.Generator().manual_seed(sum(shape_y))
    y, cb, cr = (torch.randint(0, 256, s, generator=g,
                               dtype=torch.uint8).to(cuda_device)
                 for s in (shape_y, shape_c, shape_c))
    before = yuv.ycc_to_input.launches
    with torch.inference_mode():
        got = yuv.ycc_to_input(y, cb, cr, dtype)
        want = yuv.ycc_to_input_reference(y, cb, cr, dtype)
    torch.cuda.synchronize()
    assert yuv.ycc_to_input.launches == before + 1
    assert got.shape == (*shape_y, 3) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape_y,shape_c", [
    ((2, 256, 256), (2, 128, 128)),    # 4:2:0 at the patch encoders' size
    ((3, 34, 50), (3, 17, 25)),        # 4:2:0, odd chroma edges
    ((1, 7, 38), (1, 7, 19))])         # 4:2:2, odd rows, ragged chunk
def test_colour_kernel_imagenet_mode_matches_plain(shape_y, shape_c, dtype,
                                                   cuda_device):
    """The ImageNet mode keeps the plain version's operations too: the
    reciprocal multiply of / 255, the subtraction of the mean tensor and
    the true division by the std tensor; equal bit for bit."""
    from hipt_abmil_atec23_tpu_torch.ops import yuv
    g = torch.Generator().manual_seed(sum(shape_y) + 1)
    y, cb, cr = (torch.randint(0, 256, s, generator=g,
                               dtype=torch.uint8).to(cuda_device)
                 for s in (shape_y, shape_c, shape_c))
    before = yuv.ycc_to_input.launches
    with torch.inference_mode():
        got = yuv.ycc_to_input(y, cb, cr, dtype, normalize="imagenet")
        want = yuv.ycc_to_input_reference(y, cb, cr, dtype, "imagenet")
        hipt = yuv.ycc_to_input(y, cb, cr, dtype)
    torch.cuda.synchronize()
    assert yuv.ycc_to_input.launches == before + 2
    assert got.shape == (*shape_y, 3) and got.dtype == dtype
    assert torch.equal(got, want) and not torch.equal(got, hipt)


@pytest.mark.cuda
def test_colour_kernel_refuses_what_it_does_not_take(cuda_device):
    from hipt_abmil_atec23_tpu_torch.ops import yuv
    y = torch.zeros(2, 32, 64, dtype=torch.uint8, device=cuda_device)
    c = torch.zeros(2, 16, 32, dtype=torch.uint8, device=cuda_device)
    for args, dtype in (((y.short(), c, c), torch.bfloat16),
                        ((y, c, c), torch.float16),
                        ((y, torch.cat([c, c], 2)[:, :, ::2], c),
                         torch.bfloat16),
                        ((y, c[:, :, :30].contiguous(),
                          c[:, :, :30].contiguous()), torch.bfloat16),
                        ((y, c, c[:, :8].contiguous()), torch.bfloat16),
                        ((y[0], c[0], c[0]), torch.bfloat16)):
        with pytest.raises(ValueError):
            yuv.ycc_to_input(*args, dtype)


def _within(got, want, atol, rtol):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all()
                and torch.isfinite(got).all())


def _mlp_inputs(rows, d, h, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    x = torch.randn(rows, d, generator=g).to(dev, bf16)
    w1 = (torch.randn(d, h, generator=g) * d ** -0.5).to(dev, bf16)
    w2 = (torch.randn(h, d, generator=g) * h ** -0.5).to(dev, bf16)
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).to(dev) for n in (h, d))
    gamma = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
    beta = (0.1 * torch.randn(d, generator=g)).to(dev)
    return x, gamma, beta, w1, b1, w2, b2


# Row counts around the kernel's 64-row tile (1, tile - 1, tile + 1, and the
# per-op slice's 512 x 257 tokens), every D class the model uses (32, 64,
# 192, 384) from H 64 up to 1536, and widths whose D / 2 output columns per
# warpgroup take several wgmma widths (96: 32 + 16, 160: 64 + 16, 224:
# 64 + 32 + 16, 256: 128, 288: 128 + 16, 352: 128 + 32 + 16)
MLP_TILE = 64
MLP_SHAPES = [(131, 384, 1536), (64, 192, 768), (5, 64, 256),
              (1000, 32, 128), (1, 384, 1536), (MLP_TILE - 1, 384, 1536),
              (MLP_TILE + 1, 384, 1536), (131584, 384, 1536),
              (200, 32, 64), (200, 64, 1536), (200, 192, 64), (200, 384, 64),
              (77, 96, 320), (77, 160, 640), (129, 224, 896),
              (70, 256, 1024), (130, 288, 1152), (129, 352, 1408)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("rows,d,h", MLP_SHAPES)
def test_fused_mlp_kernel_matches_plain(rows, d, h, with_ln, cuda_device):
    """bf16 kernel against the plain version (f32 products) on the card:
    |kernel - plain| <= 3e-2 + 5e-2 |plain| (the kernel's products round
    the normalised rows and the hidden to bf16); ragged row counts."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(rows, d, h, cuda_device)
    before = fm.fused_mlp.launches
    with torch.inference_mode():
        if with_ln:
            got = fm.fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2)
        else:
            got = fm.fused_mlp(x, w1, b1, w2, b2)
        want = fm.fused_mlp_reference(x, gamma, beta, w1, b1, w2, b2,
                                      with_ln=with_ln, residual=with_ln)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _within(got, want, 3e-2, 5e-2)


@pytest.mark.cuda
def test_fused_mlp_kernel_refuses_what_it_does_not_take(cuda_device):
    """No quiet fallback: f32 rows, D not a multiple of 32, H not a
    multiple of 64 and a transposed weight view raise."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(8, 64, 256, cuda_device)
    with pytest.raises(ValueError):
        fm.fused_mlp(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        fm.fused_mlp(x[:, :48], w1[:48], b1, w2[:, :48], b2[:48])
    with pytest.raises(ValueError):
        fm.fused_mlp(x, w1[:, :96], b1[:96], w2[:96], b2)
    with pytest.raises(ValueError):
        fm.fused_ln_mlp_residual(x, gamma, beta, w2.t(), b1, w1.t(), b2)


def _qkv(bh, n, d, dev, seed=0):
    """Unit-normal k and v, q at 3x: logits of std 3, a peaked softmax
    whose output a dropped key tile moves well past the tolerance."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(bh, n, d, generator=g) for _ in range(3))
    return [t.to(dev, torch.bfloat16) for t in (3 * q, k, v)]


def _attn_within(got, want):
    """|kernel - plain| <= 5e-2 rms(plain) + 2e-2 |plain|: the output's
    spread shrinks with N, so the atol follows it."""
    rms = want.float().square().mean().sqrt().item()
    return _within(got, want, 5e-2 * rms, 2e-2)


# The two-pass kernel's edges: the most valid keys its two shared-memory
# stages hold, and one 64-key chunk past them (streamed), at each head size
RES64, RES32 = fa.RESIDENT_KEYS[64], fa.RESIDENT_KEYS[32]
# the flash kernel's key tile
KT = fa.FLASH_KEY_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,valid,d", [
    (12, 257, 257, 64), (12, 257, 257, 32), (4, 264, 257, 64),
    (3, 100, 37, 32), (2, 1500, 1400, 64), (5, 1, 1, 64),
    (3, RES64, RES64, 64), (3, RES64 + 64, RES64 + 64, 64),
    (2, RES32, RES32 - 5, 32), (2, RES32 + 64, RES32 + 60, 32),
    (6, 200, 1, 64), (6, 200, 192, 64)])
def test_fused_attention_kernel_matches_plain(bh, n, valid, d, cuda_device):
    """Two-pass kernel against the plain version (the same rounding
    points): |kernel - plain| <= 5e-2 rms(plain) + 2e-2 |plain|; ragged
    N, masked keys, a medium N the dispatcher sends to the query-tiled
    branch, ViT-4K's 12 heads of 32 (a head's query tiles split over
    CTAs), the most keys held resident and one chunk past them (streamed),
    valid_len 1 and a multiple of 64."""
    q, k, v = _qkv(bh, n, d, cuda_device)
    before = fa.fused_attention.launches
    with torch.inference_mode():
        got = fa.fused_attention(q, k, v, valid)
        want = fa.fused_attention_reference(q, k, v, valid)
    torch.cuda.synchronize()
    assert fa.fused_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _attn_within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,valid,d", [
    (2, 768, 700, 64), (3, 300, 300, 32), (1, 70, 9, 64),
    (1, KT - 1, KT - 1, 64), (1, KT, KT, 64), (1, KT + 1, KT + 1, 64),
    (2, 1000, 777, 64), (3, 700, 650, 32)])
def test_flash_attention_kernel_matches_plain(bh, n, valid, d, cuda_device):
    """Online-softmax kernel against its f32 plain version: p rounds to
    bf16 for the product, so |kernel - plain| <= 5e-2 rms(plain) +
    2e-2 |plain|. N at the key tile and one either side, valid_len inside
    a tile, head size 32, several heads of several query blocks (the K/V
    ring wraps)."""
    q, k, v = _qkv(bh, n, d, cuda_device)
    before = fa.flash_attention.launches
    with torch.inference_mode():
        got = fa.flash_attention(q, k, v, valid)
        want = fa.flash_attention_reference(q, k, v, valid)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert _attn_within(got, want)


@pytest.mark.cuda
def test_attention_dispatch_takes_flash_at_long_n(cuda_device):
    """Past 12 MiB of bf16 K/V (N > 49152 at d=64) the dispatcher launches
    the flash kernel, as the JAX dispatcher takes its flash branch."""
    q, k, v = _qkv(1, 50_000, 64, cuda_device)
    assert fa.attention_branch(50_000, 64, 2) == "flash"
    before = (fa.fused_attention.launches, fa.flash_attention.launches)
    with torch.inference_mode():
        got = fa.attention(q, k, v, 49_000)
        want = fa.attention(q, k, v, 49_000, plain=True)
    torch.cuda.synchronize()
    assert (fa.fused_attention.launches, fa.flash_attention.launches) == (
        before[0], before[1] + 1)
    assert _attn_within(got, want)


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_do_not_take(cuda_device):
    """No quiet fallback: f32 operands, head size 48, valid_len 0 or past
    N and mismatched shapes raise."""
    q, k, v = _qkv(2, 40, 64, cuda_device)
    for fn in (fa.fused_attention, fa.flash_attention):
        with pytest.raises(ValueError):
            fn(q.float(), k.float(), v.float())
        with pytest.raises(ValueError):
            fn(q[..., :48], k[..., :48], v[..., :48])
        with pytest.raises(ValueError):
            fn(q, k, v, 0)
        with pytest.raises(ValueError):
            fn(q, k, v, 41)
        with pytest.raises(ValueError):
            fn(q, k[:, :20], v[:, :20])
