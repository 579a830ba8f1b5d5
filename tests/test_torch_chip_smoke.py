"""chip_smoke.py's checks, held on the CPU against outputs with planted
faults: the tolerance it holds the attention kernels to must pass an output
rounded as the flash kernel rounds and fail a kernel that drops a key tile
or normalises twice; its fused_mlp check must pass an output rounded as the
MLP kernel rounds and fail one that drops a hidden chunk or leaves a row
tile unwritten; its pace window and its staged-against-overlapped check
must pass the streams' own outputs and fail planted faults."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from hipt_abmil_atec23_tpu_torch.ops import flash_attention as fa
from hipt_abmil_atec23_tpu_torch.ops import fused_mlp as fm

N = 16384       # long enough that unit logits give a near-uniform average
TILE = fa.FLASH_KEY_TILE  # the flash kernel's key tile


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



@pytest.mark.parametrize("n,nv,d", [(300, 211, 64), (97, 1, 32)])
def test_sdpa_yardstick_computes_the_kernels_function(n, nv, d):
    """chip_smoke's library call for both attention kernels, SDPA over the
    first nv keys, is the function the kernels compute (keys >= nv at
    -1e30): on the CPU in f32 it agrees with the plain oracle."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(3, n, d, generator=g) for _ in range(3))
    got = chip_smoke.sdpa_valid_keys(3 * q, k, v, nv)
    want = fa.attention_reference(3 * q, k, v, nv)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_stage_split_of_the_network_clock():
    """chip_smoke's B.8 stage split: a stage runs from the last departure to
    CTA 0's arrival, the barrier wait from arrival to departure, summed per
    stage kind over the blocks; a clock of the wrong length raises."""
    kinds = list(chip_smoke.STAGE_KINDS) * 2
    clock, now = [1000], 1000
    for i, _ in enumerate(kinds):
        now += (i + 1) * 1_000_000        # stage i takes (i + 1) ms
        clock.append(now)
        now += 10_000                     # then 0.01 ms at the barrier
        clock.append(now)
    split = chip_smoke.stage_split(clock, 2)
    n = len(chip_smoke.STAGE_KINDS)
    for i, kind in enumerate(chip_smoke.STAGE_KINDS):
        assert split[kind] == pytest.approx((i + 1) + (i + 1 + n))
        assert split["wait after"][kind] == pytest.approx(0.02)
    assert split["barriers"] == pytest.approx(0.01 * len(kinds))
    assert split["total"] == pytest.approx(
        sum(range(1, len(kinds) + 1)) + 0.01 * len(kinds))
    with pytest.raises(ValueError):
        chip_smoke.stage_split(clock[:-2], 2)


def test_block_launch_split_names_each_stage():
    """chip_smoke's B.1 split: profiler kernel names (demangled, with their
    arguments) map to the block's stages in a block's order, a stage met
    twice sums, and kernels of no stage are left out."""
    ns = "void (anonymous namespace)::"
    rows = {ns + "gemm_kernel<3>(CUtensorMap, CUtensorMap, int)": 0.4,
            ns + "layernorm_kernel<float>(float const*, float*)": 0.1,
            ns + "attention_kernel<64>(__nv_bfloat16 const*, int)": 0.3,
            ns + "gemm_kernel<0>(CUtensorMap, CUtensorMap, int)": 0.5,
            ns + "layernorm_kernel<__nv_bfloat16>(__nv_bfloat16 const*)": 0.2,
            "void at::native::vectorized_elementwise_kernel<4>(int)": 9.0}
    split = chip_smoke.block_launch_split(rows)
    assert list(split) == ["LN1", "QKV", "attention", "LN2", "FC2"]
    assert split["QKV"] == 0.5 and split["LN1"] == 0.2
    assert chip_smoke.block_launch_split(
        {**rows, ns + "attention_kernel<32>(int)": 0.05})[
            "attention"] == pytest.approx(0.35)


def test_kernel_ms_reads_device_time():
    """chip_smoke's profiler reader: device us summed over the calls to ms
    per call; this torch's own key_averages() rows and host rows, with no
    device time, are left out."""
    from types import SimpleNamespace as Row

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).add_(1)
    assert chip_smoke.kernel_ms(prof.key_averages(), 5) == {}
    rows = [Row(key="gemm_kernel<0>", device_time_total=1000.0),
            Row(key="aten::add_", device_time_total=0.0),
            Row(key="gemm_kernel<1>", device_time_total=500.0)]
    assert chip_smoke.kernel_ms(rows, 5) == {
        "gemm_kernel<0>": pytest.approx(0.2),
        "gemm_kernel<1>": pytest.approx(0.1)}


def _emulated_mlp(x, gamma, beta, w1, b1, w2, b2, fault=None):
    """fused_mlp's rounding on the CPU (LN in f32, its output and the
    post-GELU hidden rounded to bf16, f32 sums, residual on the loaded x)
    with a planted fault: one 64-unit hidden chunk left out, or one 64-row
    tile of the output never written (zeros)."""
    xf = x.float()
    xn = torch.nn.functional.layer_norm(xf, (x.shape[1],), gamma, beta,
                                        1e-6).to(torch.bfloat16).float()
    h = torch.nn.functional.gelu(xn @ w1.float() + b1)
    if fault == "dropped_chunk":
        h[:, 5 * 64:6 * 64] = 0
    out = (h.to(torch.bfloat16).float() @ w2.float() + b2 + xf).to(x.dtype)
    if fault == "unwritten_tile":
        out[64:128] = 0
    return out


@pytest.mark.parametrize("fault", [None, "dropped_chunk", "unwritten_tile"])
def test_mlp_check_rejects_planted_faults(fault):
    """chip_smoke's fused_mlp check at the slice's widths (D 384, H 1536) on
    its own input draw: the kernel-like output passes and each planted
    fault fails."""
    args = chip_smoke._mlp_inputs(200, 384, 1536,
                                  torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    want = fm.fused_mlp_reference(*args, with_ln=True, residual=True)
    got = _emulated_mlp(*args, fault=fault)
    if fault is None:
        chip_smoke._check("fused_mlp", "kernel-like", got, want,
                          chip_smoke.MLP_TOL)
    else:
        with pytest.raises(SystemExit):
            chip_smoke._check("fused_mlp", fault, got, want,
                              chip_smoke.MLP_TOL)


def test_mlp_chain_computes_the_kernels_function():
    """The bf16 torch chain chip_smoke times beside fused_mlp computes its
    function: in f32 it equals the plain version."""
    args = [t.float() for t in chip_smoke._mlp_inputs(
        50, 64, 256, torch.Generator().manual_seed(1), torch.device("cpu"))]
    want = fm.fused_mlp_reference(*args, with_ln=True, residual=True)
    got = chip_smoke._mlp_chain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _decode_case():
    """An offset pack of two 256^2 regions of the in-memory DCT slide and
    its plain planes and coefficient taps (CPU), and the chroma planes of
    the same pack cropped one chroma sample further right and down."""
    import numpy as np
    from hipt_abmil_atec23_tpu_torch.ops import jpegdct
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
        DctMemorySlide, he_like_planes)
    slide = DctMemorySlide(*he_like_planes(7, 1024)[1:])
    r = slide.read_regions_dct(np.array([[8, 24], [600, 2]]), 0, (256, 256))
    pack = ([torch.from_numpy(a) for a in r[:27]]
            + [torch.from_numpy(a) for a in (slide.qt.astype(np.int32),
                                             r.valid, r.off)])
    *planes, taps = jpegdct.dct_regions_to_planes(*pack, tap=True)
    pack[29] = pack[29] + 2          # the chroma crop at off / 2 + 1
    shifted = jpegdct.dct_regions_to_planes_reference(*pack)
    return planes, taps, shifted


@pytest.mark.parametrize("fault", [None, "coefficient", "column_shift",
                                   "chroma_crop"])
def test_decode_check_rejects_planted_faults(fault):
    """chip_smoke's decode check passes the plain decode against itself
    and fails one changed coefficient in a tap, a plane shifted by one
    column, and chroma planes cropped one sample off."""
    planes, taps, shifted = _decode_case()
    got_planes, got_taps = list(planes), [t.clone() for t in taps]
    if fault == "coefficient":
        got_taps[1][1, 17, 2, 3] += 1.0
    elif fault == "column_shift":
        p = planes[0]
        got_planes[0] = torch.cat([p[..., 1:], p[..., -1:]], -1)
    elif fault == "chroma_crop":
        got_planes[1:] = shifted[1:]
    if fault is None:
        assert chip_smoke.decode_check("plain", got_planes, got_taps,
                                       planes, taps) == 0
    else:
        with pytest.raises(SystemExit):
            chip_smoke.decode_check(fault, got_planes, got_taps, planes,
                                    taps)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fault", [None, "one_ulp", "swapped_chroma",
                                   "column_shift"])
def test_colour_check_rejects_planted_faults(fault, dtype):
    """chip_smoke's colour check passes the plain input and one that is 1
    bf16 ulp off, and fails Cb and Cr swapped and a column shift."""
    from hipt_abmil_atec23_tpu_torch.ops import yuv
    g = torch.Generator().manual_seed(3)
    y, cb, cr = (torch.randint(0, 256, s, generator=g, dtype=torch.uint8)
                 for s in ((2, 32, 48), (2, 16, 24), (2, 16, 24)))
    want = yuv.ycc_to_input_reference(y, cb, cr, dtype)
    got = want.clone()
    if fault == "one_ulp":
        w = want.float()
        got = (w + torch.ldexp(torch.ones_like(w),
                               torch.frexp(w).exponent - 8)).to(dtype)
    elif fault == "swapped_chroma":
        got = yuv.ycc_to_input_reference(y, cr, cb, dtype)
    elif fault == "column_shift":
        got = torch.cat([want[:, :, 1:], want[:, :, -1:]], 2)
    if fault in (None, "one_ulp"):
        chip_smoke.colour_check(str(fault), got, want)
    else:
        with pytest.raises(SystemExit):
            chip_smoke.colour_check(fault, got, want)


@pytest.mark.parametrize("fault", [None, "unthrottled", "copy_rate",
                                   "estimate_low", "no_estimate"])
def test_paced_rate_check_rejects_planted_faults(fault):
    """chip_smoke's pace window at 200 MB/s: a stream paced as the shim
    paces it (estimate just under the pace, wall just over its bytes' time
    at the pace) passes; a shim whose sleep was skipped (the wall a tenth
    of that), an estimate read from the copy's own time (GB/s), one 30%
    under the pace, or none at all fails."""
    pace = chip_smoke.PACE_MBPS
    stats = {"h2d_bytes": 400e6, "wire_mbps_final": 0.98 * pace}
    wall = 1.02 * stats["h2d_bytes"] / 1e6 / pace
    if fault == "unthrottled":
        wall /= 10
    elif fault == "copy_rate":
        stats["wire_mbps_final"] = 21000.0
    elif fault == "estimate_low":
        stats["wire_mbps_final"] = 0.7 * pace
    elif fault == "no_estimate":
        stats["wire_mbps_final"] = None
    if fault is None:
        assert chip_smoke.paced_rate_check(stats, wall, pace) == 0.98 * pace
    else:
        with pytest.raises(SystemExit):
            chip_smoke.paced_rate_check(stats, wall, pace)


@pytest.mark.parametrize("fault", [None, "flushes_swapped", "row_off",
                                   "slide_dropped", "order", "nan"])
def test_staged_check_rejects_planted_faults(fault):
    """chip_smoke's staged-against-overlapped comparison: the overlapped
    features themselves pass; a flush whose rows land in the other flush's
    place, one value off by 1e-4, a slide not yielded, slides yielded out
    of job order, or a NaN fails."""
    rng = np.random.default_rng(0)
    want = {"a": rng.standard_normal((4, 192)).astype(np.float32),
            "b": rng.standard_normal((4, 192)).astype(np.float32)}
    got = {k: v.copy() for k, v in want.items()}
    if fault == "flushes_swapped":
        got["a"] = np.roll(got["a"], 2, axis=0)
    elif fault == "row_off":
        got["b"][3, 7] += 1e-4
    elif fault == "slide_dropped":
        del got["b"]
    elif fault == "order":
        got = {"b": got["b"], "a": got["a"]}
    elif fault == "nan":
        got["a"][0, 0] = np.nan
    if fault is None:
        assert chip_smoke.staged_check("plane", got, want) == 0.0
    else:
        with pytest.raises(SystemExit):
            chip_smoke.staged_check("plane", got, want)


@pytest.mark.parametrize("fault", [None, "auc", "f1"])
def test_bootstrap_reference_is_the_jax_chunk(fault):
    """chip_smoke's numpy bootstrap (phase 10 (e)) computes the JAX
    package's _bootstrap_chunk on one index matrix (ties and one-class
    resamples included), and the 1e-6 check catches a chunk off in one
    metric."""
    import jax.numpy as jnp
    from hipt_abmil_atec23_tpu.engine.metrics import _bootstrap_chunk
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 2, 19).astype(np.int32)
    probs = np.round(rng.dirichlet([1, 1], 19), 1).astype(np.float32)
    idx = rng.integers(0, 19, (300, 19))
    idx[0] = np.where(labels == 0)[0][0]
    want = np.stack([np.asarray(v) for v in _bootstrap_chunk(
        jnp.asarray(labels), jnp.asarray(probs),
        jnp.asarray(probs.argmax(1).astype(np.int32)), jnp.asarray(idx), 2)])
    got = chip_smoke.bootstrap_reference(labels, probs, idx)
    if fault is not None:
        got[("auc", "f1").index(fault), 5] += 1e-5
    err = np.nanmax(np.abs(got - want))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert (err <= chip_smoke.BOOT_TOL) == (fault is None)


@pytest.fixture(scope="module")
def explain_slide():
    """One 1024^2 plane slide's pixels, its four 512^2 regions with seeded
    192-d features, the narrow HIPT widths of test_torch_hipt.py."""
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.models import vit
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import he_like_planes
    from test_torch_hipt import NARROW_256, NARROW_4K
    rgb = he_like_planes(10, 1024)[0]
    coords = chip_smoke.grid_coords(1024, 512)
    feats = np.random.default_rng(3).normal(size=(len(coords), 192)).astype(
        np.float32)
    widths = dict(vit256_cfg=dataclasses.replace(vit.VIT_CONFIGS["vit_small"],
                                                 **NARROW_256),
                  vit4k_cfg=vit.ViT4KConfig(**NARROW_4K))
    return rgb, coords, feats, widths


@pytest.mark.parametrize("fault", [None, "padded_probs", "softmaxed_scores"])
def test_phase_explain_rehearsal(fault, explain_slide, monkeypatch):
    """chip_smoke phase 11 at narrow widths on the CPU (512^2 regions,
    a [3000, 1024] bag), with read_counts counting the pool and block op
    calls (3 block calls per fused region_attention at depth 2 + 2): it
    passes on the port as it is, and stops on a planted fault:
    the last block's probabilities taken over the padded tokens (fused
    configuration: mass leaks to the pad keys), or infer_attention handing
    back softmaxed scores for a_raw."""
    from hipt_abmil_atec23_tpu_torch.models import vit
    from hipt_abmil_atec23_tpu_torch.models.abmil import MILOutput
    from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
    counts = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(vit, "fused_vit_block",
                        counting("fused_block", vit.fused_vit_block))
    monkeypatch.setattr(gap, "gated_attention_pool",
                        counting("gated_pool", gap.gated_attention_pool))
    monkeypatch.setattr(chip_smoke, "zero_counts", counts.clear)
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: {
        name: counts.get(name, 0) for name in chip_smoke.COUNTERS})
    if fault == "padded_probs":
        walk, probs, seen = vit._Encoder.walk, vit.Block.attention_probs, {}

        def remembering(self, tok, stop=None):
            for tok_n in walk(self, tok, stop):
                seen["tok"] = tok_n[0]
                yield tok_n

        def over_padded(self, x):
            # the walk's last tokens, pad rows included, sliced after softmax
            return probs(self, seen["tok"])[:, :, :x.shape[1], :x.shape[1]]

        monkeypatch.setattr(vit._Encoder, "walk", remembering)
        monkeypatch.setattr(vit.Block, "attention_probs", over_padded)
    elif fault == "softmaxed_scores":
        pooled = gap.apply_pooled

        def softmaxed(model, bag, mask=None):
            out = pooled(model, bag, mask)
            return MILOutput(out.logits, out.y_prob, out.y_hat,
                             torch.softmax(out.a_raw, -1), out.extras)

        monkeypatch.setattr(gap, "apply_pooled", softmaxed)
    rgb, coords, feats, widths = explain_slide
    clam = chip_smoke._random_clam(torch.Generator().manual_seed(1),
                                   torch.device("cpu"))
    run = functools.partial(
        chip_smoke.phase_explain, torch.device("cpu"), "cpu", rgb, coords,
        feats, clam, region=512, big_bag=(3000, 1024), widths=widths)
    if fault is None:
        # two calls of each: a warm-up and a timed one
        assert run() == {"launches": {**{k: 0 for k in chip_smoke.COUNTERS},
                                      "gated_pool": 4, "fused_block": 6},
                         "owned": {}}
    else:
        with pytest.raises(SystemExit, match="explain"):
            run()


def test_patch_grid_cuts_row_major_patches():
    """chip_smoke.patch_grid (the colour kernel's ImageNet-mode batch):
    patch i * n + j is the plane's window at row i, column j."""
    plane = np.arange(64 * 64, dtype=np.int32).reshape(64, 64)
    got = chip_smoke.patch_grid(plane, 2, 16)
    assert got.shape == (4, 16, 16) and got.flags.c_contiguous
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                got[i * 2 + j], plane[16 * i:16 * i + 16, 16 * j:16 * j + 16])


def test_memory_online_dataset_draws_like_the_port(monkeypatch):
    """chip_smoke's in-memory OnlineEncodingBagDataset (the card machine
    has no h5py) draws and encodes as the port's dataset does over the
    same coords and slide; encoder_gflop counts ResNet-18's 4.74 GFLOP
    per 256^2 patch."""
    from hipt_abmil_atec23_tpu_torch.data.online import (
        OnlineEncodingBagDataset)
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import he_like_planes
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        BagConfig, EncoderConfig)
    slide = chip_smoke.PlaneSlide(*he_like_planes(3, 512))
    coords = chip_smoke.grid_coords(512, 256)
    enc = chip_smoke.build_encoder(EncoderConfig(
        model_type="resnet18", batch_size=2, dtype="float32"), device="cpu")
    cfg = BagConfig(max_patches_per_slide=2)
    mem = chip_smoke.MemoryOnlineDataset(["s"], np.zeros(1, np.int32), enc,
                                         {"s": slide}, {"s": coords}, cfg)
    monkeypatch.setattr(OnlineEncodingBagDataset, "_load_coords",
                        lambda self, sid: (coords, {"patch_size": 256}))
    monkeypatch.setattr(OnlineEncodingBagDataset, "_open_slide",
                        lambda self, sid: slide)
    ref = OnlineEncodingBagDataset(["s"], np.zeros(1, np.int32), enc, {},
                                   "", cfg)
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(mem.get_bag(0, a), ref.get_bag(0, b))
    assert mem.pad_size() == 8
    assert abs(chip_smoke.encoder_gflop(enc.model, 256) - 4.737) < 1e-3
