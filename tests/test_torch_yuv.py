"""The port's YCbCr -> RGB reconstruction (hipt_abmil_atec23_tpu_torch/ops/
yuv.py) held against the JAX package's ops/yuv.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.ops import yuv as jyuv
from hipt_abmil_atec23_tpu_torch.ops import yuv


def _planes(rng, shape_y, shape_c):
    return tuple(rng.integers(0, 256, size=s, dtype=np.uint8)
                 for s in (shape_y, shape_c, shape_c))


@pytest.mark.parametrize("layout,shape_c", [
    ("420", (2, 16, 24)), ("422", (2, 32, 24))])
def test_planes_to_rgb_match_jax(layout, shape_c, rng):
    """Full 0..255 range, 4:2:0 and 4:2:2, direct and dispatched entries:
    atol 1e-4 on values in 0..255 (f32 arithmetic in one order)."""
    y, cb, cr = _planes(rng, (2, 32, 48), shape_c)
    jfn = jyuv.yuv420_to_rgb if layout == "420" else jyuv.yuv422_to_rgb
    fn = yuv.yuv420_to_rgb if layout == "420" else yuv.yuv422_to_rgb
    want = np.asarray(jfn(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    args = [torch.from_numpy(a) for a in (y, cb, cr)]
    for got in (fn(*args), yuv.yuv_planes_to_rgb(*args)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert want.min() >= 0 and want.max() <= 255


@pytest.mark.parametrize("shape_c", [(1, 8, 4), (1, 8, 10), (1, 6, 5)])
def test_plane_geometry_is_checked_in_both_dimensions(shape_c, rng):
    """Y [16, 10]: chroma that halves the rows but not the columns is
    neither 4:2:0 nor 4:2:2 and raises (the JAX dispatch checks only the
    rows in its 4:2:0 branch)."""
    y, cb, cr = (torch.from_numpy(a) for a in
                 _planes(rng, (1, 16, 10), shape_c))
    with pytest.raises(ValueError, match="unsupported plane geometry"):
        yuv.yuv_planes_to_rgb(y, cb, cr)


def test_mismatched_chroma_planes_raise(rng):
    y, cb, _ = (torch.from_numpy(a) for a in
                _planes(rng, (1, 16, 16), (1, 8, 8)))
    with pytest.raises(ValueError):
        yuv.yuv_planes_to_rgb(y, cb, cb[:, :4])


def _bf16_ulp(x):
    """One bf16 ulp of each value's binade."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape_y,shape_c", [
    ((2, 34, 50), (2, 17, 25)),        # 4:2:0, odd chroma edges
    ((1, 32, 48), (1, 16, 24)),        # 4:2:0
    ((2, 7, 38), (2, 7, 19)),          # 4:2:2, odd rows and chroma width
    ((1, 32, 48), (1, 32, 24))])       # 4:2:2
def test_encoder_input_matches_jax(shape_y, shape_c, dtype, rng):
    """ycc_to_input_reference (the colour kernel's plain version) against
    the JAX package's yuv_planes_to_rgb / 127.5 - 1: atol 1e-4 in f32 (the
    band of test_planes_to_rgb_match_jax), and within 1 bf16 ulp of the
    JAX value once rounded to bf16."""
    y, cb, cr = _planes(rng, shape_y, shape_c)
    want = np.asarray(jyuv.yuv_planes_to_rgb(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)) / 127.5 - 1.0)
    got = yuv.ycc_to_input_reference(*(torch.from_numpy(a)
                                       for a in (y, cb, cr)), dtype)
    assert got.dtype == dtype and got.shape == want.shape
    w = torch.from_numpy(want)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    else:
        assert bool(((got.float() - w).abs() <= _bf16_ulp(w)).all())


def test_encoder_input_on_the_cpu_is_the_plain_version(rng):
    """CPU planes never reach the kernel: ycc_to_input is its plain
    version there, with or without plain=True, and counts no launch."""
    args = [torch.from_numpy(a) for a in _planes(rng, (2, 32, 48),
                                                 (2, 16, 24))]
    before = yuv.ycc_to_input.launches
    want = yuv.ycc_to_input_reference(*args, torch.bfloat16)
    for plain in (False, True):
        assert torch.equal(yuv.ycc_to_input(*args, plain=plain), want)
    assert yuv.ycc_to_input.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape_y,shape_c", [
    ((2, 34, 50), (2, 17, 25)),        # 4:2:0, odd chroma edges
    ((1, 32, 48), (1, 16, 24)),        # 4:2:0
    ((2, 7, 38), (2, 7, 19)),          # 4:2:2, odd rows and chroma width
    ((1, 32, 48), (1, 32, 24))])       # 4:2:2
def test_imagenet_input_matches_jax(shape_y, shape_c, dtype, rng):
    """The colour kernel's ImageNet mode (the ResNet and LeViT encoders'
    input) in its plain version against the JAX package's
    imagenet_normalize(yuv_planes_to_rgb(...)) (engine/encode.py:346-357):
    atol 1e-5 in f32 (values within about +-2.7; the /255 and /std steps
    in one order), within 1 bf16 ulp of the JAX value once rounded."""
    from hipt_abmil_atec23_tpu.models.resnet import imagenet_normalize
    y, cb, cr = _planes(rng, shape_y, shape_c)
    want = np.asarray(imagenet_normalize(jyuv.yuv_planes_to_rgb(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))))
    args = [torch.from_numpy(a) for a in (y, cb, cr)]
    got = yuv.ycc_to_input_reference(*args, dtype, "imagenet")
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(yuv.ycc_to_input(*args, dtype, normalize="imagenet"),
                       got)
    w = torch.from_numpy(want)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        assert bool(((got.float() - w).abs() <= _bf16_ulp(w)).all())


def test_hipt_mode_is_the_default_and_unchanged(rng):
    """normalize="hipt" is the default and still RGB / 127.5 - 1 of the
    same planes bit for bit; an unknown mode raises."""
    args = [torch.from_numpy(a) for a in _planes(rng, (2, 32, 48),
                                                 (2, 16, 24))]
    want = (yuv.yuv_planes_to_rgb(*args) / 127.5 - 1.0).to(torch.bfloat16)
    for got in (yuv.ycc_to_input(*args),
                yuv.ycc_to_input(*args, normalize="hipt"),
                yuv.ycc_to_input_reference(*args)):
        assert torch.equal(got, want)
    assert not torch.equal(yuv.ycc_to_input(*args, normalize="imagenet"),
                           want)
    with pytest.raises(ValueError, match="normalize"):
        yuv.ycc_to_input(*args, normalize="dino")
