"""The port's ResNet trunks (hipt_abmil_atec23_tpu_torch/models/resnet.py:
ResNet50-trunc and ResNet-18, BatchNorm folded into the convolutions) held
against the JAX package's ResNetTrunk on the CPU.

One set of weights drives both packages: JAX variables with randomized
BatchNorm statistics (so a wrong fold shows), bridged with
models/convert.resnet_state_dict_from_jax. Tolerances: relative L2 <= 1e-5
in f32 (float rounding of the fold and another summation order); in bf16
cosine >= 0.999 and relative L2 <= 2e-2 per patch (bf16 rounding at other
places: the folded weights, the activations). Reference-layout and
Histo-prefixed .pth files load through the port's loader and through the
JAX package's resnet_params_from_torch to the same features."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hipt_abmil_atec23_tpu.models import resnet as jresnet
from hipt_abmil_atec23_tpu.models.convert import (
    load_torch_state_dict as jax_load_torch_state_dict,
    resnet_params_from_torch)
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.models import resnet
from hipt_abmil_atec23_tpu_torch.models.convert import (
    load_torch_state_dict, resnet_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.ops import conv_epilogue as ce
from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig

F32_REL = 1e-5
BF16_COS, BF16_REL = 0.999, 2e-2
ARCHS = {"resnet18": (resnet.resnet18, jresnet.resnet18, (2, 2, 2, 2),
                      False, 512),
         "resnet50": (resnet.resnet50_trunc, jresnet.resnet50_trunc,
                      (3, 4, 6), True, 1024)}


def _randomize(tree, rng, path=""):
    """Seeded JAX ResNet variables: He-scaled kernels, BatchNorm scale /
    bias / mean / var away from their identity values."""
    if isinstance(tree, dict):
        return {k: _randomize(v, rng, f"{path}/{k}") for k, v in tree.items()}
    shape = tree.shape
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        out = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
    elif leaf in ("scale", "var"):
        out = rng.uniform(0.5, 1.5, shape)
    else:   # bias, mean
        out = rng.normal(0, 0.1, shape)
    return out.astype(np.float32)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    name = request.param
    make, jmake, layers, bott, dim = ARCHS[name]
    shapes = jax.eval_shape(lambda: jmake().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables = _randomize(dict(shapes), np.random.default_rng(len(name)))
    return name, variables


def _port(name, variables, dtype=torch.float32):
    make, _, layers, bott, _ = ARCHS[name]
    m = make(dtype)
    m.load_state_dict(resnet_state_dict_from_jax(variables, layers, bott))
    return m.eval()


@functools.lru_cache(maxsize=None)
def _jax_apply(name, dtype=jnp.float32):
    """The JAX trunk's apply, jitted once per architecture and dtype."""
    return jax.jit(ARCHS[name][1](dtype=dtype).apply)


def _rel(got, want):
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


def _cos(got, want):
    return (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                  * np.linalg.norm(want, axis=1))


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 256, 256, 3)])
def test_resnet_matches_jax_f32(arch, shape):
    name, variables = arch
    x = np.random.default_rng(1).normal(0, 1, shape).astype(np.float32)
    want = np.asarray(_jax_apply(name)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(name, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], ARCHS[name][4])
    assert got.dtype == np.float32
    assert _rel(got, want).max() <= F32_REL, _rel(got, want)


def test_resnet_matches_jax_bf16(arch):
    name, variables = arch
    x = np.random.default_rng(2).normal(0, 1, (3, 64, 64, 3)
                                        ).astype(np.float32)
    want = np.asarray(_jax_apply(name, jnp.bfloat16)(variables,
                                                     jnp.asarray(x)))
    model = _port(name, variables, torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and model.input_dtype == torch.bfloat16
    assert _cos(got, want).min() >= BF16_COS, _cos(got, want)
    assert _rel(got, want).max() <= BF16_REL, _rel(got, want)


def test_fold_follows_the_weights(arch):
    """The fold is cached, and recomputed after an in-place change of a
    BatchNorm statistic or a load: the output follows the weights."""
    name, variables = arch
    model = _port(name, variables)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a = model(x)
        assert model.folded() is model.folded()
        model.bn1.running_var.mul_(4.0)
        b = model(x)
        model.load_state_dict(resnet_state_dict_from_jax(
            variables, *ARCHS[name][2:4]))
        c = model(x)
    assert not torch.allclose(a, b) and torch.equal(a, c)


def _torch_layout(name, variables, rng, extra):
    """The reference / torchvision state dict of these weights, with
    ``extra`` keys a full checkpoint carries beyond the trunk."""
    sd = {k: v.numpy() for k, v in resnet_state_dict_from_jax(
        variables, *ARCHS[name][2:4]).items()}
    for k in extra:
        sd[k] = rng.normal(size=(4,)).astype(np.float32)
    return sd


@pytest.mark.parametrize("layout", ["reference", "histo"])
def test_reference_checkpoints_load_like_jax(arch, layout, tmp_path):
    """A .pth in the reference layout (with the keys a full ResNet has
    past the trunk, fc and ResNet-50's layer4, ignored) or the Histo
    layout ({'state_dict': {'model.resnet.' ...}}) through
    load_torch_state_dict(checkpoint_key=None) and build_encoder's
    resnet_ckpt, against the JAX package's loader and
    resnet_params_from_torch on the same file: f32 features within 1e-5."""
    name, variables = arch
    rng = np.random.default_rng(4)
    extra = ("fc.weight", "fc.bias") + (
        ("layer4.0.conv1.weight",) if name == "resnet50" else ())
    sd = _torch_layout(name, variables, rng, extra)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    if layout == "histo":
        tsd = {"state_dict": {f"model.resnet.{k}": v
                              for k, v in tsd.items()}}
    path = str(tmp_path / f"{name}.pth")
    torch.save(tsd, path)
    jvars = resnet_params_from_torch(
        jax_load_torch_state_dict(path, checkpoint_key=None),
        layers=ARCHS[name][2], bottleneck=ARCHS[name][3])
    x = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(_jax_apply(name)(
        jvars, jresnet.imagenet_normalize(jnp.asarray(x))))
    loaded = resnet.load_resnet_(ARCHS[name][0](),
                                 load_torch_state_dict(path, None))
    enc = encode.build_encoder(EncoderConfig(
        model_type=name, batch_size=2, dtype="float32", resnet_ckpt=path),
        device="cpu")
    with torch.inference_mode():
        direct = loaded(resnet.imagenet_normalize(torch.from_numpy(x)))
        got = enc.apply(torch.from_numpy(x))
    for out in (direct.numpy(), got.numpy()):
        assert _rel(out, want).max() <= F32_REL


def test_missing_trunk_key_raises(arch):
    name, variables = arch
    sd = resnet_state_dict_from_jax(variables, *ARCHS[name][2:4])
    del sd["layer1.0.bn1.running_var"]
    with pytest.raises(KeyError, match="layer1.0.bn1.running_var"):
        resnet.load_resnet_(ARCHS[name][0](), sd)


def test_imagenet_normalize_matches_jax():
    x = np.random.default_rng(5).integers(0, 256, (2, 5, 7, 3),
                                          dtype=np.uint8)
    want = np.asarray(jresnet.imagenet_normalize(jnp.asarray(x)))
    got = resnet.imagenet_normalize(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    full = resnet.imagenet_normalize(torch.full((1, 1, 1, 3), 255,
                                                dtype=torch.uint8))
    np.testing.assert_allclose(
        full.numpy()[0, 0, 0], (1 - np.array(resnet.IMAGENET_MEAN))
        / np.array(resnet.IMAGENET_STD), rtol=1e-6)


def test_seeded_init_is_torchvision_scale():
    """resnet50_trunc(generator=...) draws kaiming-normal (fan_out) convs
    and identity BatchNorm, reproducibly from the seed."""
    a = resnet.resnet50_trunc(generator=torch.Generator().manual_seed(0))
    b = resnet.resnet50_trunc(generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    w = a.layer3[0].conv2.weight
    assert abs(w.std().item() / (2.0 / (256 * 9)) ** 0.5 - 1) < 0.05
    assert torch.equal(a.bn1.running_var, torch.ones(64))
    assert a.feat_dim == 1024


# ---------------------------------------------------------------- epilogue
def _eager_forward(model, x):
    """The trunk's forward as eager passes: F.conv2d with the folded bias,
    F.relu, then relu(out + res) at each block's end (the sequence the
    epilogue replaces)."""
    f = model.folded()

    def conv(t, k, stride=1, padding=0):
        return F.conv2d(t, f[k][0], f[k][1], stride, padding)
    x = x.to(model.dtype).permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(conv(x, "stem", 2, 3)), 3, 2, 1)
    for name, blk in model._blocks():
        if isinstance(blk, resnet.Bottleneck):
            out = F.relu(conv(x, f"{name}.1"))
            out = conv(F.relu(conv(out, f"{name}.2", blk.stride, 1)),
                       f"{name}.3")
        else:
            out = conv(F.relu(conv(x, f"{name}.1", blk.stride, 1)),
                       f"{name}.2", 1, 1)
        res = x if blk.downsample is None else \
            conv(x, f"{name}.down", blk.stride)
        x = F.relu(out + res)
    return x.mean((2, 3)).float()


@pytest.mark.parametrize("c", [64, 1024])
@pytest.mark.parametrize("residual", ["none", "identity", "downsample"])
def test_plain_epilogue_matches_the_eager_passes(c, residual):
    """conv_epilogue on the CPU (its plain version) against the eager
    sequence it replaces, in f32 on channels_last activations at layer1's
    and layer3's widths: relu(conv + b), relu(conv + b + x),
    relu(conv + b + down + b_down), to float rounding."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, c, 9, 7, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(c, c, 1, 1, generator=g) / c ** 0.5
    wd = torch.randn(c, c, 1, 1, generator=g) / c ** 0.5
    b, bd = torch.randn(c, generator=g), torch.randn(c, generator=g)
    res, res_b = {"none": (None, None), "identity": (x, None),
                  "downsample": (F.conv2d(x, wd), bd)}[residual]
    want = F.conv2d(x, w, b)
    if residual == "identity":
        want = want + x
    elif residual == "downsample":
        want = want + F.conv2d(x, wd, bd)
    want = F.relu(want)
    got = ce.conv_epilogue(F.conv2d(x, w), b, res, res_b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (got >= 0).all() and (got == 0).any()


def test_plain_epilogue_rounds_once():
    """In bf16 the plain version sums in f32 and rounds once: equal to the
    f32 sum of the same bf16 inputs rounded, not to the eager bf16 passes
    (which round after each)."""
    g = torch.Generator().manual_seed(8)
    a, r = (torch.randn(4, 16, 5, 3, generator=g).bfloat16()
            for _ in range(2))
    b, br = (torch.randn(16, generator=g).bfloat16() for _ in range(2))
    got = ce.conv_epilogue_reference(a, b, r, br)
    want = torch.relu((a.float() + b.float()[:, None, None])
                      + (r.float() + br.float()[:, None, None])).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(ValueError, match="bias_r without r"):
        ce.conv_epilogue(a, b, None, br)


def test_trunk_matches_its_eager_passes(arch):
    """The port's f32 forward (one epilogue per convolution) against the
    eager passes it replaced, same folded weights: float rounding."""
    name, variables = arch
    model = _port(name, variables)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        got, want = model(x), _eager_forward(model, x)
    assert _rel(got.numpy(), want.numpy()).max() <= 1e-6


def test_one_epilogue_per_conv_or_block_end(arch, monkeypatch):
    """40 epilogues per ResNet50-trunc forward (the stem, then conv1, conv2
    and conv3 of 13 blocks, each downsample folded into its block's last)
    and 17 per ResNet-18 (the stem, then two per block of 8); the residual
    rides the last epilogue of every block."""
    name, variables = arch
    calls = []

    def counted(a, bias, r=None, bias_r=None):
        calls.append((r is not None, bias_r is not None))
        return ce.conv_epilogue(a, bias, r, bias_r)
    monkeypatch.setattr(resnet, "conv_epilogue", counted)
    with torch.inference_mode():
        _port(name, variables)(torch.zeros(1, 64, 64, 3))
    n_blocks = sum(ARCHS[name][2])
    per_block = 3 if ARCHS[name][3] else 2
    assert len(calls) == {"resnet50": 40, "resnet18": 17}[name] \
        == 1 + per_block * n_blocks
    assert sum(res for res, _ in calls) == n_blocks
    # a downsample opens layer1..3 of ResNet50-trunc, layer2..4 of ResNet-18
    assert sum(rb for _, rb in calls) == 3
