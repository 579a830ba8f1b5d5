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

from hipt_abmil_atec23_tpu.models import resnet as jresnet
from hipt_abmil_atec23_tpu.models.convert import (
    load_torch_state_dict as jax_load_torch_state_dict,
    resnet_params_from_torch)
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.models import resnet
from hipt_abmil_atec23_tpu_torch.models.convert import (
    load_torch_state_dict, resnet_state_dict_from_jax)
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
