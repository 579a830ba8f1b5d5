"""The port's sparse-DCT rung (hipt_abmil_atec23_tpu_torch/ops/jpegdct.py,
the in-memory packer and slide of slideio/synthetic.py, and the rung logic of
engine/encode.py) held against the JAX package and the native packer.

Packs come from the native reader over a 1024^2 synthetic JPEG YCbCr 4:2:0
TIFF at 256^2 regions: default caps, tight (spilling) caps, and an offset
grid off the 16 px MCU lattice."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.engine import encode as jenc
from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.ops import jpegdct as J
from hipt_abmil_atec23_tpu.slideio.reader import TiffSlide as JaxTiffSlide
from hipt_abmil_atec23_tpu.slideio.synthetic import (
    write_synthetic_slide as jax_write_synthetic_slide)
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.models.convert import (
    hipt_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.ops import jpegdct as P
from hipt_abmil_atec23_tpu_torch.slideio.reader import (
    TiffSlide, dct_group_size)
from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
    DctMemorySlide, he_like_planes, jpeg_quant_tables, pack_dct_v3)
from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig
from test_torch_hipt import narrow_jax_hipt, narrow_params, narrow_port_hipt

FIELDS = "dc8 bmc bmb valn esc8 aidx aval didx dval".split()
TIGHT = dict(cap_y_pb=4, cap_c_pb=2, cap_ge_y=4, cap_ge_c=2, cap_bm_y=2,
             cap_bm_c=1, cap_aesc_y=65536, cap_aesc_c=16384)
PACKS = {"default": ([[0, 0], [256, 256], [512, 128]], {}),
         "tight": ([[0, 0], [512, 128]], TIGHT),
         "offset": ([[8, 24], [136, 6], [520, 394]], {})}


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_dct") / "ycbcr.tif")
    jax_write_synthetic_slide(path, 1024, 1024, n_levels=2, seed=3,
                              ycbcr420=True)
    s = TiffSlide(path)
    yield s
    s.close()


@pytest.fixture(scope="module")
def packs(slide):
    out = {}
    for name, (coords, caps) in PACKS.items():
        r = slide.read_regions_dct(np.array(coords), 0, (256, 256), **caps)
        assert (r.status == 0).all()
        out[name] = r
    # the packs exercise what the tests are about
    assert (out["tight"].cnts[:, :, 1] > 0).any()      # spills
    assert out["default"].cnts[:, :, 4].max() > 0      # escape bytes
    assert out["offset"].off.shape == (3, 2)
    return out


def _component(r, c):
    pre = ("y", "cb", "cr")[c]
    return [getattr(r, f"{pre}_{f}") for f in FIELDS]


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port_pack(r, qt):
    return _torch(r[:27]) + _torch([qt.astype(np.int32), r.valid, r.off])


@pytest.mark.parametrize("pack", list(PACKS))
@pytest.mark.parametrize("jax_path", ["xla", "interpret_kernel"])
def test_unpack_component_matches_jax_bit_for_bit(pack, jax_path, packs,
                                                  slide, monkeypatch):
    """Dequantized coefficient blocks [n, bl, 8, 8]: the port's plain
    unpack equals the JAX _unpack_component exactly, against its XLA path
    and its Pallas kernel in interpret mode (integers times the table, no
    rounding anywhere)."""
    monkeypatch.setattr(J, "_FORCE_KERNEL", jax_path != "xla")
    monkeypatch.setattr(J, "_KERNEL_INTERPRET", jax_path != "xla")
    r, qt = packs[pack], slide.dct_probe(0)
    for c in range(3):
        f = _component(r, c)
        want = np.asarray(J._unpack_component(*f, qt[c]))
        got = P._unpack_component(*_torch(f),
                                  torch.from_numpy(qt[c].astype(np.int32)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pack", list(PACKS))
def test_planes_match_jax(pack, packs, slide):
    """uint8 planes (crop and white mask included) within 1 LSB of the JAX
    planes, mean |d| < 1e-3: the f32 IDCT sums in another order."""
    r, qt = packs[pack], slide.dct_probe(0)
    want = J.dct_regions_to_planes(*r[:27], qt, r.valid, r.off)
    got = P.dct_regions_to_planes(*_port_pack(r, qt))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and tuple(g.shape) == w.shape
        d = np.abs(g.numpy().astype(np.int16) - np.asarray(w, np.int16))
        assert d.max() <= 1 and d.mean() < 1e-3, (d.max(), d.mean())


@pytest.mark.parametrize("pack", ["default", "offset"])
def test_rgb_matches_jax(pack, packs, slide):
    """f32 RGB within atol 1e-4 of the JAX path, test_torch_yuv's band for
    the colour step, where the planes agree; pixels where a plane differs
    by 1 LSB may move by at most 1.772 x 1 (the largest colour weight)."""
    r, qt = packs[pack], slide.dct_probe(0)
    want = np.asarray(J.dct_regions_to_rgb(*r[:27], qt, r.valid, r.off))
    got = P.dct_regions_to_rgb(*_port_pack(r, qt)).numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1.772 + 1e-4
    assert (d <= 1e-4).mean() > 0.999


def test_escape_pads_never_land(packs, slide):
    """idx = -1 pads of the explicit streams must not reach the planes
    (torch has no mode='drop'): poisoning the pad values leaves every plane
    bit-identical."""
    r, qt = packs["default"], slide.dct_probe(0)
    assert (r.y_didx == -1).any() and (r.y_aidx == -1).any()
    r2 = r._replace(
        y_aval=np.where(r.y_aidx < 0, 999, r.y_aval).astype(np.int16),
        y_dval=np.where(r.y_didx < 0, 30000, r.y_dval).astype(np.int16))
    a = P.dct_regions_to_planes(*_port_pack(r, qt))
    b = P.dct_regions_to_planes(*_port_pack(r2, qt))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("pack", list(PACKS))
def test_pack_dct_v3_repacks_native_bytes(pack, packs):
    """Dense coefficients recovered from a native pack (the plain unpack
    with a unit table) repack into the native arrays byte for byte at the
    same caps, demand counts included; the explicit streams' pad values are
    0 in the twin and unwritten in the native packer, so they compare where
    the index is valid."""
    r = packs[pack]
    for c in range(3):
        f = _component(r, c)
        n, bh, bw = f[0].shape
        ng = -(-(bh * bw) // P._G)
        caps = (f[3].shape[1] * 2 // ng, f[4].shape[1] // ng, f[5].shape[1],
                f[7].shape[1], f[2].shape[1] // ng)
        dense = P._unpack_component(*_torch(f), torch.ones(64)).numpy()
        for i in range(n):
            out = pack_dct_v3(np.rint(dense[i]).astype(np.int16).reshape(
                -1, 64), bw, bh, caps)
            assert out[-1]
            for name, got, want in zip(FIELDS, out, (a[i] for a in f)):
                if name in ("aval", "dval"):
                    idx = f[5 if name == "aval" else 7][i]
                    want = np.where(idx >= 0, want, 0)
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got.reshape(want.shape), want,
                                              err_msg=name)
            np.testing.assert_array_equal(out[9], r.cnts[i, c])


def test_pack_dct_v3_flags_explicit_overflow(packs):
    """An explicit stream past its cap is reported, as the native packer
    reports it (the region then goes to a pixel read)."""
    r = packs["tight"]
    f = _component(r, 0)
    dense = P._unpack_component(*_torch(f), torch.ones(64)).numpy()[0]
    bh, bw = f[0].shape[1:]
    out = pack_dct_v3(np.rint(dense).astype(np.int16).reshape(-1, 64), bw,
                      bh, (4 * 16, 4, 16, 4096, 2 * 16))
    assert not out[-1]


def test_group_size_and_quant_tables_match_native(slide):
    """ops/jpegdct._G is the native kDctGroup, and the in-memory slide's
    quality-80 tables are the ones libjpeg wrote into the TIFF."""
    assert P._G == dct_group_size(slide._lib)
    np.testing.assert_array_equal(jpeg_quant_tables(80), slide.dct_probe(0))


@pytest.fixture(scope="module")
def mem_slide():
    return DctMemorySlide(*he_like_planes(4, 1024)[1:])


@pytest.mark.parametrize("coords,size", [([[0, 0], [512, 256]], 256),
                                         ([[8, 24], [600, 2]], 256)])
def test_memory_slide_decodes_like_its_planes(coords, size, mem_slide):
    """The in-memory slide's packs decode on the port within 1 LSB of its
    own plane decode (f64 numpy vs f32 torch IDCT), aligned and offset."""
    coords = np.array(coords)
    r = mem_slide.read_regions_dct(coords, 0, (size, size))
    assert (r.status == 0).all()
    got = P.dct_regions_to_planes(*_port_pack(r, mem_slide.qt))
    want = mem_slide.read_regions_yuv420(coords, 0, (size, size))
    for g, w in zip(got, want):
        d = np.abs(g.numpy().astype(np.int16) - w.astype(np.int16))
        assert d.max() <= 1 and d.mean() < 1e-3


def test_memory_slide_flags_odd_origins(mem_slide):
    r = mem_slide.read_regions_dct(np.array([[7, 0], [0, 0]]), 0, (256, 256))
    assert (r.status == 1).all()
    assert mem_slide.dct_probe(1) is None
    with pytest.raises(IOError):
        mem_slide.read_regions_yuv420(np.array([[7, 0]]), 0, (256, 256))


def test_select_rung_matches_jax():
    """The port's select_rung equals the JAX one over a grid of wire rates,
    feasible sets, DCT sizes, sitting rungs and cost tables."""
    host = {"dct": 11.6, "yuv": 7.8, "rgb": 107.0}
    dev = {"dct": 6.0, "yuv": 3.3, "rgb": 3.3}
    n = 0
    for feasible in (["rgb"], ["rgb", "yuv"], ["rgb", "yuv", "dct"],
                     ["yuv", "dct"]):
        for mbps in (None, 0.0, 5.0, 55.0, 400.0, 3000.0, 25000.0):
            for dct_bpp in (None, 0.4, 0.9):
                for current in (None, "yuv", "dct", "rgb"):
                    for yuv_bpp in (None, 2.0):
                        kw = dict(dct_bytes_per_px=dct_bpp, current=current,
                                  host_ms_mpx=host, dev_ms_mpx=dev,
                                  yuv_bytes_per_px=yuv_bpp)
                        assert encode.select_rung(
                            feasible, mbps, 4096 ** 2, **kw) == \
                            jenc.select_rung(feasible, mbps, 4096 ** 2, **kw)
                        n += 1
    assert n == 4 * 7 * 3 * 4 * 2


def _jax_dct_encoder(params, batch):
    model = narrow_jax_hipt(jnp.float32)

    @jax.jit
    def fwd(v, x):
        return model.apply(v, jhipt.hipt_eval_normalize(x))

    @jax.jit
    def fwd_dct(v, *pack):
        return model.apply(v, J.dct_regions_to_rgb(*pack) / 127.5 - 1.0)

    v = jax.device_put(params)
    return jenc.Encoder(name="HIPT_4K", apply=partial(fwd, v),
                        batch_size=batch, input_size=256, feat_dim=192,
                        variables=v, apply_yuv=None,
                        apply_dct=partial(fwd_dct, v), jit_fwd=fwd,
                        jit_fwd_dct=fwd_dct)


def test_encode_stream_dct_rung_matches_jax(slide):
    """encode_stream on the DCT rung (narrow f32 HIPT, batch 2 over 5
    regions, so the tail batch pads its escape indices with -1): the
    port's features within 1e-4 of the JAX stream's on the same slide and
    weights, every region on the DCT rung in both, with the same caps."""
    params = narrow_params(seed=2)
    coords = np.array([[0, 0], [256, 0], [0, 256], [512, 512], [256, 768]])
    jstats, tstats = {}, {}
    jslide = JaxTiffSlide(slide.path)
    try:
        want = dict(jenc.encode_stream([("a", jslide, coords)],
                                       _jax_dct_encoder(params, 2),
                                       region_size=256, stats=jstats,
                                       adaptive_rungs=False))
    finally:
        jslide.close()
    enc = encode.build_encoder(
        EncoderConfig(model_type="HIPT_4K", batch_size=2, dtype="float32"),
        device="cpu", model=narrow_port_hipt(torch.float32),
        state_dict=hipt_state_dict_from_jax(params))
    got = dict(encode.encode_stream([("a", slide, coords)], enc,
                                    region_size=256, stats=tstats,
                                    adaptive_rungs=False))
    assert jstats["regions_dct"] == tstats["regions_dct"] == 5
    assert tstats["dct_caps"] == jstats["dct_caps"]
    assert got["a"].shape == want["a"].shape == (5, 192)
    np.testing.assert_allclose(got["a"], want["a"], rtol=0, atol=1e-4)
    # the same stream with the DCT rung off rides the plane rung
    pstats = {}
    plain = dict(encode.encode_stream(
        [("a", slide, coords)], dataclasses.replace(enc, dct_rung=False),
        region_size=256, stats=pstats))
    assert pstats.get("regions_dct", 0) == 0 and pstats["regions_yuv"] == 5
    assert np.abs(plain["a"] - got["a"]).max() < 5e-2


def test_adaptive_stream_without_a_wire_keeps_the_dct_rung(slide):
    """On the CPU there is no copy to time, so an adaptive stream never has
    a wire estimate: it keeps the byte-lightest rung and decides nothing,
    while it still calibrates the host and device tables of the rung it
    rode."""
    enc = encode.build_encoder(
        EncoderConfig(model_type="HIPT_4K", batch_size=2, dtype="float32"),
        device="cpu", model=narrow_port_hipt(torch.float32))
    coords = np.array([[0, 0], [256, 0], [0, 256]])
    st = {}
    dict(encode.encode_stream([("a", slide, coords)], enc, region_size=256,
                              stats=st))
    assert st["regions_dct"] == 3 and "rung_decisions" not in st
    assert st["wire_mbps_final"] is None
    cal = st["rung_calibration"]
    assert cal["host_ms_mpx"]["dct"] != encode.RUNG_HOST_MS_PER_MPX["dct"]
    assert cal["dev_ms_mpx"]["dct"] != encode.RUNG_DEV_MS_PER_MPX["dct"]
    assert cal["host_ms_mpx"]["yuv"] == encode.RUNG_HOST_MS_PER_MPX["yuv"]


def _edge_slide():
    """Hard edges at quality 92: AC values past int8 and DC deltas past
    int8, so both explicit streams carry entries."""
    y = np.zeros((512, 512), np.uint8)
    y[:, 256:] = 255
    y[::9] = 255
    y[100:300:7, ::3] = 0
    c = np.full((256, 256), 128, np.uint8)
    c[:, 128:] = 20
    c[::5] = 240
    return DctMemorySlide(y, c, 255 - c, quality=92)


def _assert_ascending_then_pads(idx, what):
    """Valid entries strictly ascending, every -1 pad after them."""
    for i, row in enumerate(idx):
        k = int((row >= 0).sum())
        assert (row[k:] == -1).all(), (what, i)
        assert (np.diff(row[:k]) > 0).all(), (what, i)


@pytest.mark.parametrize("source", ["native", "numpy"])
def test_packers_write_explicit_escapes_in_ascending_order(source, packs,
                                                           slide):
    """The decode kernel finds a group's |v| > 127 escapes (aidx, by
    coefficient) and a row's DC escapes (didx, by block) by binary search:
    both packers must write the valid entries in ascending order with the
    idx = -1 pads after them. Packs with spilled coefficients and with DC
    escapes, aligned and off the MCU lattice."""
    if source == "native":
        rs = list(packs.values())
    else:
        edge = _edge_slide()
        wide = dict(cap_aesc_y=65536, cap_aesc_c=16384)
        rs = [edge.read_regions_dct(np.array(c), 0, (256, 256), **caps)
              for c, caps in (([[0, 0], [256, 256]], TIGHT),
                              ([[8, 24], [130, 6]], wide),
                              ([[0, 0]], wide))]
    n_a = n_d = 0
    for r in rs:
        assert (r.status == 0).all()
        for c in range(3):
            f = dict(zip(FIELDS, _component(r, c)))
            _assert_ascending_then_pads(f["aidx"], "aidx")
            _assert_ascending_then_pads(f["didx"], "didx")
            n_a += int((f["aidx"] >= 0).sum())
            n_d += int((f["didx"] >= 0).sum())
    assert n_a > 50 and n_d > 5, (n_a, n_d)   # the streams are exercised


@pytest.mark.parametrize("pack", ["default", "offset"])
def test_planes_tap_on_the_cpu_is_the_plain_unpack(pack, packs, slide):
    """On a CPU pack dct_regions_to_planes is its plain version, and its
    coefficient tap is _unpack_component's output, component by
    component."""
    r, qt = packs[pack], slide.dct_probe(0)
    args = _port_pack(r, qt)
    before = P.dct_regions_to_planes.launches
    *planes, taps = P.dct_regions_to_planes(*args, tap=True)
    want = P.dct_regions_to_planes_reference(*args)
    assert P.dct_regions_to_planes.launches == before
    for g, w in zip(planes, want):
        assert torch.equal(g, w)
    for c in range(3):
        f = _torch(_component(r, c))
        assert torch.equal(taps[c], P._unpack_component(
            *f, torch.from_numpy(qt[c].astype(np.int32))))
