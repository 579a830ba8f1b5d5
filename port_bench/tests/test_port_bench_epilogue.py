"""The reader of epilogue_ms_per_mpx (metrics/epilogue_ms_per_mpx.py) on a
synthetic device trace: PyTorch's eager elementwise kernels and the port's
epilogue counted, the colour kernel, B.1's, the convolutions and the
copies not; the megapixels from the real items dispatched alone; None
where nothing it counts ran."""
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402
from port_bench.trace import DeviceTrace  # noqa: E402

READER = harness.load_module(
    harness.metric_path("epilogue_ms_per_mpx.resnet50"), "m_epilogue")

COUNTED = [
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16> > >(int, T1)",
     0, 100),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::(anon"
     "ymous namespace)::launch_clamp_scalar<...> >(int, T1, T2)", 100, 150),
    ("void (anonymous namespace)::conv_epilogue_kernel<__nv_bfloat16, true,"
     " false>(__nv_bfloat16*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, long, int)", 150, 180)]
NOT_COUNTED = [
    ("void (anonymous namespace)::ycc_kernel<__nv_bfloat16, true, true>("
     "unsigned char const*, long)", 200, 400),
    ("void (anonymous namespace)::gemm_kernel<2>(CUtensorMap_st, int)",
     400, 500),
    ("void (anonymous namespace)::layernorm_kernel<true>(float const*)",
     500, 520),
    ("void (anonymous namespace)::attention_kernel<64>(float const*)",
     520, 560),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::"
     "BFloat16, int>(c10::BFloat16 const*)", 560, 600),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x64x64", 600, 700),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda>(int)", 700, 710),
    ("Memcpy HtoD (Pinned -> Device)", 710, 800)]


def ctx(events, items=3, side=256):
    # batches of 2 items, the tail padded: 2 + 1 real items dispatched
    return SimpleNamespace(
        trace=DeviceTrace(events, 0, 1000),
        config={"encoder": {"input_size": side}},
        counts={"batch_items": [2, 1], "items_dispatched": items})


def test_counts_the_elementwise_work_per_real_mpx():
    # 180 ns of counted kernels over 3 real items of 256^2
    want = 180e-9 * 1e3 / (3 * 256 ** 2 / 1e6)
    got = READER.read(ctx(COUNTED + NOT_COUNTED))
    assert got == pytest.approx(want, rel=1e-12)
    assert READER.read(ctx(COUNTED)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,s,e", NOT_COUNTED)
def test_other_kernels_are_left_out(name, s, e):
    assert READER.read(ctx([(name, s, e)])) is None


def test_nothing_to_read():
    assert READER.read(ctx(NOT_COUNTED)) is None
    assert READER.read(ctx(COUNTED, items=0)) is None
