"""The port's trace attribution (`profiling/trace.py`) on Chrome traces.

A hand-built trace carries a kernel of every family, copies and fills,
and the events that are not device time (CPU ops, runtime calls, flow
events, a GPU annotation spanning the kernels): the family sums, the top
kernels and the copy totals are held exactly, in picoseconds.  A real trace
of the trainer's ``CSDT_PROFILE_DIR`` window on the CPU (the FCN toy) has
no device event and attributes zero device time.  The CLI prints JSON.  The
result's keys are those of JAX's `profiling.xplane.attribute` on the
XSpace that `tests/test_xplane.py` builds.
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax  # noqa: F401  (the parity files import both frameworks)
import pytest
import torch

from conditional_score_diffusion_tpu.profiling import xplane as jax_xplane
from conditional_score_diffusion_tpu_torch import profiling
from conditional_score_diffusion_tpu_torch.configs import toy_gaussian_bubbles_config
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer
from test_xplane import _toy_xspace_bytes

torch.set_num_threads(1)

# (kernel name as torch's trace writes it, family, launches, durations in us)
KERNELS = [
    ("void (anonymous namespace)::conv3x3_gemm<Conv3x3Config<float, 64, 128, 4>, Problem>(Problem)",
     "conv3x3_gemm", [101.125, 99.875, 100.5]),
    ("void gn_silu_act<float, __nv_bfloat16>(float const*, float const*, int, int)", "gn_silu_act", [7.001, 6.999]),
    ("void fir_up2_kernel<float, 4>(float const*, float*, int, int, int, int, long, Taps)", "fir_up2_kernel", [3.25]),
    ("void fir_down2_kernel<float, 4>(float const*, float*, int, int, int, int, long, Taps)", "fir_down2_kernel",
     [2.125]),
    ("void bias_act_vec4_kernel<float, int>(float const*, float const*, float*, int, int, Act)", "bias_act", [1.5]),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32", "convolution (cuDNN)",
     [50.0, 51.0]),
    ("void fft2d_r2c_32x32<float, false, 1u, false>(float2*, float const*, int, int)", "convolution (cuDNN)", [12.5]),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false>(...)", "copy/cast", [4.0]),
    ("void internal::region_transform_ABC_val<int, 32, 32, false, internal::TransformParamsABC<float2> >(...)",
     "convolution (cuDNN)", [6.5]),
    ("void DSE::regular_fft_clip<1, 2, 256, 16, 16, 1, float, float, float2>(float*, float2*, int, int3)",
     "convolution (cuDNN)", [2.75]),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_warpsize2x2x1_ffma_aligna8",
     "convolution (cuDNN)", [3.5]),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int, int, int, int, int, float2)",
     "convolution (cuDNN)", [1.75]),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collective (NCCL)", [0.9]),
    ("nvjet_tst_96x256_64x4_1x4_h_bz_coopA_bias_TNN", "gemm (cuBLAS)", [0.05]),
    ("void at::native::(anonymous namespace)::upsample_nearest2d_nhwc_out_frame<c10::BFloat16>(...)", "elementwise",
     [0.04]),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16_warpgroupsize1x1x1", "gemm (cuBLAS)", [20.0]),
    ("ampere_sgemm_128x64_nn", "gemm (cuBLAS)", [8.0]),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)",
     "elementwise", [2.0, 2.0, 2.0]),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<FusedAdamMathFunctor>(...)", "elementwise",
     [30.0]),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::NormTwoOps<float> > >(...)",
     "reduction/norm", [5.0]),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
     "::{lambda()#3}::operator()() const::{lambda(float)#1}>(...)", "copy/cast", [9.0]),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<float, 4, "
     "at::native::templates::cuda::normal_and_transform<float, float>(...)>(...)", "rng", [1.25]),
    ("my_unlisted_kernel", "other", [0.001]),
]
ASYNC = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", [40.0, 41.5]), ("Memset (Device)", "gpu_memset", [0.75])]


def _ps(us):
    return int(round(us * 1e6))


def synthetic_trace():
    events, ts = [], 1000.0
    for name, _, durs in KERNELS:
        for d in durs:
            events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": d,
                           "args": {"device": 0, "stream": 7, "correlation": len(events)}})
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                           "ts": ts - 5, "dur": 3.0})
            events.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": len(events), "pid": 1, "tid": 1, "ts": ts})
            events.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "id": len(events), "pid": 0, "tid": 7, "ts": ts})
            ts += d + 1.0
    for name, cat, durs in ASYNC:
        for d in durs:
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 9, "ts": ts, "dur": d,
                           "args": {"device": 0, "stream": 9}})
            ts += d
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "tid": 1, "ts": 900.0, "dur": 5e4})
    events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#3", "pid": 0, "tid": 7,
                   "ts": 1000.0, "dur": ts - 1000.0})
    events.append({"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}})
    return {"schemaVersion": 1, "traceEvents": events}


@pytest.fixture
def trace_file(tmp_path):
    path = tmp_path / "trace_steps_3-4.json"
    path.write_text(json.dumps(synthetic_trace()))
    return str(path)


def test_family_sums_are_exact(trace_file):
    result = profiling.attribute(trace_file)
    want = {}
    for name, family, durs in KERNELS:
        assert profiling.classify(name) == family, name
        ps, n = want.get(family, (0, 0))
        want[family] = (ps + sum(_ps(d) for d in durs), n + len(durs))
    total_ps = sum(ps for ps, _ in want.values())
    assert result["total_ms"] == total_ps / 1e9
    assert result["files"] == [trace_file]
    assert result["planes"] == ["device 0 stream 7", "device 0 stream 9"]
    assert {k: (round(v["ms"] * 1e9), v["occurrences"]) for k, v in result["families"].items()} == want
    assert list(result["families"]) == sorted(want, key=lambda k: (-want[k][0], k))
    assert sum(v["share"] for v in result["families"].values()) == pytest.approx(1.0)
    assert profiling.kernel_launches(result) == sum(len(d) for _, _, d in KERNELS)

    top = result["top_ops"][0]
    name, _, durs = KERNELS[0]
    assert top == {"name": name, "family": "conv3x3_gemm", "occurrences": 3, "total_ps": sum(map(_ps, durs)),
                   "avg_ps": sum(map(_ps, durs)) // 3}
    assert len(result["top_ops"]) == len(KERNELS)  # fewer than 25 names
    assert [r["total_ps"] for r in result["top_ops"]] == sorted((r["total_ps"] for r in result["top_ops"]), reverse=True)

    async_ps = sum(_ps(d) for _, _, durs in ASYNC for d in durs)
    assert result["async_overlapped_ms"] == async_ps / 1e9
    assert [(r["name"], r["occurrences"], r["family"]) for r in result["top_async_ops"]] == [
        ("Memcpy HtoD (Pageable -> Device)", 2, "memcpy/memset"), ("Memset (Device)", 1, "memcpy/memset")]
    assert profiling.device_ms(result) == pytest.approx((total_ps + async_ps) / 1e9, rel=1e-15)


def test_directory_and_gzip(trace_file, tmp_path):
    import gzip

    sub = tmp_path / "more"
    sub.mkdir()
    with gzip.open(sub / "rank0.pt.trace.json.gz", "wt") as f:
        json.dump(synthetic_trace(), f)
    one = profiling.attribute(trace_file)
    both = profiling.attribute(str(tmp_path))
    assert len(both["files"]) == 2
    assert both["total_ms"] == pytest.approx(2 * one["total_ms"], rel=1e-15)
    assert both["families"]["conv3x3_gemm"]["occurrences"] == 6


def test_key_set_matches_jax_attribute(trace_file, tmp_path):
    pb = tmp_path / "toy.xplane.pb"
    pb.write_bytes(_toy_xspace_bytes())
    jax_result = jax_xplane.attribute(str(pb))
    result = profiling.attribute(trace_file)
    assert set(result) == set(jax_result)
    assert set(result["top_ops"][0]) == set(jax_result["top_ops"][0])
    assert set(result["families"]["conv3x3_gemm"]) >= set(next(iter(jax_result["families"].values())))


def test_cli_prints_json(trace_file):
    out = io.StringIO()
    with redirect_stdout(out):
        profiling.trace.main([trace_file, "--json"])
    assert json.loads(out.getvalue()) == json.loads(json.dumps(profiling.attribute(trace_file)))
    out = io.StringIO()
    with redirect_stdout(out):
        profiling.trace.main([trace_file, "--top", "3"])
    text = out.getvalue()
    assert "conv3x3_gemm" in text and "memcpy/memset" in text


def test_trainer_cpu_trace_has_no_device_time(tmp_path, monkeypatch):
    config = toy_gaussian_bubbles_config()
    config.training.batch_size = 64
    config.training.log_freq = config.training.eval_freq = config.training.snapshot_freq = 10**6
    config.data.data_samples = 512
    monkeypatch.setenv("CSDT_PROFILE_DIR", str(tmp_path / "profile"))
    monkeypatch.setenv("CSDT_PROFILE_STEPS", "2")
    trainer = Trainer(config, str(tmp_path / "logs"), device="cpu")
    trainer.fit(max_steps=5, callbacks=[])
    files = os.listdir(tmp_path / "profile")
    assert files == ["trace_steps_3-4.json"]
    result = profiling.attribute(str(tmp_path / "profile"))
    events = profiling.parse_trace(result["files"][0])
    assert any(ev.get("cat") == "cpu_op" for ev in events)  # the trace holds the steps' host work
    assert result["total_ms"] == 0.0 and result["async_overlapped_ms"] == 0.0
    assert result["families"] == {} and result["top_ops"] == [] and result["planes"] == []
    assert profiling.device_op_table(events) == []
