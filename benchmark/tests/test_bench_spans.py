"""The program's spans read by the benchmark (``benchmark/spans.py``,
``benchmark/tools/spans.py``): device work and idle gaps go to the span
open on the host at launch and at the gap's middle, whatever thread
launched; the tiny cells, traced with spans on, read the frozen prefix's
time on the CPU and leave out what only a device trace gives."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, spans
from benchmark.tests import tiny
from benchmark.tools import spans as tool

NAMES = {"train.step", "train.forward", "train.backward"}


def _ev(name, start, end, device=DeviceType.CPU, id=0, thread=1,
        annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           thread=thread, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def _kernel(name, start, end, id):
    return _ev(name, start, end, DeviceType.CUDA, id)


def test_kernels_go_to_the_span_open_at_their_launch():
    events = [
        _ev("train.step", 0, 100), _ev("train.forward", 10, 40),
        _ev("train.backward", 40, 90),
        # the device's side of a span: not device work
        _ev("train.forward", 12, 50, DeviceType.CUDA, annotation=True),
        # a forward op and its launch on the main thread
        _ev("aten::mm", 20, 25, id=7), _ev("cudaLaunchKernel", 21, 22,
                                           id=501),
        _kernel("gemm_kernel", 30, 60, 501),
        # the backward's op launched from autograd's thread: no span of
        # that thread is open, the main thread's train.backward is
        _ev("aten::convolution_backward", 50, 55, id=8, thread=2),
        _ev("cudaLaunchKernel", 51, 52, id=502, thread=2),
        _kernel("dgrad_kernel", 65, 80, 502),
        # a copy and its runtime call, between the spans of the step
        _ev("cudaMemcpyAsync", 95, 96, id=503),
        _kernel("Memcpy DtoD (Device -> Device)", 97, 99, 503),
        # no launch found: outside every span
        _kernel("elementwise_kernel", 99, 100, 504),
    ]
    got = spans.attribute(events, NAMES)
    assert got["steps"] == 1 and got["device_ops"] == 4
    assert got["launch_found"] == 3
    table = got["device_ms_per_step_by_span_group"]
    assert table == {"train.forward": {"convs and matmuls": 0.030},
                     "train.backward": {"convs and matmuls": 0.015},
                     "train.step": {"copies": 0.002},
                     spans.OUTSIDE: {"casts and elementwise": 0.001}}
    assert got["launches_per_step"] == 3


def test_gaps_go_to_the_span_open_at_their_middle():
    events = [
        _ev("train.step", 0, 100), _ev("train.backward", 40, 90),
        _ev("cudaLaunchKernel", 1, 2, id=11), _kernel("k1", 10, 20, 11),
        # 20 -> 60: the middle, 40, opens train.backward (ends first,
        # outer first at one time)
        _ev("cudaLaunchKernel", 3, 4, id=12), _kernel("k2", 60, 95, 12),
        # 95 -> 125: the middle, 110, lies outside every span
        _ev("cudaLaunchKernel", 5, 6, id=13), _kernel("k3", 125, 130, 13),
    ]
    got = spans.attribute(events, NAMES)
    assert got["idle_ms_by_span"] == {"train.backward": 0.040,
                                      spans.OUTSIDE: 0.030}
    assert got["step_idle_ms"] == 0.040


def test_without_device_work_per_step_figures_are_none():
    got = spans.attribute([_ev("train.step", 0, 10)], NAMES)
    assert got["launches_per_step"] is None and got["step_idle_ms"] is None


@pytest.mark.parametrize("kernel, group", [
    ("void__anonymous_namespace_::identity_bottleneck_kernel_256__128_",
     "K1"),
    ("void_cudnn::bn_fw_inf_1C11_kernel_NHWC_float__float__true__true_",
     "BN"),
    ("nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN", "convs and matmuls"),
    ("void_at::native::unrolled_elementwise_kernel_at::native::direct_",
     "casts and elementwise"),
    ("void__anonymous_namespace_::softmax_warp_forward_float__float__f",
     "softmax and LayerNorm"),
    ("void_at::native::reduce_kernel_128__4__at::native::ReduceOp_floa",
     "reductions"),
    ("void_at::native::multi_tensor_apply_kernel_FusedAdamMathFunctor",
     "optimizer"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("some_new_kernel", "other"),
])
def test_kernel_groups(kernel, group):
    assert spans.group_of(kernel, spans.kernel_groups()) == group


def test_summary_self_times_and_per_step():
    records = [
        {"seq": 0, "name": "train.step", "parent": None, "host_ms": 10.0,
         "device_ms": 9.0, "counts": {}},
        {"seq": 1, "name": "train.forward", "parent": 0, "host_ms": 4.0,
         "device_ms": 5.0, "counts": {}},
        {"seq": 2, "name": "train.forward.frozen", "parent": 1,
         "host_ms": 1.0, "device_ms": 3.0, "counts": {"k1_launches": 10}},
    ]
    s = spans.summary(records)
    assert s["train.step"]["host_self_ms"] == 6.0
    assert s["train.forward"]["host_self_ms"] == 3.0
    assert s["train.forward.frozen"]["counts"] == {"k1_launches": 10}
    assert spans.per_step_ms(records, "train.forward.frozen") == 3.0
    assert spans.per_step_ms(records[1:], "train.forward.frozen") is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny_resnet.train", "tiny_vit.train"])
def test_tiny_cells_with_spans(root, cell):
    def load():
        return harness.load_cell(cell, 2**31 + 11, 1.0, True, "cpu", root)

    on = tool.one(load(), True)
    assert on["correct"] and on["train_ranges_in_profile"] > 0
    # the frozen prefix's time reads on the CPU (host clock); what only a
    # device trace gives is left out
    assert 0 < on["frozen_forward_ms"]
    assert on["launches_per_step"] is None and on["step_idle_ms"] is None
    assert on["session"]["steps"] == tiny.TRAIN["traced_steps"]
    assert set(on["by_span"]) == {"train.step", "train.augment",
                                  "train.forward", "train.forward.frozen",
                                  "train.backward", "train.optimizer"}
    assert on["by_span"]["train.forward"]["hook_ms"] is not None
    # the profiler session turns the spans on whatever the window had
    off = tool.one(load(), False)
    assert off["correct"] and off["train_ranges_in_profile"] > 0
    assert "frozen_forward_ms" not in off
    assert set(off["metrics"]) == set(on["metrics"])
