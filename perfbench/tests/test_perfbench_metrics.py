"""The frozen metric arithmetic on synthetic intervals and counts: the
transform kernels' bound, the device's busy and idle time, the kernels by
name, the FLOP count, the window statistics and the readers."""

import math

import pytest

from perfbench import flops, readers, roofline, stats
from perfbench.harness import Record
from perfbench.trace import Record as Span
from perfbench.trace import Trace

SXM = roofline.PEAKS["sxm"]


@pytest.mark.parametrize("batch,ms", [(8, 0.000624), (16, 0.00125), (20, 0.00156)])
def test_kernel_bounds_are_the_recorded_ones(batch, ms):
    """PERF.md's table: both kernels bound by bytes at n_fft 512, segments
    of 127 hops."""
    t = 127 * 256
    assert roofline.k1_bound_s(batch, t, 512, SXM) * 1e3 == pytest.approx(ms, rel=2e-3)
    frames = roofline.n_frames(t, 512)
    assert frames == 128
    assert roofline.k2_bound_s(batch, frames, 512, SXM) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert roofline.bound_s(67e12, 1.0, SXM) == (pytest.approx(1.0), "operations")
    assert roofline.bound_s(1.0, 3.35e12, SXM) == (pytest.approx(1.0), "bytes")
    assert roofline.mdct_frame_ops(512) == 512 + 256 + 12 * 128 + 5 * 128 * 7


def test_peaks_by_card_name():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert roofline.peaks_for("NVIDIA H100 PCIe")["bf16"] == 756e12
    assert roofline.peaks_for("cpu") is None


def synthetic_trace():
    device = [Span(0, 10, "void mdct_spectro_fft_kernel<32>(float)"),
              Span(5, 20, "conv"), Span(30, 40, "imdct_audio_fft_kernel<32>"),
              Span(40, 45, "Memcpy HtoD"), Span(100, 110, "mdct_spectro_fft_kernel<32>")]
    host = [Span(0, 200, "aten::conv2d"), Span(20, 29, "aten::mul"), Span(50, 60, "aten::add")]
    notes = [Span(0, 95, "train_step"), Span(95, 200, "next_batch")]
    return Trace(device, host, notes, window_s=200e-6)


def test_busy_time_is_the_union_of_device_intervals():
    tr = synthetic_trace()
    assert tr.busy_s == pytest.approx(45e-6)  # [0, 20] + [30, 45] + [100, 110]
    assert tr.gaps() == [(20, 30), (45, 100)]


def test_kernels_by_name_and_without_copies():
    tr = synthetic_trace()
    assert tr.kernel("mdct_spectro_") == (pytest.approx(20e-6), 2)
    assert tr.kernel("imdct_audio_") == (pytest.approx(10e-6), 1)
    assert tr.kernels_s() == pytest.approx(45e-6)
    assert tr.top_ops(1) == [["conv", pytest.approx(15e-6)]]


def test_idle_gaps_are_named_by_what_the_host_did():
    gaps = dict(synthetic_trace().idle_gaps())
    assert gaps == {"train_step/aten::mul": pytest.approx(10e-6),
                    "train_step/aten::conv2d": pytest.approx(55e-6)}


def record(**kw):
    rec = Record(kind=kw.pop("kind", "generate"), peaks=SXM, **kw)
    return rec


def test_device_readers():
    rec = record(trace=synthetic_trace(),
                 shapes={readers.K1: (8, 127 * 256, 512), readers.K2: (8, 128, 512)})
    assert readers.device_idle(rec) == pytest.approx(100 * (1 - 45 / 200))
    # 2 K1 launches of 8 rows in 20 us
    assert readers.roofline_share(rec, readers.K1) == pytest.approx(
        100 * 2 * roofline.k1_bound_s(8, 127 * 256, 512, SXM) / 20e-6)
    # every kernel but K1 and K2 (the copy left out) over K1's 2 batches
    assert readers.generator_ms_per_batch(rec) == pytest.approx(15e-6 / 2 * 1e3)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    rec = record()
    assert readers.device_idle(rec) is None
    assert readers.roofline_share(rec, readers.K1) is None
    assert readers.generator_ms_per_batch(rec) is None
    assert readers.mean_ms(rec, "train_step") is None
    assert readers.p95_ms(rec) is None
    assert readers.mfu(Record(kind="train"), 10) is None


def test_mfu_is_all_flops_over_the_window_against_the_bf16_peak():
    rec = record(kind="train", flops_per_item=7e12, items=100, window_s=10.0)
    assert readers.mfu(rec, rec.items) == pytest.approx(100 * 7e12 * 100 / 10 / 989e12)


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(300, 12.0) == 25.0


def test_p95_is_the_nearest_rank():
    values = [float(i) for i in range(1, 101)]
    assert stats.percentile(values, 95) == 95.0
    assert stats.percentile([3.0], 95) == 3.0


def test_a_single_stall_moves_the_p95():
    window = [0.050 + 0.0001 * i for i in range(200)]
    stalled = list(window)
    stalled[17] = 2.0
    assert stats.percentile(stalled, 95) > stats.percentile(window, 95)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_flop_count_of_the_flagship():
    """Counted on the meta device: 103.5 GFLOP a segment through G, 7.03
    TFLOP a train step at batch 20."""
    from mdctgan_tpu_torch.configs import flagship_opt

    opt = flagship_opt()
    assert flops.generator_flops(opt) == pytest.approx(103.54e9, rel=1e-3)
    assert flops.train_step_flops(opt, 20) == pytest.approx(7.031e12, rel=1e-3)
    assert math.isclose(flops.train_step_flops(opt, 10) * 2, flops.train_step_flops(opt, 20),
                        rel_tol=1e-9)
