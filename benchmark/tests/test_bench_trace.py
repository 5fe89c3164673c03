"""The trace reduction: the busy time is the union of the device
intervals, overlaps counted once; idle gaps and their host labels."""

from benchmark import trace


def test_union_counts_overlaps_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (28, 29)]
    assert trace.union_ns(spans, (0, 40)) == 25
    assert trace.union_ns(spans, (8, 22)) == 9         # clipped to the window
    assert trace.union_ns([], (0, 5)) == 0
    assert trace.union_ns([(3, 3), (7, 5)], (0, 10)) == 0


def test_idle_gaps_are_the_uncovered_stretches():
    spans = [(5, 15), (0, 10), (20, 30)]
    assert trace.idle_gaps(spans, (0, 40)) == [(15, 20), (30, 40)]
    assert trace.idle_gaps(spans, (-5, 25)) == [(-5, 0), (15, 20)]
    assert trace.idle_gaps([], (0, 3)) == [(0, 3)]


def test_a_gap_is_named_by_the_innermost_host_event():
    host = [('step', 0, 100), ('phase', 10, 50), ('op', 20, 30),
            ('next', 60, 70)]
    assert trace.innermost(host, [25, 40, 65, 80, 5, 200]) == [
        'op', 'phase', 'next', 'step', 'step', None]


def test_trace_busy_idle_and_breakdown():
    t = trace.Trace(
        device=[('void bias_act_kernel<float>', 0, 4_000_000),
                ('cudnn_conv_fprop', 2_000_000, 6_000_000),
                ('ncclAllReduce', 9_000_000, 10_000_000),
                ('Memcpy HtoD', 6_000_000, 7_000_000)],
        host=[('bench.train_step', 0, 10_000_000),
              ('aten::item', 7_000_000, 8_500_000)],
        window=(0, 10_000_000), steps=2)
    assert t.busy_s() == 0.008
    assert t.window_s == 0.01
    assert t.launches() == 3
    fam = t.family_s()
    assert fam["K1' bias_act"] == 0.004
    assert fam['convolution (cuDNN)'] == 0.004
    assert fam['collectives (NCCL)'] == 0.001
    b = trace.breakdown(t)
    assert b['device_ops'][0][1] == 0.004
    assert b['idle_gaps'] == [['aten::item', 0.002]]
