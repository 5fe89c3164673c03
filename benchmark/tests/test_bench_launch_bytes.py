"""The hand-written kernels' bytes, worked out by the benchmark from each
launch's arguments: each tensor the kernel needs read once, each output
written once; a launch whose arguments changed form is not counted."""

from benchmark import launch_bytes as lb
from benchmark.metrics import handwritten_roofline
from benchmark.trace import HANDWRITTEN, Trace


def test_bias_act_forward_and_gradient():
    # x, b, y, n, C, dtype (bfloat16), act, alpha, gain, clamp, variant,
    # grid, stream
    fwd = (1, 2, 3, 1000, 10, 1, 2, 0.2, 1.41, 256.0, 1, 4, None)
    assert lb.bytes_of('mgt_bias_act', [fwd]) == (2 * 1000 + 10) * 2
    no_bias = (1, None, 3, 1000, 1, 0, 0, 0.0, 1.0, -1.0, 1, 4, None)
    assert lb.bytes_of('mgt_bias_act', [no_bias]) == 2 * 1000 * 4
    # g, x, b, y, dy, out, n, C, dtype, act, order, alpha, gain, clamp,
    # stream: lrelu reads y; linear without a clamp reads neither; swish
    # reads x and b; order 2 reads dy
    lrelu = (1, None, None, 4, None, 6, 1000, 10, 0, 2, 1, 0.2, 1.4, -1.0, 0)
    assert lb.bytes_of('mgt_bias_act_grad', [lrelu]) == 3 * 1000 * 4
    linear = (1, None, None, None, None, 6, 1000, 1, 1, 0, 1, 0., 1., -1., 0)
    assert lb.bytes_of('mgt_bias_act_grad', [linear]) == 2 * 1000 * 2
    clamped = linear[:13] + (256.0, 0)
    assert lb.bytes_of('mgt_bias_act_grad', [clamped]) == 3 * 1000 * 2
    swish2 = (1, 2, 3, None, 5, 6, 1000, 10, 0, 8, 2, 0., 1.4, -1.0, 0)
    assert lb.bytes_of('mgt_bias_act_grad', [swish2]) == \
        (4 * 1000 + 10) * 4


def test_upfirdn2d_warp_and_composite():
    # x, y, f, dtype, n, h, w, c, out_h, out_w, upx, upy, downx, downy,
    # padx0, pady0, fh, fw, separable, flip, gain, variant, smem, stream
    up = (1, 2, 3, 0, 8, 128, 128, 4, 256, 256, 2, 2, 1, 1, 2, 2, 4, 4,
          1, 0, 2.0, 1, 0, None)
    assert lb.bytes_of('mgt_upfirdn2d', [up, up]) == 2 * (
        8 * 4 * (128 * 128 + 256 * 256) * 4 + 4 * 4)
    full = up[:18] + (0,) + up[19:]
    assert lb.bytes_of('mgt_upfirdn2d', [full]) == \
        8 * 4 * (128 * 128 + 256 * 256) * 4 + 16 * 4
    # src, theta, taps, dst, n, h, w, c, out_h, out_w, taps, up, ...
    warp = (1, 2, 3, 4, 16, 396, 396, 4, 524, 524, 4, 2, 1, 16, 32, 0, 0, 0)
    moved = (16 * 4 * (396 * 396 + 524 * 524) + 16 * 6 + 4) * 4
    assert lb.bytes_of('mgt_warp_forward', [warp]) == moved
    assert lb.bytes_of('mgt_warp_transpose', [warp]) == moved
    comp = (1, 2, 3, 8, 9, 256, 256, 0.0, 1, 8, 0)
    assert lb.bytes_of('mgt_translate_composite', [comp]) == \
        (8 * 9 * 256 * 256 * 4 + 8 * 9 * 2 + 8 * 256 * 256 * 4) * 4


def test_a_changed_entry_point_is_not_counted():
    fwd = (1, 2, 3, 1000, 10, 1, 2, 0.2, 1.41, 256.0, 1, 4, None)
    assert lb.bytes_of('mgt_bias_act', []) == 0
    assert lb.bytes_of('mgt_bias_act', [fwd, fwd + (7,)]) is None
    assert lb.bytes_of('mgt_bias_act', [fwd[:5] + (9,) + fwd[6:]]) is None
    assert lb.bytes_of('mgt_new_kernel', [fwd]) is None


class FakeKernel:
    symbol = 'mgt_bias_act'
    bytes = 0

    def launch(self, *args, variant='kernel', nbytes=0):
        self.bytes += nbytes


def test_recorder_keeps_the_arguments_and_restores_launch():
    k = FakeKernel()
    fwd = (1, 2, 3, 1000, 10, 1, 2, 0.2, 1.41, 256.0, 1, 4, None)
    with lb.Recorder([(HANDWRITTEN[1], k)]) as rec:
        k.launch(*fwd, variant='vector', nbytes=5)
    k.launch(*fwd, nbytes=5)                  # not recorded
    assert 'launch' not in vars(k) and k.bytes == 10
    assert rec.bytes() == {HANDWRITTEN[1]: (2 * 1000 + 10) * 2}


def test_roofline_is_left_out_where_a_kernel_that_ran_has_no_bytes():
    class R:
        trace = Trace(device=[('mgt_bias_act_vector', 0, 1000),
                              ('upfirdn2d_up2', 1000, 2000)],
                      host=[], window=(0, 2000), steps=1)
        kernel_bytes = {HANDWRITTEN[1]: 3_350_000, HANDWRITTEN[2]: 3_350_000}
    assert abs(handwritten_roofline.read(R) - 100.0) < 1e-9
    R.kernel_bytes = {HANDWRITTEN[1]: 3_350_000, HANDWRITTEN[2]: None}
    assert handwritten_roofline.read(R) is None
