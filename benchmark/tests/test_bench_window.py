"""The window opens after a warm-up that ran every kind of step, and
closes at the end of the last step that began inside ``--seconds``."""

import time

from benchmark import harness, spec


class FakePort:
    """Steps of a fixed length, on the CPU."""

    def __init__(self, step_s):
        self.dev = __import__('torch').device('cpu')
        self.step_s = step_s
        self.started, self.ended = [], []

    def feed(self):
        return None, []

    def step(self, counter, batch):
        self.started.append((counter, time.perf_counter()))
        time.sleep(self.step_s)
        self.ended.append(time.perf_counter())


def test_window_counts_every_step_begun_inside_it():
    port = FakePort(0.03)
    t0 = time.perf_counter()
    counters, waits, window_s = harness.measure_window(port, 0.1, 16)
    assert counters[0] == 16
    assert counters == list(range(16, 16 + len(counters)))
    assert len(waits) == len(counters)
    starts = [t for _, t in port.started]
    # every step counted began inside the seconds, and none was left out
    assert all(t - t0 < 0.1 + 0.02 for t in starts)
    assert port.ended[-1] - t0 >= 0.1
    # the window ends at the end of the last step, not at the deadline
    assert window_s >= port.ended[-1] - starts[0] - 1e-3
    assert 3 <= len(counters) <= 5


def test_every_traffic_warms_every_kind_of_step_before_its_window():
    """Step 0 runs every regularizer, step 1 none, step 4 the generator's
    alone: every shape a window runs is built before it opens."""
    bench = spec.load_json(spec.ROOT / 'BENCHMARK.json')
    for w in bench['workloads']:
        cell = spec.load_cell(w['name'])
        warmup = cell.traffic['warmup_steps']
        assert warmup == [0, 1, 4]
        assert cell.traffic['window_start'] > max(warmup)
        assert min(cell.traffic['profile_steps']) > max(warmup)
