"""The metrics' arithmetic on canned records, the frozen op
count, and the trace reader on canned profiler events, on one card and
on several."""

import importlib
import random

import pytest

from portbench import trace, yardstick


def record(**over):
    rec = {"window_s": 40.0, "bases": 2_000_000, "jobs": 8,
           "job_s": [5.0] * 8, "query_len": 1582, "transforms": 48,
           "segments": 800, "scanned": 2_000_000, "longest": 4894,
           "stages": {"output": 2.0, "device_wait": 0.4,
                      "host_candidate_wait": 30.0, "cand_fwd_dev": 3.0,
                      "cand_rev_dev": 1.0, "cand_finalize_busy": 280.0},
           "trace": {"busy_s": 0.8, "window_s": 40.0,
                     "kernels": {"void (anonymous namespace)::"
                                 "scan_colmax_kernel<13>(...)": 0.5,
                                 "void scan16_kernel<16>(...)": 0.1,
                                 "window_fwd_kernel<4, 32, 0>": 0.2},
                     "gaps": []}}
    rec.update(over)
    return rec


def read(name, rec):
    return importlib.import_module(f"portbench.metrics.{name}").read(rec)


@pytest.mark.parametrize("name,want", [
    ("device_s_per_mbp", 0.4), ("window_kernels_s_per_mbp", 0.1),
])
def test_device_seconds_per_mbp(name, want):
    assert read(name, record()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_s_per_mbp",
                                  "window_kernels_s_per_mbp",
                                  "scan_roofline_pct"])
def test_a_run_without_a_trace_gives_nothing(name):
    assert read(name, record(trace=None)) is None


@pytest.mark.parametrize("name", ["window_kernels_s_per_mbp",
                                  "scan_roofline_pct"])
def test_a_trace_without_the_kernels_gives_nothing(name):
    rec = record()
    rec["trace"] = dict(rec["trace"], kernels={"copy": 1.0})
    assert read(name, rec) is None


def test_the_frozen_op_count():
    # 3.5 while 5 * min(m16, N) <= 32767: MEG3 and NEAT1 against a peak
    assert yardstick.scan_ops_per_cell(1584, 4894) == 3.5
    assert yardstick.scan_ops_per_cell(22768, 4894) == 3.5
    assert yardstick.scan_ops_per_cell(22768, 6554) == 7
    assert yardstick.INT32_OPS == pytest.approx(1.673e13, rel=1e-3)


def test_scan_roofline_arithmetic():
    rec = record()
    least, term = yardstick.scan_least_seconds(1582, 48, 2_000_000, 800,
                                               4894)
    assert term == "operations"
    assert least == pytest.approx(3.5 * 48 * 1582 * 2e6 / 1.672704e13)
    assert read("scan_roofline_pct", rec) == pytest.approx(
        100 * least / 0.6)


class _Event:
    def __init__(self, name, a, b, dev, annotation=False, card=0):
        self._n, self._a, self._b, self._d = name, a, b, dev
        self._u = annotation
        self._c = card if dev else -1

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._d else DeviceType.CPU

    def is_user_annotation(self):
        return self._u

    def device_index(self):
        return self._c


class _Prof:
    def __init__(self, events):
        class R:
            def events(self_inner):
                return events

        class P:
            kineto_results = R()

        self.profiler = P()


def test_trace_reader_busy_union_kernels_and_gaps():
    ev = [_Event(trace.WINDOW, 0, 1000, False),
          _Event(trace.JOB, 0, 1000, False),
          _Event("aten::copy_", 500, 700, False),
          _Event(trace.JOB, 100, 900, True, annotation=True),
          _Event("k1", 100, 300, True), _Event("k2", 200, 400, True),
          _Event("k1", 800, 1200, True)]
    t = trace.read(_Prof(ev))
    assert t["window_s"] == pytest.approx(1e-6)
    assert t["busy_s"] == pytest.approx(500e-9)
    assert t["kernels"] == pytest.approx({"k1": 400e-9, "k2": 200e-9})
    assert [g for _, g in t["gaps"]] == pytest.approx([400e-9, 100e-9])
    assert t["gaps"][0][0] == "aten::copy_"
    assert t["gaps"][1][0].startswith("in cli.main")


def test_trace_reader_without_host_events_spans_the_device_work():
    ev = [_Event("k1", 100, 300, True), _Event("k2", 200, 400, True),
          _Event("k1", 800, 1200, True)]
    t = trace.read(_Prof(ev))
    assert t["window_s"] == pytest.approx(1100e-9)
    assert t["busy_s"] == pytest.approx(700e-9)
    assert [g for _, g in t["gaps"]] == pytest.approx([400e-9])
    assert trace.read(_Prof([])) is None


def _one_union(spans, w0, w1):
    """The reader's busy nanoseconds and gaps as they were taken before
    it kept each event's card: one union of every interval."""
    spans = sorted((max(a, w0), min(b, w1)) for a, b in spans
                   if min(b, w1) > max(a, w0))
    busy, gaps, cur = 0, [], w0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    return busy, sorted(gaps, key=lambda g: g[0] - g[1])


def _random_record(cards: int, seed: int):
    gen = random.Random(seed)
    ev = [_Event(trace.WINDOW, 1_000, 900_000, False)]
    spans = {c: [] for c in range(cards)}
    for _ in range(300):
        c = gen.randrange(cards)
        a = gen.randrange(0, 1_000_000)
        b = a + gen.randrange(1, 20_000)
        spans[c].append((a, b))
        ev.append(_Event(f"k{gen.randrange(3)}", a, b, True, card=c))
    return ev, spans


@pytest.mark.parametrize("seed", range(5))
def test_one_card_busy_is_the_single_union_exactly(seed):
    ev, spans = _random_record(1, seed)
    busy, gaps = _one_union(spans[0], 1_000, 900_000)
    t = trace.read(_Prof(ev))
    assert t["busy_s"] == busy * 1e-9
    assert t["busy_s_by_card"] == {0: busy * 1e-9}
    assert [g for _, g in t["gaps"]] == [(b - a) * 1e-9
                                         for a, b in gaps[:10]]


@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_several_cards_sum_their_own_unions(cards, seed):
    ev, spans = _random_record(cards, seed)
    t = trace.read(_Prof(ev))
    own = {c: _one_union(s, 1_000, 900_000)[0] for c, s in spans.items()}
    assert t["busy_s_by_card"] == pytest.approx(
        {c: ns * 1e-9 for c, ns in own.items() if ns})
    assert t["busy_s"] == pytest.approx(sum(own.values()) * 1e-9)
    # the gaps are where no card is busy: the union of all the cards
    everyone, gaps = _one_union([s for v in spans.values() for s in v],
                                1_000, 900_000)
    assert t["busy_s"] > everyone * 1e-9
    assert [g for _, g in t["gaps"]] == pytest.approx(
        [(b - a) * 1e-9 for a, b in gaps[:10]])
    assert t["busy_s"] <= t["window_s"] * cards


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_cards_busy_at_once_each_count(cards):
    """The same kernel at the same time on every card: the card-seconds
    are the cards times its length, the kernel's seconds are summed over
    the cards, and the gaps are those of one card."""
    ev = [_Event(trace.WINDOW, 0, 1000, False),
          _Event(trace.JOB, 0, 1000, False)]
    for c in range(cards):
        ev += [_Event("k1", 100, 300, True, card=c),
               _Event("k2", 600, 700, True, card=c)]
    t = trace.read(_Prof(ev))
    assert t["busy_s"] == pytest.approx(cards * 300e-9)
    assert t["busy_s_by_card"] == pytest.approx(
        {c: 300e-9 for c in range(cards)})
    assert t["kernels"] == pytest.approx({"k1": cards * 200e-9,
                                          "k2": cards * 100e-9})
    assert [g for _, g in t["gaps"]] == pytest.approx(
        [300e-9, 300e-9, 100e-9])


def test_a_gap_on_one_card_is_no_gap_while_another_is_busy():
    ev = [_Event(trace.WINDOW, 0, 1000, False),
          _Event("k1", 0, 500, True, card=0),
          _Event("k1", 400, 1000, True, card=1),
          _Event("k1", 0, 100, True, card=2)]
    t = trace.read(_Prof(ev))
    assert t["busy_s"] == pytest.approx(1200e-9)
    assert t["busy_s_by_card"] == pytest.approx(
        {0: 500e-9, 1: 600e-9, 2: 100e-9})
    assert t["gaps"] == []
