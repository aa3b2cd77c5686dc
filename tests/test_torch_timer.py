"""The port's one kernel timer (convtasnet_torch/tools/_bench.py), on the
CPU with stand-ins for torch.profiler, the launch counters and CUDA
events: the acceptance rule on synthetic record lists, the retries with
more filler launches, the fall-back to event time listed under
`profiler_blind`, and the sizing of the cold-L2 copies."""

from types import SimpleNamespace

import pytest
import torch

from convtasnet_torch.tools import _bench

KF = "void tcn::bwd_finish_kernel(tcn::FinGroup)"
GEMM = "void tcn::hgemm_kernel<0, 256, 2>(tcn::HMaps, tcn::HArgs)"
LIB = "void at::native::reduce_kernel<512, 1>(...)"
ONE = {KF: (1, 9.0), GEMM: (2, 30.0), LIB: (1, 4.0)}


def _times(one, iters):
    return {k: (n * iters, us * iters) for k, (n, us) in one.items()}


class _Profiler:
    """Hands out the given profiles in turn and logs (calls, fill) of each."""

    def __init__(self, profiles):
        self.profiles, self.log = list(profiles), []

    def __call__(self, fn, calls, fill, cpu):
        fn()
        self.log.append((calls, fill))
        return self.profiles.pop(0)


def _counter(per_call):
    n = [0]

    def counted():
        n[0] += per_call
        return n[0]
    return counted


@pytest.fixture
def blind_list(monkeypatch):
    monkeypatch.setattr(_bench, "PROFILER_BLIND", [])
    return _bench.PROFILER_BLIND


def test_records_verdict_takes_a_complete_profile():
    assert _bench.records_verdict(ONE, _times(ONE, 20), 20, launched=3) == ""
    assert _bench.records_verdict(ONE, _times(ONE, 20), 20, launched=None) == ""


@pytest.mark.parametrize("many,launched,why", [
    ({**_times(ONE, 20), GEMM: (39, 600.0)}, 3, "off by name: -1"),
    ({**_times(ONE, 20), "void other(int)": (1, 1.0)}, 3, "off by name: +1"),
    ({k: v for k, v in _times(ONE, 20).items() if k != LIB}, 3, "off by name: -20"),
    (_times(ONE, 20), 4, "3 records of the port's kernels in one call, 4 launches"),
])
def test_records_verdict_names_what_is_missing(many, launched, why):
    assert why in _bench.records_verdict(ONE, many, 20, launched)


def test_records_verdict_counts_an_empty_profile_as_a_missing_record():
    assert "no record" in _bench.records_verdict({}, {}, 20, launched=0)
    assert "no record" in _bench.records_verdict({}, _times(ONE, 20), 20, launched=None)


def test_timed_takes_the_first_complete_profile(blind_list):
    prof = _Profiler([ONE, _times(ONE, 20)])
    t = _bench.timed(lambda: None, iters=20, warm=0, profile=prof, counted=_counter(3),
                     event_ms=lambda fn, n: pytest.fail("event time taken"))
    assert t.ms == pytest.approx(43.0 / 1e3) and not t.blind and t.why == []
    assert t.records == _times(ONE, 20)
    assert prof.log == [(1, _bench.FILLS[0]), (20, _bench.FILLS[0])]
    assert blind_list == []


def test_timed_retries_a_profile_missing_one_record(blind_list):
    """One record of one name lost: the try is refused and both profiles
    are taken again, with more filler launches."""
    short = {**_times(ONE, 20), KF: (19, 171.0)}
    prof = _Profiler([ONE, short, ONE, _times(ONE, 20)])
    t = _bench.timed(lambda: None, iters=20, warm=0, profile=prof, counted=_counter(3),
                     event_ms=lambda fn, n: pytest.fail("event time taken"))
    assert not t.blind and len(t.why) == 1 and "-1" in t.why[0]
    assert [f for _, f in prof.log] == [_bench.FILLS[0]] * 2 + [_bench.FILLS[1]] * 2
    assert t.ms == pytest.approx(43.0 / 1e3) and blind_list == []


def test_timed_retries_when_the_one_call_profile_lost_a_port_record(blind_list):
    """The counters saw 3 launches, the one-call profile 2 of the port's
    records: its own counts cannot be the reference."""
    lost = {KF: (1, 9.0), GEMM: (1, 15.0), LIB: (1, 4.0)}
    prof = _Profiler([lost, _times(lost, 20), ONE, _times(ONE, 20)])
    t = _bench.timed(lambda: None, iters=20, warm=0, profile=prof, counted=_counter(3),
                     event_ms=lambda fn, n: pytest.fail("event time taken"))
    assert not t.blind and "2 records of the port's kernels" in t.why[0]


def test_timed_turns_to_event_time_after_tries(blind_list, capsys):
    """No complete profile in `tries`: CUDA event time, the call listed
    under profiler_blind by its label; an empty profile is one more case."""
    empty = {}
    prof = _Profiler([ONE, {**_times(ONE, 20), GEMM: (41, 1.0)}, empty, empty,
                      ONE, _times(ONE, 19)])
    t = _bench.timed(lambda: None, iters=20, warm=0, tries=3, label="KF cold", profile=prof,
                     counted=_counter(3), event_ms=lambda fn, n: 0.25)
    assert t.blind and t.ms == 0.25 and len(t.why) == 3
    assert blind_list == ["KF cold"]
    assert [f for _, f in prof.log][::2] == list(_bench.FILLS)
    assert "event time instead" in capsys.readouterr().out


def test_kernel_records_leaves_out_fillers_annotations_and_host_events():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, count, us, dev=cuda, ann=False):
        return SimpleNamespace(key=key, count=count, self_device_time_total=us,
                               device_type=dev, is_user_annotation=ann)

    events = [ev(KF, 2, 10.0), ev("spin_kernel(long)", 64, 99.0), ev("aten::mm", 3, 50.0, ann=True),
              ev("aten::add", 4, 0.0, dev=cpu), ev(LIB, 1, 2.0)]
    assert _bench.kernel_records(events) == {KF: (2, 10.0), LIB: (1, 2.0)}


@pytest.mark.parametrize("nbytes,n", [
    (292 * 10 ** 6, 1),           # KF, one group of 32 blocks' partials at the paper config
    (16_908_288, 7),              # KFW's f32 inputs at the paper widths
    (2 * 50 * 2 ** 20, 1), (2 * 50 * 2 ** 20 - 1, 2), (1, 2 * 50 * 2 ** 20)])
def test_cold_copies_span_twice_the_l2(nbytes, n):
    assert _bench.cold_copies(nbytes) == n
    assert n * nbytes >= 2 * _bench.H100_L2_BYTES > (n - 1) * nbytes


def test_cold_timed_cycles_input_copies_and_holds_outputs(monkeypatch):
    """Launch i reads copy i % n of every tensor of the arguments (named
    tuples and lists too) and its outputs live until launch i + n."""
    seen = []

    def fake_timed(step, iters, warm, tries, label=""):
        for _ in range(warm + iters):
            step()
        return _bench.Timing(1.0, {}, [])

    monkeypatch.setattr(_bench, "timed", fake_timed)
    a = torch.zeros(10)
    pair = _bench.Timing(0.0, None, [])  # a dataclass: shared, not copied

    def call(x, lst, other):
        seen.append((x.data_ptr(), lst[0].data_ptr(), other is pair))
        return torch.ones(3)

    t = _bench.cold_timed(call, (a, [torch.ones(2)], pair), iters=5, warm=0, copies=3)
    assert t.ms == 1.0
    ptrs = [p for p, _, _ in seen]
    assert len(set(ptrs[:3])) == 3 and ptrs[3:6] == ptrs[:3]
    assert len({q for _, q, _ in seen}) == 3 and all(s for _, _, s in seen)
    assert len(seen) == 3 + 6  # warm max(warm, n), iters rounded up to a multiple of n
