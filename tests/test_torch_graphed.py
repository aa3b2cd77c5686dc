"""The graphed inference programs (convtasnet_torch/models/graphed.py) on
the CPU.

The key and capture rules run against a stand-in backend: its capture
runs the function once on the static inputs and keeps its outputs, and its
replay reruns it and writes the results into those same tensors in place
with the launch counters left as they were, as a CUDA graph's replay
does. Then the separate and evaluate CLIs run through the same entry with
the stand-in, at two --pad_to_multiple values so that shapes repeat,
against the JAX package's CLIs on the same checkpoint and wavs:
separated wavs within one int16 step (tests/test_torch_cli.py), SI-SNRi
and SDRi within TOL_DB (tests/test_torch_evaluate.py; the forwards agree
at rtol 5e-4 / atol 5e-5). The card's own graphs are tested in
tests/test_torch_cuda.py."""

import glob
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import convtasnet_tpu
from convtasnet_torch.config import ConvTasNetConfig
from convtasnet_torch.data.synthetic import make_wav_dataset
from convtasnet_torch.data.wavio import read_wav, write_wav
from convtasnet_torch.models import conv_tasnet as tm
from convtasnet_torch.models import graphed
from convtasnet_torch.ops.kernels import tcn_block, tcn_block_bwd
from convtasnet_torch.parallel import comm
from convtasnet_torch.parallel.mesh import graphable
from convtasnet_torch.utils import ledger
from convtasnet_tpu.training import checkpoint as j_ckpt

torch.set_num_threads(1)
SMALL = dict(N=32, L=16, B=16, H=32, P=3, X=3, R=2, compute_dtype="float32")
TOL_DB = 5e-3


class StandIn:
    """A capture backend without a card (see the module docstring)."""

    def __init__(self):
        self.captures, self.warm_ups, self.fail = 0, 0, False
        self.pools = []  # the pool each capture was given

    def warm_up(self, fn, inputs):
        self.warm_ups += 1
        return fn(*inputs)

    def capture(self, fn, inputs, pool=None):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.captures += 1
        self.pools.append(pool)
        out = fn(*inputs)

        def replay():
            before = ledger.read()
            new = fn(*inputs)
            ledger.add({k: before.get(k, 0) - v for k, v in ledger.read().items()})
            for o, n in zip(out if isinstance(out, tuple) else (out,),
                            new if isinstance(new, tuple) else (new,)):
                o.copy_(n)

        # A new pool grows by 1000 bytes, a shared one by 10 per capture.
        return graphed.Program(replay, out, pool or f"pool{self.captures}",
                               10 if pool else 1000)


@pytest.fixture
def stand_in(monkeypatch):
    backend = StandIn()
    monkeypatch.setattr(graphed, "backend_for", lambda device: backend)
    graphed.reset_counts()
    ledger.reset()
    yield backend
    graphed.reset_counts()
    ledger.reset()


def _double(x):
    ledger.add({"tcn_in_gemm": 3})  # as three kernel launches would count
    return x * 2


def _x(n, v=1.0):
    return torch.full((n,), float(v))


def test_first_call_eager_second_captures_later_replay(stand_in):
    g = graphed.GraphedForward(_double)
    seen = []
    for i in range(5):
        torch.testing.assert_close(g(_x(4, i)), _x(4, 2.0 * i), rtol=0, atol=0)
        c = graphed.counts()
        seen.append((c["eager_calls"], c["captures"], c["replays"]))
    assert seen == [(1, 0, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3), (1, 1, 4)]
    assert stand_in.captures == 1 and stand_in.warm_ups == graphed.CAPTURE_WARMUP == 1
    assert graphed.counts()["graphs"] == 1 and graphed.counts()["pool_bytes"] == 1000


def test_a_key_is_never_captured_twice(stand_in):
    g = graphed.GraphedForward(_double)
    for n in (3, 4, 3, 4, 5, 3, 4, 5, 3, 4, 5):
        g(_x(n))
    assert stand_in.captures == 3 == len(g.graphs())
    assert graphed.counts()["captures"] == 3
    assert sorted(k[0][0] for k in g.graphs()) == [(3,), (4,), (5,)]


def test_beyond_the_cap_new_keys_stay_eager_and_nothing_is_evicted(stand_in, monkeypatch):
    monkeypatch.setattr(graphed, "MAX_GRAPHS", 2)
    g = graphed.GraphedForward(_double)
    for n in (1, 1, 2, 2, 3, 3, 3, 3, 1, 2):
        g(_x(n))
    assert stand_in.captures == 2
    assert sorted(k[0][0] for k in g.graphs()) == [(1,), (2,)]
    c = graphed.counts()
    # 3 eager first calls + 3 more of the key beyond the cap; 1 and 2 replay.
    assert (c["eager_calls"], c["replays"]) == (6, 4)


@pytest.mark.parametrize("cap,cycle", [(0, 3), (2, 3), (2, 5), (4, 4), (16, 20)])
def test_a_cycle_longer_than_the_cap_captures_at_most_cap_times(stand_in, monkeypatch,
                                                                cap, cycle):
    g = graphed.GraphedForward(_double)
    monkeypatch.setattr(graphed, "MAX_GRAPHS", cap)  # read at each new key
    for _ in range(4):
        for n in range(1, cycle + 1):
            g(_x(n))
    assert stand_in.captures == min(cap, cycle) == graphed.counts()["captures"]
    c = graphed.counts()
    assert c["eager_calls"] + c["replays"] == 4 * cycle


def test_kernel_form_and_cal_sdr_are_part_of_the_key(stand_in):
    x = _x(4)
    keys = {graphed.GraphedForward(_double, tag=(form, sdr)).key((x,))
            for form in ("whole_tcn", "whole_block", "eager") for sdr in (False, True)}
    assert len(keys) == 6
    g = graphed.GraphedForward(_double, tag=("whole_tcn", True))
    for x in (_x(4), _x(4), _x(4, 2.0)):  # same shape: one key
        g(x)
    assert list(g.graphs()) == [((((4,), torch.float32, x.device),) + ("whole_tcn", True))]


def test_the_graphs_of_a_wrapper_share_one_pool(stand_in):
    g = graphed.GraphedForward(_double)
    for n in (3, 3, 4, 4, 5, 5, 3, 4, 5):
        g(_x(n))
    assert stand_in.pools == [None, "pool1", "pool1"]
    assert [v["pool_bytes"] for v in g.graphs().values()] == [1000, 10, 10]
    assert graphed.counts()["pool_bytes"] == 1020
    h = graphed.GraphedForward(_double)  # another wrapper: a pool of its own
    h(_x(3))
    h(_x(3))
    assert stand_in.pools[-1] is None and graphed.counts()["pool_bytes"] == 2020


@pytest.mark.parametrize("tp,cp,want", [(1, 1, True), (2, 1, False), (1, 2, False),
                                        (2, 2, False)])
def test_graphable_meshes_have_no_collective_in_the_forward(tp, cp, want):
    assert graphable(None)
    assert graphable(SimpleNamespace(dp=2, tp=tp, cp=cp)) is want


def test_a_failing_capture_raises_with_the_key_and_never_retries(stand_in):
    g = graphed.GraphedForward(_double, tag=("whole_tcn",))
    g(_x(4))
    stand_in.fail = True
    with pytest.raises(graphed.GraphError, match=r"capture of key .*\(4,\).*whole_tcn"):
        g(_x(4))
    stand_in.fail = False
    with pytest.raises(graphed.GraphError, match="failed before"):
        g(_x(4))
    assert stand_in.captures == 0 and graphed.counts()["eager_calls"] == 1


def test_a_failing_replay_raises_with_the_key(stand_in):
    g = graphed.GraphedForward(_double)
    g(_x(4))
    g(_x(4))
    g._graphs[next(iter(g._graphs))].program.outputs[0].resize_(0)  # breaks the copy back
    with pytest.raises(graphed.GraphError, match=r"replay of key .*\(4,\)"):
        g(_x(4))


def test_replayed_launch_counts_add_up_per_forward(stand_in):
    g = graphed.GraphedForward(_double)
    g(_x(4))
    assert tcn_block.counts()["tcn_in_gemm"] == 3
    g(_x(4))  # warm-up (3 launches) + capture (recorded, not run) + replay (3)
    assert tcn_block.counts()["tcn_in_gemm"] == 9
    assert g.graphs()[g.key((_x(4),))]["launches"] == {"tcn_in_gemm": 3}
    tcn_block.reset_counts()
    for _ in range(7):
        g(_x(4))
    assert tcn_block.counts() == {**{k: 0 for k in tcn_block.counts()}, "tcn_in_gemm": 21}


# The counter names of the forward and backward kernels, which the
# benchmark's kernel counters (benchmark/kernels/<name>.py) and its harness
# read by name.
FORWARD = {"tcn_in_gemm", "tcn_dwconv", "tcn_dwconv_save", "tcn_out_gemm_fold",
           "tcn_out_gemm_unfold", "tcn_fold_weights", "tcn_stream_block",
           "tcn_out_gemm_fold_skip", "tcn_out_gemm_unfold_skip", "tcn_fold_weights_skip"}
BACKWARD = {"tcn_bwd_dz", "tcn_wgrad_out", "tcn_bwd_dwconv", "tcn_bwd_dx", "tcn_wgrad_in",
            "tcn_bwd_finish", "tcn_bwd_dz_skip", "tcn_wgrad_out_skip", "tcn_bwd_finish_skip"}


def test_the_ledger_views_keep_their_counter_names():
    assert set(tcn_block.counts()) == FORWARD and set(tcn_block_bwd.counts()) == BACKWARD
    assert set(comm.counts()) == {"collectives"}
    kernels = os.path.join(os.path.dirname(__file__), "..", "benchmark", "kernels")
    stems = {f[:-3] for f in os.listdir(kernels)
             if f.endswith(".py") and f not in ("__init__.py", "_shape.py")}
    assert stems and stems <= FORWARD | BACKWARD


# A capture whose warm-up ran a collective returns the warm-up's outputs
# and replays nothing: that call runs the function once, not twice.
@pytest.mark.parametrize("name,view,captured", [("tcn_in_gemm", tcn_block.counts, 6),
                                                ("tcn_bwd_dwconv", tcn_block_bwd.counts, 6),
                                                ("tcn_stream_block", tcn_block.counts, 6),
                                                ("collectives", comm.counts, 4)])
def test_a_capture_takes_its_launches_off_and_each_replay_adds_them_back(stand_in, name,
                                                                        view, captured):
    def twice(x):
        ledger.count(name)
        ledger.count(name)
        return x + 1

    g = graphed.GraphedForward(twice)
    g(_x(4))
    assert view()[name] == 2  # the eager call
    g(_x(4))  # the warm-up's two, the capture's two taken off, the replay's two
    assert view()[name] == captured
    assert g.graphs()[g.key((_x(4),))]["launches"] == {name: 2}
    for n in range(1, 4):
        g(_x(4))
        assert view()[name] == captured + 2 * n
    assert sum(sum(v().values()) for v in (tcn_block.counts, tcn_block_bwd.counts,
                                           comm.counts)) == view()[name]


def test_returned_outputs_survive_the_next_replay(stand_in):
    g = graphed.GraphedForward(lambda a, b: (a + b, a * b))
    held = [g(_x(3, v), _x(3, 2.0)) for v in (1.0, 2.0, 3.0, 4.0)]
    for v, (s, p) in zip((1.0, 2.0, 3.0, 4.0), held):
        assert torch.equal(s, _x(3, v + 2.0)) and torch.equal(p, _x(3, 2.0 * v))


def test_the_cpu_runs_eagerly():
    graphed.reset_counts()
    g = graphed.GraphedForward(_double)
    for _ in range(4):
        g(_x(4))
    assert not g.graphs()
    assert graphed.counts()["eager_calls"] == 4 and graphed.counts()["captures"] == 0
    with pytest.raises(TypeError):
        g(4)
    ledger.reset()


@pytest.mark.parametrize("preset", [None, "1"])
def test_keep_cupti_keeps_cupti_attached_unless_the_caller_chose(monkeypatch, preset):
    for k in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT"):
        if preset is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, preset)
    graphed.keep_cupti()
    want = ("0", "1") if preset is None else (preset, preset)
    assert (os.environ["TEARDOWN_CUPTI"], os.environ["DISABLE_CUPTI_LAZY_REINIT"]) == want


# ---------------------------------------------------------------------------
# The CLIs through the graphed entry against the JAX CLIs
# ---------------------------------------------------------------------------

# Sorted longest first and batched by 2: [1200, 1150], [1000, 950], [777, 700].
LENGTHS = (1200, 1150, 1000, 950, 777, 700)
# --pad_to_multiple -> (eager calls, captures, replays): at 600 one shape
# comes three times, at 400 one comes twice and one once.
PADS = {600: (1, 1, 2), 400: (2, 1, 1)}


@pytest.fixture
def tags(monkeypatch):
    """The tags of the wrappers the CLIs build."""
    from convtasnet_torch.cli import evaluate, separate

    seen = []

    class Recording(graphed.GraphedForward):
        def __init__(self, fn, tag=()):
            seen.append(tuple(tag))
            super().__init__(fn, tag)

    for cli in (separate, evaluate):
        monkeypatch.setattr(cli, "GraphedForward", Recording)
    return seen


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("graphed")
    cfg = convtasnet_tpu.ConvTasNetConfig(**SMALL)
    params, state = convtasnet_tpu.init_params(jax.random.key(6), cfg)
    ckpt = str(root / "m.ckpt")
    j_ckpt.save_checkpoint(ckpt, cfg, params, state)
    mix_dir = root / "mix"
    rng = np.random.default_rng(6)
    for i, n in enumerate(LENGTHS):
        write_wav(str(mix_dir / f"utt{i}.wav"), 0.3 * rng.normal(size=n), 8000)
    return root, ckpt, str(mix_dir)


@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("use_kernels", ["auto", "0"])
def test_separate_cli_graphed_matches_jax(jax_model, stand_in, tags, tmp_path, pad,
                                          use_kernels):
    from convtasnet_torch.cli.separate import main
    from convtasnet_tpu.cli.separate import main as jax_main

    root, ckpt, mix_dir = jax_model
    common = ["--model_path", ckpt, "--mix_dir", mix_dir, "--batch_size", "2",
              "--pad_to_multiple", str(pad)]
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_main(common + ["--out_dir", jax_out, "--use_pallas", "0"]) == len(LENGTHS)
    assert main(common + ["--out_dir", out, "--device", "cpu",
                          "--use_kernels", use_kernels]) == len(LENGTHS)
    c = graphed.counts()
    assert (c["eager_calls"], c["captures"], c["replays"]) == PADS[pad]
    # The wrapper is keyed by the kernel form the config takes.
    assert tags == [(ConvTasNetConfig(**SMALL, use_kernels=use_kernels).kernel_form(
        False, torch.device("cpu")),)]
    want = sorted(glob.glob(os.path.join(jax_out, "*.wav")))
    got = sorted(glob.glob(os.path.join(out, "*.wav")))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3 * len(LENGTHS)
    for g, w in zip(got, want):
        a, _ = read_wav(g)
        b, _ = read_wav(w)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) * 32768 <= 1.0 + 1e-6, g


@pytest.fixture(scope="module")
def eval_set(jax_model):
    root, ckpt, _ = jax_model
    json_root = make_wav_dataset(str(root / "eval"), n_utts=4, min_sec=0.5, max_sec=1.0,
                                 seed=7, splits=("tt",))
    return ckpt, os.path.join(json_root, "tt")


@pytest.mark.parametrize("pad", [8000, 3000])
def test_evaluate_cli_graphed_matches_jax(eval_set, stand_in, tags, pad):
    from convtasnet_torch.cli import evaluate as t_eval
    from convtasnet_tpu.cli import evaluate as j_eval

    ckpt, data_dir = eval_set
    args = ["--model_path", ckpt, "--data_dir", data_dir, "--batch_size", "1",
            "--cal_sdr", "1", "--pad_to_multiple", str(pad)]
    want = j_eval.evaluate(j_eval.build_parser().parse_args(
        args + ["--sdr_backend", "host", "--use_pallas", "0"]), log=lambda s: None)
    utts = []
    got = t_eval.evaluate(t_eval.build_parser().parse_args(
        args + ["--device", "cpu", "--sdr_backend", "device"]), log=lambda s: None,
        utterances=utts)
    c = graphed.counts()
    assert c["captures"] >= 1 and c["replays"] >= 1  # the shapes repeat
    assert c["eager_calls"] + c["replays"] == want["count"] == got["count"] == 4
    assert tags == [("whole_tcn", True)]  # the form and the device SDR backend
    assert abs(got["si_snri"] - want["si_snri"]) <= TOL_DB
    assert abs(got["sdri"] - want["sdri"]) <= TOL_DB
    assert all(np.isfinite(u["sdri"]) and np.isfinite(u["si_snri"]) for u in utts)
