"""The readers of the program's spans (`benchmark/spans.py` and the seven
`metrics/*` that use it) on hand-built slices: their arithmetic, the
backward's kernels matched on another thread than the span's, a count
that disagrees with the harness's raising, a program that marks no spans
reading nothing; and the tiny encode cells, traced on the CPU, reading
the three host spans."""

import pytest

from benchmark import cells, run, spans, trace
from benchmark.tests.conftest import REPO

ENCODE = ("dispatch_ms_per_batch.encode", "rans_wait_ms_per_batch.encode",
          "tail_ms_per_pass.encode")
TRAIN = ("fwd_device_ms_per_step.train", "bwd_device_ms_per_step.train",
         "opt_device_ms_per_step.train", "bn_device_ms_per_step.train")
MAIN, AUTOGRAD = (1, 1), (1, 2)


def host(name, start, dur, tid=MAIN, corr=None):
    return trace.Event(name, float(start), float(dur), tid, corr)


def encode_slice(batches=3):
    """A pass from 0 to 1000 us: batch i dispatched for 10 (i + 1) us,
    its coding waited for i + 1 us, its readback waited for from
    780 + 20 i us to 800 + 20 i us."""
    ev = [host("encode.pass", 0, 1000), host("encode.tail", 700, 300),
          host("encode.write", 900, 90)]
    for i in range(batches):
        ev += [host("encode.dispatch", 100 * i, 10 * (i + 1)),
               host("encode.rans_wait", 100 * i + 50, i + 1),
               host("encode.readback_wait", 780 + 20 * i, 20)]
    return trace.Slice(0.0, 1000.0, [], ev)


def train_slice(steps=2, bn_backward=True):
    """Steps of 1000 us: forward [0, 300), backward [300, 700) on the
    main thread, optimizer [700, 900). Each phase launches one kernel;
    the backward's from autograd's thread, where the norm's backward span
    lies. A BatchNorm forward span in the forward launches one kernel
    of 7 us and its backward one of 11 us."""
    host_ev, dev = [], []
    corr = 0

    def launch(t, dur, tid=MAIN):
        nonlocal corr
        corr += 1
        host_ev.append(host("cudaLaunchKernel", t, 1, tid, corr))
        dev.append(trace.Event(f"k{corr}", t + 2, float(dur), (0, 7), corr))

    for i in range(steps):
        t = 1000 * i
        host_ev += [host("train.forward", t, 300),
                    host("train.backward", t + 300, 400),
                    host("train.optimizer", t + 700, 200),
                    host("nn.batchnorm", t + 100, 50)]
        launch(t + 10, 5)                   # forward, outside the norm
        launch(t + 110, 7)                  # the norm's forward
        launch(t + 320, 3, AUTOGRAD)        # backward, outside the norm
        if bn_backward:
            host_ev.append(host("nn.batchnorm.backward", t + 400, 60,
                                AUTOGRAD))
        launch(t + 410, 11, AUTOGRAD)       # the norm's backward
        launch(t + 710, 13)                 # optimizer
        launch(t + 950, 17)                 # in no span
    return trace.Slice(0.0, 1000.0 * steps, dev, host_ev)


def reader(name):
    return cells.metric_reader(name)


def record(cell, s, **info):
    return cells.Record(cells.load_cell(REPO, cell), {}, s, info)


def test_encode_readers_arithmetic():
    rec = record("vitb32.encode_stl10", encode_slice(),
                 slice_batches=[512, 512, 200])
    assert reader(ENCODE[0])(rec) == pytest.approx(0.020, rel=1e-12)
    assert reader(ENCODE[1])(rec) == pytest.approx(0.002, rel=1e-12)
    # the last readback wait ends at 840 us, the pass at 1000
    assert reader(ENCODE[2])(rec) == pytest.approx(0.160, rel=1e-12)


def test_training_readers_arithmetic_on_any_thread():
    rec = record("bince.train", train_slice(), slice_steps=2)
    got = {n: reader(n)(rec) for n in TRAIN}
    assert got == pytest.approx({TRAIN[0]: 0.012, TRAIN[1]: 0.014,
                                 TRAIN[2]: 0.013, TRAIN[3]: 0.018},
                                rel=1e-12)
    # the same-thread match of `trace.py` misses the backward's kernels
    s = rec.slice
    assert len(s.launched_under(r"^train\.backward$")) == 0
    assert len(spans.launched_in(s, {"train.backward"})) == 4


@pytest.mark.parametrize("name", ENCODE)
def test_encode_span_count_off_the_batches_raises(name):
    rec = record("vitb32.encode_stl10", encode_slice(3),
                 slice_batches=[512] * 4)
    with pytest.raises(RuntimeError):
        reader(name)(rec)


@pytest.mark.parametrize("name", TRAIN)
def test_training_span_count_off_the_steps_raises(name):
    rec = record("bince.train", train_slice(3), slice_steps=2)
    with pytest.raises(RuntimeError):
        reader(name)(rec)


def test_batchnorm_backward_spans_missing_raises():
    rec = record("bince.train", train_slice(2, bn_backward=False),
                 slice_steps=2)
    with pytest.raises(RuntimeError):
        reader(TRAIN[3])(rec)


@pytest.mark.parametrize("name", ENCODE + TRAIN)
def test_a_program_without_spans_reads_nothing(name):
    """The slice of a program that has no spans: its kernels and operators
    traced, none of the names; the reader returns None."""
    s = train_slice()
    s.host = [h for h in s.host if h.name == "cudaLaunchKernel"]
    rec = record("bince.train", s, slice_steps=2, slice_batches=[512] * 2)
    assert reader(name)(rec) is None


@pytest.mark.parametrize("cell", ["vitb32.encode_stl10",
                                  "vitb32.encode_in256"])
def test_tiny_encode_cells_read_their_spans(tiny, cell):
    root, bench = tiny
    result = run.run_cell(root, cell, 2 ** 31 + 11, 0.0, True, "cpu",
                          bench_dir=bench)
    assert result["correct"] is True
    for name in ENCODE:
        value = result["metrics"][name]["value"]
        assert value >= 0.0 and (value > 0.0 or name == ENCODE[1]), name
