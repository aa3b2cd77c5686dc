"""A tiny configuration and tiny traffic for the CPU tests: the cells'
paths and checks, at sizes a test run holds."""

MODEL = dict(N=16, L=20, B=32, H=64, P=3, X=3, R=2, C=2)

TRAFFIC = {
    "paper.train.b8x4s": dict(batch=2, segment_s=0.5, pool=4, trace_units=3),
    "paper.separate.b8x4s": dict(batch=2, segment_s=0.5, pool=4, sample=2, trace_units=3),
    "paper.separate.b1x6s": dict(min_samples=4000, max_samples=4000, utterances=4,
                                 pad_to=1000, sample=2, trace_units=3),
    "causal.stream.b1x20ms": dict(min_samples=1600, max_samples=1600, utterances=3,
                                  sample=2, trace_units=3),
}

CELLS = tuple(TRAFFIC)

# The tiny model's rounding noise in a train step is larger than the
# cell's (its sound runs read grad_gap 0.004-0.005 and row_med 0.006,
# against 0.0016 and 0.0014 at the cell's size; half a batch reads
# 0.09-0.11 and 0.99), so its train check holds the tiny run to wider
# limits. The cells' own limits are held at their sizes on the card
# (test_bench_card.py).
LIMITS = {"paper.train.b8x4s": dict(loss_gap=0.03, grad_gap=0.03, row_med=0.05)}

SEED = 2 ** 31 + 77  # more than 32 signed bits, as a run's seed may be


def overrides(cell: str) -> dict:
    return {"model": MODEL, "traffic": TRAFFIC[cell], "limits": LIMITS.get(cell, {})}
