"""What every work file shares: the norm statistics' bytes.

A work file `<counter>.py` is named after one of the port's launch
counters and gives `work(s, n) -> (bytes, operations, dtype)` for n
launches at the unit's shapes `s` (M rows of K frames, the model widths,
`it` bytes per activation). Bytes count each input read once and each
output written once, at the K frames the input holds, whatever the kernel
reads again or pads; operations are what the arithmetic needs.
"""


def stats_bytes(s) -> int:
    """One set of norm statistics (sum, sum of squares) in float32: per
    utterance for gLN, per frame for cLN."""
    per = s["M"] * (s["K"] if s["norm"] == "cLN" else 1)
    return per * 2 * 4


def dtype(s) -> str:
    return "bfloat16" if s["it"] == 2 else "float32"
