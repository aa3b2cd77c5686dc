"""The port's one ledger of launches, counted on the host.

Every hand-written kernel wrapper (ops/kernels/) counts each launch here
under the name of its kernel and mode (`tcn_in_gemm`, `tcn_dwconv_save`,
`tcn_out_gemm_fold_skip`, `tcn_bwd_dwconv`, `tcn_stream_block`, ...), and
parallel/comm.py each collective it launches as `collectives`. The
modules' counts() are views of their own names here.

A CUDA graph's replay reaches no wrapper: models/graphed.py takes what a
capture counted (recorded, not run) off again and adds it back on every
replay, so every counter counts executions, eager and replayed alike.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

_COUNTS: Dict[str, int] = {}


def count(name: str) -> None:
    """One launch of `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + 1


def read(names: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """Every counter counted so far, or those of `names` (0 for a name
    never counted)."""
    if names is None:
        return dict(_COUNTS)
    return {name: _COUNTS.get(name, 0) for name in names}


def add(delta: Mapping[str, int]) -> None:
    """Add a change of counts, name by name."""
    for name, n in delta.items():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def reset(names: Optional[Iterable[str]] = None) -> None:
    """Zero every counter, or those of `names`."""
    for name in list(_COUNTS) if names is None else names:
        _COUNTS[name] = 0
