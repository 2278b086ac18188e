"""Natural ("human") sorting of filenames (copy of
``tpu3dlm/utils/natsort.py``): ``1.jpg … 10.jpg`` pair with ``1.png …
10.png`` in frame order, with no third-party ``natsort``."""

from __future__ import annotations

import re
from typing import Iterable

_CHUNK = re.compile(r"(\d+)")


def natsort_key(s: str):
    """Split into (str, int, str, ...) chunks so numeric runs compare numerically."""
    return tuple(int(p) if p.isdigit() else p for p in _CHUNK.split(s))


def natsorted(items: Iterable[str]) -> list[str]:
    return sorted(items, key=natsort_key)
