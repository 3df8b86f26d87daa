"""Trial-name formatting helpers (the same rendering as
``srgan_tpu.utils.scientific``)."""

from __future__ import annotations

import re


def clean_scientific_notation(value: float) -> str:
    """Render a float compactly: 1e-4 → '1e-4', 0.5 → '0.5', 10.0 → '10'."""
    s = f"{value:g}"
    s = re.sub(r"e\+?0*(\d)", r"e\1", s)
    s = re.sub(r"e-0*(\d)", r"e-\1", s)
    return s
