"""The readings of the SD cell's limits: ``bench/controls.py``, with the
faults of ``bench/harness/planted_sd.py`` beside its own readings.

    python3 bench/controls_sd.py --workload imagenet-sd.fit-resident --reading <reading> --seeds <a>,<b>,... [--seconds 3]

Readings: those of ``bench/controls.py``, and ``labels-l2``,
``s-other-seed`` and ``centered-gram-bf16``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import controls  # noqa: E402
from bench.harness import planted, planted_sd  # noqa: E402


def main(argv=None) -> int:
    with mock.patch.object(planted, "reading", planted_sd.reading):
        return controls.main(argv)


if __name__ == "__main__":
    sys.exit(main())
