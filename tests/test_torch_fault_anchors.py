"""The planted faults of ``tolerance_study.py`` still plant.

Each entry of ``tolerance_study.FAULTS`` and ``PROBES`` edits a copy of a
file of ``p4fr_tpu_torch/csrc/`` by text replacement. ``plant_and_run``
finds out that a text is stale only on the card, and it replaces every
occurrence, so a text that is gone or that occurs twice would plant
nothing or more than the fault. Here, on the CPU, every text an entry
replaces must occur exactly once in its file.
"""

import os

import pytest

import tolerance_study

CSRC = os.path.join(tolerance_study.ROOT, "p4fr_tpu_torch", "csrc")
ENTRIES = [(kind, kernel, name, entry)
           for kind, table in (("fault", tolerance_study.FAULTS),
                               ("probe", tolerance_study.PROBES))
           for kernel, entries in sorted(table.items())
           for name, entry in sorted(entries.items())]


@pytest.mark.parametrize("kind,kernel,name,entry", ENTRIES,
                         ids=[f"{k}-{kernel}-{name}" for k, kernel, name, _ in ENTRIES])
def test_each_planted_text_occurs_once(kind, kernel, name, entry):
    source, *edits = entry
    assert edits and len(edits) % 2 == 0, (kind, kernel, name)
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    for old in edits[::2]:
        assert text.count(old) == 1, (kind, kernel, name, source, old)
