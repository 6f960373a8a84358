"""The comparison fails what it must: the control (a path of the port that
breaks a guarantee the configuration states) and faults planted in the
timed path underneath an otherwise whole run on the CPU.

Each run skips only the harness's look for a card.  For the planted
faults the port's own verify is left out, so that the reference alone
must find them: a prove that returns its state unchanged (the last
container again), half of the container's tables left out, and an answer
altered where it is produced (the committed public values, a Merkle root).
A cell on one card has no exchange between chips to leave out."""

from __future__ import annotations

import pytest

from portbench.core import harness

from portbench.tests.portbench_cells import (  # noqa: F401
    SEED, CachedProgram, cell, proven, run_cached)


class StaleProgram(CachedProgram):
    """Each prove returns the container of the scenario before it: a step
    that hands back its state unchanged."""

    def _cached(self, circuit, data, auth, **kwargs):
        container = super()._cached(circuit, data, auth, **kwargs)
        stale, self._last = getattr(self, "_last", None), container
        return stale or container


class HalfTablesProgram(CachedProgram):
    def _cached(self, *args, **kwargs):
        container = super()._cached(*args, **kwargs)
        container["gadgets"] = container["gadgets"][: len(container["gadgets"]) // 2]
        return container


class AlteredValuesProgram(CachedProgram):
    def _cached(self, *args, **kwargs):
        container = super()._cached(*args, **kwargs)
        pv = bytearray(bytes.fromhex(container["public_values"]))
        pv[len(pv) // 2] ^= 1
        container["public_values"] = pv.hex()
        return container


class AlteredRootProgram(CachedProgram):
    def _cached(self, *args, **kwargs):
        container = super()._cached(*args, **kwargs)
        proof = container["gadgets"][-1]["proof"]
        proof["root_t"] = [(proof["root_t"][0] + 1) % 2013265921] + list(proof["root_t"][1:])
        return container


def _numbers(out):
    return {k: v["value"] for k, v in out.line["checks"].items()}


def test_a_sound_run_is_correct(cell, proven):
    out = run_cached(cell, proven)
    assert out.line["correct"] is True
    assert all(v == 0 for v in _numbers(out).values())


@pytest.mark.parametrize("program,number", [
    (StaleProgram, "wrong_statement"),
    (HalfTablesProgram, "rejected_by_reference"),
    (AlteredValuesProgram, "wrong_statement"),
    (AlteredValuesProgram, "rejected_by_reference"),
    (AlteredRootProgram, "rejected_by_reference"),
])
def test_a_planted_fault_is_not_correct(cell, proven, program, number):
    out = run_cached(cell, proven, program_cls=program)
    assert out.line["correct"] is False
    assert _numbers(out)[number] >= 1, out.notes


def test_the_control_is_not_correct(cell):
    """The port with its curve tables switched off (``DVT_G1=0``): faster,
    and hash-bound where the configuration states curve-bound."""
    out = harness.run(cell, SEED, 1e6, False, device="cpu", control="g1-omitted")
    numbers = _numbers(out)
    assert out.line["correct"] is False
    assert numbers["rejected_by_reference"] >= 1 and numbers["failed_in_window"] >= 1


def test_the_stale_container_control_is_not_correct(cell, proven):
    """Every prove answered by the warm-up's container."""
    out = run_cached(cell, proven, control="stale-container")
    numbers = _numbers(out)
    assert out.line["correct"] is False
    assert numbers["wrong_statement"] >= 1 and numbers["rejected_by_reference"] == 0
