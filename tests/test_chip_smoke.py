"""`chip_smoke.py`'s phases at toy grids on the CPU: the one-card path
with the kernels in the Pallas interpreter, and the four-card path on
four of the eight virtual CPU devices. The script itself refuses to run
without a GPU; these tests import its phases."""

import importlib.util
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_GRIDS = {"1deg": (24, 16, 8), "quarter": (32, 24, 10)}


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phases(out):
    """(names that passed, names that failed) from the phase log lines."""
    ok = [l[3:].rsplit(": ok", 1)[0] for l in out.splitlines()
          if l.startswith("== ") and ": ok (" in l]
    failed = [l for l in out.splitlines() if ": FAILED" in l]
    return ok, failed


def test_one_card_phases_at_toy_size(smoke, capsys):
    smoke.run_one_card(TOY_GRIDS, "interpret", tol_age=1e-9)
    ok, failed = _phases(capsys.readouterr().out)
    assert not failed
    assert ok == [
        "1 degree: assembly and invariants",
        "1 degree: 200 Euler steps, 1 tracer and B=8",
        "1 degree: refined ideal age",
        "1 degree: water-mass fractions, R=4",
        "kernels vs references, 1 degree",
        "0.25 degree: assembly",
        "0.25 degree: 100 Euler steps, 1 tracer and B=8",
        "0.25 degree: preconditioner apply",
        "kernels vs references, 0.25 degree",
    ]


def test_four_card_phases_at_toy_size(smoke, capsys):
    smoke.run_four_cards(TOY_GRIDS)
    ok, failed = _phases(capsys.readouterr().out)
    assert not failed
    assert ok == [
        "4 cards: 0.25 degree sharded assembly",
        "4 cards: 0.25 degree, 100 sharded Euler steps",
        "4 cards: 1 degree sharded refined ideal age",
    ]


@pytest.mark.parametrize("cards", ["1", "4"])
def test_main_refuses_the_cpu(smoke, monkeypatch, capsys, cards):
    """No GPU: exit code 1 before any phase, and no JSON result."""
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--cards", cards])
    assert smoke.main() == 1
    captured = capsys.readouterr()
    assert "no GPU" in captured.err
    assert "==" not in captured.out
    for line in captured.out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
