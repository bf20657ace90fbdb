"""PyTorch port: the slot helpers of chip_smoke.py that plane_ab.py drives
the plane's A/B through (slot_calls, check_slot), and plane_ab.py's refusal
to run without a card. Host-only: fake validators of the shape
chip_smoke.make_validator returns (group pubkey, message, pubshares by
index, partials by index, group secret, group signature); no device work.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
import plane_ab  # noqa: E402


def _vals(n: int, signers=(1, 3, 4, 6)) -> list:
    return [
        (f"pk{v}".encode(), f"msg{v}".encode(), {i: f"ps{v}.{i}".encode() for i in range(1, 8)},
         {i: f"sig{v}.{i}".encode() for i in signers}, v + 100, f"group{v}".encode())
        for v in range(n)
    ]


@pytest.mark.parametrize("n", [2, 16, 1024])
def test_slot_calls_split_every_partial_and_every_validator(n):
    vals = _vals(n)
    calls, duties = S.slot_calls(vals)
    assert len(calls) == min(S.PLANE_VERIFY_CALLS, 4 * n)
    assert [lane for call in calls for lane in call] == [
        (v[2][i], v[1], v[3][i]) for v in vals for i in (1, 3, 4, 6)
    ]
    assert len(duties) == 2 and [len(d[1]) for d in duties] == [n // 2, n - n // 2]
    pubshares, roots, partials, group_pks, idx = duties[1]
    assert roots == [v[1] for v in vals[n // 2 :]] and group_pks == [v[0] for v in vals[n // 2 :]]
    assert idx[0] == [1, 3, 4, 6] and partials[0] == [vals[n // 2][3][i] for i in (1, 3, 4, 6)]
    assert pubshares[0] == [vals[n // 2][2][i] for i in (1, 3, 4, 6)]


def test_check_slot_holds_verdicts_and_signatures():
    vals = _vals(4)
    vres = [[True] * 8, [True] * 8]
    rres = [([v[5] for v in vals[:2]], [True, True]), ([v[5] for v in vals[2:]], [True, True])]
    S.check_slot("slot", vals, vres, rres)
    S.check_slot("slot", vals, vres, rres, [v[5] for v in vals])
    with pytest.raises(AssertionError, match="a verdict is False"):
        S.check_slot("slot", vals, [[True] * 8, [True] * 7 + [False]], rres)
    with pytest.raises(AssertionError, match="a verdict is False"):
        S.check_slot("slot", vals, vres, [rres[0], (rres[1][0], [True, False])])
    with pytest.raises(AssertionError, match=r"validators \[3\]"):
        S.check_slot("slot", vals, vres, [rres[0], ([vals[2][5], b"other"], [True, True])])


def test_plane_ab_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert plane_ab.main(["--base", str(ROOT)]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
