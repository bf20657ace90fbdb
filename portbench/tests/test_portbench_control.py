"""The control at a size a test run holds: the reference in the program's
place with its Lagrange coefficients cut to 64 bits is not correct, and
the reference's own answers in the program's place are."""

from portbench import control, gen, reference

CFG = {"name": "tiny", "validators": 3, "nodes": 7, "threshold": 4, "roots_per_slot": 1, "signers": 7}
TRAFFIC = {"ring_slots": 1, "untimed_slots": 1, "spread_s": 0.0, "forged_per_slot": 0}


def test_the_control_fails_the_group_signatures():
    got = control.control(CFG, TRAFFIC, seed=2**32 + 9, slots=1, workers=2)
    assert got["counts"]["group_sigs_wrong"] == CFG["validators"] > reference.LIMITS["group_sigs_wrong"]
    assert got["counts"]["verdicts_wrong"] == got["counts"]["results_missing"] == 0
    assert got["attempted"] == 3 * 7 + 3 and got["failed"] == 3


def test_the_references_own_answers_pass():
    traffic = {**TRAFFIC, "forged_per_slot": 1}
    inputs = gen.generate(CFG, traffic, 77, workers=2)
    [exp] = reference.expected(inputs, [1], CFG, workers=2)
    subs = gen.submissions(inputs, inputs.slots[1], CFG, traffic, 77, 1)
    answers = [[exp.verdicts[k] for k in keys] for _, keys in subs.verify]
    answers += [([exp.rows[v][1] for v in rows], [exp.rows[v][0] for v in rows]) for _, rows in subs.recombine]
    got = reference.compare(subs, answers, exp)
    assert got["failed"] == 0 and not any(got["counts"].values())
    assert sum(not ok for ok in exp.verdicts.values()) == 1
    # an answer that never came is missing, not wrong
    got = reference.compare(subs, [RuntimeError("lost")] + answers[1:], exp)
    assert got["counts"]["results_missing"] == len(subs.verify[0][1]) and got["counts"]["verdicts_wrong"] == 0
