"""The plain reference: what every verify lane and every recombined row of
a slot must give, worked out again from the seeded secrets, and the
comparison that decides `correct`.

A partial is valid exactly when it is its share's signature of the duty's
root (BLS signatures are unique), so the reference signs each lane again
with the secret share and compares bytes; a row's group signature is the
group secret's signature of the root, and the row is ok when each of the
partials it recombines is valid. It imports nothing of the program.

The control stands in for the program with one guarantee broken: it
recombines each row with its Lagrange coefficients cut to 64 bits (the
width of the program's random-linear-combination exponents), a step that
makes the recombination's multi-scalar product four times cheaper.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench import bls381, gen, work

# each compared number is an exact count, so its limit is 0
LIMITS = {"verdicts_wrong": 0, "group_sigs_wrong": 0, "results_missing": 0}


@dataclass
class Expected:
    verdicts: dict  # (validator, share index) -> bool
    rows: dict  # validator -> (ok, group signature bytes or None)


def expected(inputs: gen.Inputs, slots: list, cfg: dict, workers: int | None = None) -> list:
    """Expected answers of each slot index in `slots`, in order."""
    t = cfg["threshold"]
    tasks, plan = [], []
    for s in slots:
        slot = inputs.slots[s]
        for r, root in enumerate(slot.roots):
            vals = [v for v in range(len(slot.root_of)) if slot.root_of[v] == r]
            lanes = [(v, i) for v in vals for i in slot.signers[v]]
            tasks.append(("g2", root, [inputs.shares[v][i] for v, i in lanes] + [inputs.secrets[v] for v in vals]))
            plan.append((s, lanes, vals))
    results = work.run_tasks(tasks, workers)
    out = {s: Expected({}, {}) for s in slots}
    for (s, lanes, vals), sigs in zip(plan, results):
        slot, exp = inputs.slots[s], out[s]
        for (v, i), sig in zip(lanes, sigs):
            exp.verdicts[v, i] = slot.partials[v][i] == sig
        for v, sig in zip(vals, sigs[len(lanes) :]):
            ok = all(exp.verdicts[v, i] for i in gen.recombine_indices(slot, v, t))
            exp.rows[v] = (ok, sig if ok else None)
    return [out[s] for s in slots]


def compare(subs: gen.Submissions, results: list, exp: Expected) -> dict:
    """Counts of a slot's answers against the reference: verdicts that
    differ, rows whose ok flag differs or whose group signature (of a row
    that must be ok) differs, and answers missing (a submission that
    raised or came back short); `attempted` lanes and rows, and `failed`
    those with a wrong or missing answer."""
    counts = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    for (lanes, keys), res in zip(subs.verify, results[: len(subs.verify)]):
        attempted += len(keys)
        if isinstance(res, BaseException) or len(res) != len(keys):
            counts["results_missing"] += len(keys)
            failed += len(keys)
            continue
        wrong = sum(bool(ok) != exp.verdicts[key] for ok, key in zip(res, keys))
        counts["verdicts_wrong"] += wrong
        failed += wrong
    for (args, rows), res in zip(subs.recombine, results[len(subs.verify) :]):
        attempted += len(rows)
        if isinstance(res, BaseException) or len(res[0]) != len(rows) or len(res[1]) != len(rows):
            counts["results_missing"] += len(rows)
            failed += len(rows)
            continue
        wrong = 0
        for v, sig, ok in zip(rows, *res):
            want_ok, want_sig = exp.rows[v]
            wrong += bool(ok) != want_ok or (want_ok and sig != want_sig)
        counts["group_sigs_wrong"] += wrong
        failed += wrong
    return {"counts": counts, "attempted": attempted, "failed": failed}


def control_results(subs: gen.Submissions, exp: Expected, workers: int | None = None) -> list:
    """The control's answers to a slot's submissions, in the program's
    shape: the reference's verdicts, and each row recombined from its
    partials with Lagrange coefficients cut to 64 bits."""
    out = [[exp.verdicts[key] for key in keys] for _, keys in subs.verify]
    tasks = []
    for (pubshares, roots, partials, gpks, indices), rows in subs.recombine:
        lam = [bls381.lagrange_at_zero(ix) for ix in indices]
        tasks.append(("combine", [(sigs, [l[i] % (1 << 64) for i in ix]) for sigs, ix, l in zip(partials, indices, lam)]))
    for ((_, rows), sigs) in zip(subs.recombine, work.run_tasks(tasks, workers)):
        out.append((sigs, [exp.rows[v][0] for v in rows]))
    return out
