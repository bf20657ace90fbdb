"""The traffic generator: a deployment's keys, their t-of-n splits and a
ring of slots, each slot with its own fresh signing roots and the
partial signatures of that slot's signers, all drawn from the seed, and
the submissions a node's peers make of a slot.

One generator serves every configuration and mix: the configuration
file gives the deployment (validators, nodes, threshold, roots a slot,
signers a duty), the traffic file the mix (untimed and ring slots, when
each submission is sent, forged partials a slot). After the ring comes
one check slot, which holds CHECK_FORGED more partials signed over a
stale root: a run answers it after its window, untimed, so that the
comparison sees the verify and recombine layers turn a bad partial
down."""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field

from portbench import bls381, work


@dataclass
class Slot:
    roots: list  # this slot's signing roots, fresh
    root_of: list  # validator -> index into roots
    signers: list  # validator -> sorted share indices whose partials the slot has
    partials: list  # validator -> {share index: compressed signature}
    forged: set = field(default_factory=set)  # {(validator, share index)} signed over a stale root


@dataclass
class Inputs:
    group_pks: list  # validator -> compressed group public key
    pubshares: list  # validator -> {share index: compressed public share}
    slots: list  # the untimed slots, then the ring
    secrets: list  # validator -> group secret (the reference's only)
    shares: list  # validator -> {share index: secret share} (the reference's only)


def _rng(seed: int, *parts) -> random.Random:
    return random.Random("/".join(map(str, ("portbench", seed, *parts))))


def _root(seed: int, *parts) -> bytes:
    return hashlib.sha256("/".join(map(str, ("portbench", seed, *parts))).encode()).digest()


CHECK_FORGED = 1  # forged partials the check slot holds beyond the mix's own


def slot_count(traffic: dict) -> int:
    """The untimed slots, the ring and the check slot."""
    return traffic["untimed_slots"] + traffic["ring_slots"] + 1


def check_slot(traffic: dict) -> int:
    return slot_count(traffic) - 1


def generate(cfg: dict, traffic: dict, seed: int, workers: int | None = None) -> Inputs:
    """Every input of a run from `seed`: the same seed gives the same
    inputs, and every seed the same sizes."""
    n, t, vals = cfg["nodes"], cfg["threshold"], cfg["validators"]
    roots_per_slot, signers = cfg["roots_per_slot"], cfg["signers"]
    krng = _rng(seed, "keys")
    secrets = [krng.randrange(1, bls381.R) for _ in range(vals)]
    shares = [bls381.split(sk, n, t, krng) for sk in secrets]

    tasks = [("g1", [k for sk, sh in zip(secrets, shares) for k in (sk, *sh.values())])]
    plan = []  # (slot, validator, share index) per scalar of the signing tasks, task by task
    slots = []
    for s in range(slot_count(traffic)):
        srng = _rng(seed, "slot", s)
        roots = [_root(seed, "slot", s, "root", r) for r in range(roots_per_slot)]
        root_of = [v * roots_per_slot // vals for v in range(vals)]
        sig = [sorted(srng.sample(range(1, n + 1), signers)) for _ in range(vals)]
        forged = set()
        # a forged partial is one a row recombines, so both layers meet it
        while len(forged) < traffic["forged_per_slot"] + (CHECK_FORGED if s == check_slot(traffic) else 0):
            v = srng.randrange(vals)
            forged.add((v, sig[v][srng.randrange(min(t, signers))]))
        slots.append(Slot(roots, root_of, sig, [{} for _ in range(vals)], forged))
        for r, root in enumerate(roots):
            lanes = [(v, i) for v in range(vals) if root_of[v] == r for i in sig[v] if (v, i) not in forged]
            tasks.append(("g2", root, [shares[v][i] for v, i in lanes]))
            plan.append([(s, v, i) for v, i in lanes])
        if forged:
            lanes = sorted(forged)
            tasks.append(("g2", _root(seed, "slot", s, "stale"), [shares[v][i] for v, i in lanes]))
            plan.append([(s, v, i) for v, i in lanes])

    results = work.run_tasks(tasks, workers)
    keys = results[0]
    group_pks = [keys[(n + 1) * v] for v in range(vals)]
    pubshares = [{i: keys[(n + 1) * v + i] for i in range(1, n + 1)} for v in range(vals)]
    for lanes, sigs in zip(plan, results[1:]):
        for (s, v, i), sig in zip(lanes, sigs):
            slots[s].partials[v][i] = sig
    return Inputs(group_pks, pubshares, slots, secrets, shares)


@dataclass
class Submissions:
    verify: list  # [(lanes, keys)]: lanes (pubshare, root, partial), keys (validator, share index)
    recombine: list  # [(args, validators)]: SlotCoalescer.recombine's arguments and the rows' validators
    delays: list  # seconds after the slot's start each submission (verify, then recombine) is sent


def recombine_indices(slot: Slot, v: int, t: int) -> list:
    """The shares a duty recombines from: the first t of its signers."""
    return slot.signers[v][:t]


def submissions(inputs: Inputs, slot: Slot, cfg: dict, traffic: dict, seed: int, s: int) -> Submissions:
    """A slot as the node's peers submit it: the verify calls (one a peer
    with that peer's partials), then the recombine calls (one a signing
    root), each sent at its delay."""
    n, t, vals = cfg["nodes"], cfg["threshold"], cfg["validators"]
    verify = []
    for p in range(1, n + 1):
        keys = [(v, p) for v in range(vals) if p in slot.signers[v]]
        lanes = [(inputs.pubshares[v][p], slot.roots[slot.root_of[v]], slot.partials[v][p]) for v, p in keys]
        if lanes:
            verify.append((lanes, keys))
    recombine = []
    for rows in ([v for v in range(vals) if slot.root_of[v] == r] for r in range(len(slot.roots))):
        idx = [recombine_indices(slot, v, t) for v in rows]
        args = (
            [[inputs.pubshares[v][i] for i in ix] for v, ix in zip(rows, idx)],
            [slot.roots[slot.root_of[v]] for v in rows],
            [[slot.partials[v][i] for i in ix] for v, ix in zip(rows, idx)],
            [inputs.group_pks[v] for v in rows],
            idx,
        )
        recombine.append((args, rows))
    spread = traffic["spread_s"]
    drng = _rng(seed, "slot", s, "delays")
    delays = [drng.uniform(0.0, spread) if spread else 0.0 for _ in range(len(verify) + len(recombine))]
    return Submissions(verify, recombine, delays)
