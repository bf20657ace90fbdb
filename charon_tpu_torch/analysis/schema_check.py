"""Codec wire-schema stability check: append-only, machine-enforced.

The binary codec's compatibility story (docs/operations.md "Wire
format") rests on the wire-id tables being APPEND-ONLY: a type or enum
never loses its id, ids are never renumbered, and a registered
dataclass's field program only ever grows at the tail (new trailing
fields must be defaulted, so old frames still decode and old nodes
drop the unknown tail). Large committee-BLS deployments treat exactly
this — serialization-schema stability — as a hard compatibility
contract (arXiv:2302.00418): a silent renumber turns every
mixed-version cluster into a CodecError storm at the transport.

This checker snapshots the live registry (`_TYPE_WIRE_IDS` /
`_ENUM_WIRE_IDS` + per-type field programs + enum member values) and
compares it against the committed golden
`tests/testdata/wire_schema.json`:

  * removed / renumbered type or enum id ............ FAIL
  * reordered / removed / renamed existing field ..... FAIL
  * new REQUIRED field on an existing type ........... FAIL
    (old frames omit it; decode would reject them)
  * changed enum member value / removed member ....... FAIL
  * appended type, enum, defaulted field, member ..... OK (run with
    `--update` to re-bless the golden once the change is checked)

CLI: `python -m charon_tpu_torch.analysis.schema_check [--update]` — wired
into `ci.sh analysis`. Imports only p2p/codec (jax-free).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

GOLDEN = (
    Path(__file__).resolve().parents[2]
    / "tests"
    / "testdata"
    / "wire_schema.json"
)


def current_snapshot() -> dict:
    from charon_tpu_torch.p2p import codec

    types: dict[str, dict] = {}
    for name, wid in codec._TYPE_WIRE_IDS.items():
        sch = codec._SCHEMAS.get(name)
        if sch is None:
            # a wire id reserved for a type that never registered is
            # itself a schema bug — surface it as a snapshot entry the
            # compare step will flag against the golden
            types[name] = {"id": wid, "fields": None, "n_required": None}
            continue
        types[name] = {
            "id": wid,
            "fields": list(sch.field_names),
            "n_required": sch.n_required,
        }
    enums: dict[str, dict] = {}
    for name, wid in codec._ENUM_WIRE_IDS.items():
        cls = codec._ENUMS.get(name)
        enums[name] = {
            "id": wid,
            "members": (
                {m.name: int(m.value) for m in cls} if cls else None
            ),
        }
    return {"version": 1, "types": types, "enums": enums}


def compare(golden: dict, current: dict) -> list[str]:
    """Append-only violations of `current` against `golden`."""
    errors: list[str] = []
    g_types = golden.get("types", {})
    c_types = current.get("types", {})
    for name, g in g_types.items():
        c = c_types.get(name)
        if c is None:
            errors.append(f"type {name}: removed from the wire-id table")
            continue
        if c["id"] != g["id"]:
            errors.append(
                f"type {name}: wire id renumbered {g['id']} -> {c['id']}"
            )
        gf, cf = g.get("fields"), c.get("fields")
        if gf is None or cf is None:
            if gf != cf:
                errors.append(f"type {name}: registration state changed")
            continue
        if cf[: len(gf)] != gf:
            errors.append(
                f"type {name}: existing field program changed "
                f"(golden {gf} is not a prefix of {cf}) — fields are "
                "append-only"
            )
        elif len(cf) > len(gf) and c["n_required"] > g["n_required"]:
            errors.append(
                f"type {name}: appended field(s) {cf[len(gf):]} are "
                "REQUIRED (n_required {} -> {}) — old frames omit them "
                "and would be rejected; give them defaults".format(
                    g["n_required"], c["n_required"]
                )
            )
        elif c["n_required"] != g["n_required"] and len(cf) == len(gf):
            errors.append(
                f"type {name}: n_required changed "
                f"{g['n_required']} -> {c['n_required']} with no new "
                "fields — a required/default flip on an existing field"
            )
    # duplicate id check (current side)
    seen: dict[int, str] = {}
    for name, c in c_types.items():
        if c["id"] in seen:
            errors.append(
                f"type {name}: wire id {c['id']} collides with "
                f"{seen[c['id']]}"
            )
        seen[c["id"]] = name
    g_enums = golden.get("enums", {})
    c_enums = current.get("enums", {})
    seen_e: dict[int, str] = {}
    for name, c in c_enums.items():
        if c["id"] in seen_e:
            errors.append(
                f"enum {name}: wire id {c['id']} collides with "
                f"{seen_e[c['id']]}"
            )
        seen_e[c["id"]] = name
    for name, g in g_enums.items():
        c = c_enums.get(name)
        if c is None:
            errors.append(f"enum {name}: removed from the wire-id table")
            continue
        if c["id"] != g["id"]:
            errors.append(
                f"enum {name}: wire id renumbered {g['id']} -> {c['id']}"
            )
        gm, cm = g.get("members") or {}, c.get("members") or {}
        for member, val in gm.items():
            if member not in cm:
                errors.append(f"enum {name}.{member}: member removed")
            elif cm[member] != val:
                errors.append(
                    f"enum {name}.{member}: value changed "
                    f"{val} -> {cm[member]}"
                )
    return errors


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="charon_tpu_torch.analysis.schema_check")
    ap.add_argument(
        "--update",
        action="store_true",
        help="re-bless the golden snapshot from the live registry "
        "(use only after checking an append-only change)",
    )
    ap.add_argument("--golden", default=str(GOLDEN))
    args = ap.parse_args(argv)

    current = current_snapshot()
    golden_path = Path(args.golden)
    if args.update:
        golden_path.write_text(
            json.dumps(current, indent=1, sort_keys=True) + "\n"
        )
        print(f"wire schema golden updated: {golden_path}")
        return 0
    if not golden_path.exists():
        print(
            f"missing golden {golden_path}; run with --update to create",
            file=sys.stderr,
        )
        return 1
    golden = json.loads(golden_path.read_text())
    errors = compare(golden, current)
    for e in errors:
        print(f"wire-schema: {e}")
    if errors:
        print(
            f"{len(errors)} wire-schema violation(s) — the binary codec "
            "tables are an append-only compatibility contract "
            "(docs/operations.md 'Wire format')",
            file=sys.stderr,
        )
        return 1
    n = len(current["types"]) + len(current["enums"])
    print(f"wire schema stable: {n} ids match {golden_path.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
