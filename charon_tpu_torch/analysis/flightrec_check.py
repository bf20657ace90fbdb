"""Flight-recorder event-schema stability check: append-only.

Flight-recorder dumps are the post-mortem interface: incident tooling
(the `flight merge` CLI, cross-node reconstruction in obs_check, any
operator jq one-liner from docs/operations.md) parses the JSONL a node
wrote BEFORE it died, possibly a version behind the tooling reading
it. Like the wire codec (analysis/schema_check.py), that makes the
event schema a compatibility contract:

  * removed category / event kind ................... FAIL
  * kind moved between categories ................... FAIL
  * removed envelope key / reordered prefix ......... FAIL
  * schema version lowered .......................... FAIL
  * appended category, kind, envelope key ........... OK (run with
    `--update` to re-bless the golden once the change is checked)

The snapshot is the declared vocabulary in `app/flightrec.py`
(SCHEMA_VERSION / CATEGORIES / EVENT_KINDS / ENVELOPE_FIELDS), not a
runtime sample — the contract is what the adapters CAN emit.

CLI: `python -m charon_tpu_torch.analysis.flightrec_check [--update]` —
wired into `ci.sh analysis`. Imports only app/flightrec (jax-free).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

GOLDEN = (
    Path(__file__).resolve().parents[2]
    / "tests"
    / "testdata"
    / "flightrec_schema.json"
)


def current_snapshot() -> dict:
    from charon_tpu_torch.app import flightrec

    return {
        "schema_version": flightrec.SCHEMA_VERSION,
        "categories": list(flightrec.CATEGORIES),
        "envelope": list(flightrec.ENVELOPE_FIELDS),
        "kinds": {
            cat: sorted(kinds)
            for cat, kinds in flightrec.EVENT_KINDS.items()
        },
    }


def compare(golden: dict, current: dict) -> list[str]:
    """Append-only violations of `current` against `golden`."""
    errors: list[str] = []
    if current["schema_version"] < golden["schema_version"]:
        errors.append(
            "schema_version lowered "
            f"{golden['schema_version']} -> {current['schema_version']}"
        )
    g_cats, c_cats = golden["categories"], current["categories"]
    if c_cats[: len(g_cats)] != g_cats:
        errors.append(
            f"category list changed (golden {g_cats} is not a prefix "
            f"of {c_cats}) — categories are append-only"
        )
    g_env, c_env = golden["envelope"], current["envelope"]
    if c_env[: len(g_env)] != g_env:
        errors.append(
            f"envelope keys changed (golden {g_env} is not a prefix "
            f"of {c_env}) — envelope keys are append-only"
        )
    g_kinds = golden.get("kinds", {})
    c_kinds = current.get("kinds", {})
    for cat, kinds in g_kinds.items():
        cur = c_kinds.get(cat)
        if cur is None:
            errors.append(f"category {cat}: kind vocabulary removed")
            continue
        # tooling keys filters on the (category, kind) PAIR — a kind
        # vanishing from its golden category is a break even if the
        # same name (e.g. "shed") legitimately exists elsewhere too
        for kind in kinds:
            if kind not in cur:
                errors.append(f"kind {cat}/{kind}: removed")
    return errors


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="charon_tpu_torch.analysis.flightrec_check")
    ap.add_argument(
        "--update",
        action="store_true",
        help="re-bless the golden snapshot from the declared vocabulary "
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
        print(f"flight-recorder schema golden updated: {golden_path}")
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
        print(f"flightrec-schema: {e}")
    if errors:
        print(
            f"{len(errors)} flight-recorder schema violation(s) — dumps "
            "are parsed by incident tooling a version apart; the event "
            "vocabulary is append-only (docs/operations.md 'Incident "
            "debugging with the flight recorder')",
            file=sys.stderr,
        )
        return 1
    n = sum(len(v) for v in current["kinds"].values())
    print(
        f"flight-recorder schema stable: {len(current['categories'])} "
        f"categories / {n} kinds match {golden_path.name}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
