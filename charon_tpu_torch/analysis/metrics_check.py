"""Metrics catalogue sync: app/metrics.py <-> docs/metrics.md.

docs/metrics.md is the hand-maintained catalogue of every metric
family the node exports ("add a row here when you add a family") — the
reference project generates its equivalent from promauto, so drift is
impossible there and silent here. This checker closes the gap: it
instantiates `ClusterMetrics` (a throwaway registry — no server, no
jax), collects every family it registers, parses the backticked family
names out of the catalogue's tables, and fails on drift in either
direction:

  * registered but undocumented ... operators can't find it, FAIL
  * documented but unregistered ... dangling docs (renamed/removed
    family), FAIL

Sections after "# Span catalogue" document tracer span names, and the
promrated-sidecar section documents a *separate process's* registry —
both excluded from the family comparison.

CLI: `python -m charon_tpu_torch.analysis.metrics_check` — wired into
`ci.sh analysis`.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

DOCS = Path(__file__).resolve().parents[2] / "docs" / "metrics.md"

_ROW = re.compile(r"^\|\s*`([a-z0-9_]+)`\s*\|\s*([a-z]+)\s*\|")


def registered_families() -> dict[str, str]:
    """family name -> type, from a throwaway ClusterMetrics registry."""
    from charon_tpu_torch.app.metrics import ClusterMetrics

    m = ClusterMetrics("deadbeef", "analysis-check", "0")
    fams: dict[str, str] = {}
    for metric in m.registry.collect():
        name = metric.name
        if metric.type == "counter":
            # prometheus_client strips the _total suffix from the
            # family name; the docs (and exposition) carry it
            name += "_total"
        fams[name] = metric.type
    return fams


def documented_families(docs_path: Path = DOCS) -> dict[str, str]:
    """family name -> documented type, from the metric tables (up to
    the span catalogue, skipping the promrated sidecar's section)."""
    fams: dict[str, str] = {}
    in_skipped_section = False
    for line in docs_path.read_text(encoding="utf-8").splitlines():
        if line.startswith("# ") and "Span catalogue" in line:
            break
        if line.startswith("## "):
            in_skipped_section = "promrated" in line.lower()
            continue
        if in_skipped_section:
            continue
        m = _ROW.match(line)
        if m:
            fams[m.group(1)] = m.group(2)
    return fams


def compare(
    registered: dict[str, str], documented: dict[str, str]
) -> list[str]:
    errors = []
    for name in sorted(set(registered) - set(documented)):
        errors.append(
            f"{name} ({registered[name]}) is registered in "
            "app/metrics.py but missing from docs/metrics.md"
        )
    for name in sorted(set(documented) - set(registered)):
        errors.append(
            f"{name} is documented in docs/metrics.md but no longer "
            "registered in app/metrics.py"
        )
    for name in sorted(set(documented) & set(registered)):
        if documented[name] != registered[name]:
            errors.append(
                f"{name}: documented as {documented[name]} but "
                f"registered as {registered[name]}"
            )
    return errors


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="charon_tpu_torch.analysis.metrics_check")
    ap.add_argument("--docs", default=str(DOCS))
    args = ap.parse_args(argv)

    registered = registered_families()
    documented = documented_families(Path(args.docs))
    errors = compare(registered, documented)
    for e in errors:
        print(f"metrics-catalogue: {e}")
    if errors:
        print(
            f"{len(errors)} catalogue drift(s) — docs/metrics.md is the "
            "operator contract: add/remove the row with the family",
            file=sys.stderr,
        )
        return 1
    print(
        f"metrics catalogue in sync: {len(registered)} families "
        "documented"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
