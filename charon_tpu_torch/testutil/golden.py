"""Golden-file test helpers.

Mirrors ref: testutil/golden.go:36-86 (RequireGoldenBytes/JSON + testdata/
directories + an -update flag): assertions against committed golden files
catch unintended format drift in consensus-critical serializations (lock
hashes, wire envelopes, records). A missing golden FAILS (like the Go
counterpart) — run with env UPDATE_GOLDEN=1 to (re)generate.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


def _should_update() -> bool:
    return os.environ.get("UPDATE_GOLDEN", "") not in ("", "0")


def golden_path(test_file: str, name: str) -> Path:
    d = Path(test_file).resolve().parent / "testdata"
    d.mkdir(exist_ok=True)
    return d / name


def require_golden_bytes(test_file: str, name: str, data: bytes) -> None:
    path = golden_path(test_file, name)
    if _should_update():
        path.write_bytes(data)
        return
    assert path.exists(), (
        f"golden file {path} missing — run with UPDATE_GOLDEN=1 to create"
    )
    want = path.read_bytes()
    assert data == want, (
        f"golden mismatch for {name}: got {len(data)}B, want {len(want)}B "
        f"(set UPDATE_GOLDEN=1 to regenerate)"
    )


def require_golden_json(test_file: str, name: str, obj) -> None:
    data = (
        json.dumps(obj, indent=2, sort_keys=True).encode() + b"\n"
    )
    require_golden_bytes(test_file, name, data)
