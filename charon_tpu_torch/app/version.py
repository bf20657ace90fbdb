"""Version identity + peer compatibility negotiation.

Mirrors ref: app/version — the reference advertises its semantic version
through peerinfo and refuses protocol interaction with peers outside the
supported minor-version window (version.Supported()). Peerinfo wires
check_compatible() and surfaces incompatible peers to the operator.
"""

from __future__ import annotations

VERSION = "0.2.0"

# Minor versions this build interoperates with (ref: version.Supported
# returns the current and previous minors).
SUPPORTED_MINORS = ("0.2", "0.1")


def minor(version: str) -> str:
    parts = str(version).split(".")
    return ".".join(parts[:2]) if len(parts) >= 2 else str(version)


def check_compatible(peer_version) -> bool:
    """True when the peer's minor version is in our supported window.
    Tolerates untrusted/untyped wire input (coerced to str)."""
    return minor(peer_version) in SUPPORTED_MINORS
