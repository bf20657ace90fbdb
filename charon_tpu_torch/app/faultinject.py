"""Env/flag-gated fault-injection registry for the production wiring.

The chaos injectors live in `testutil/chaos.py`; this registry is the
ONLY way production code reaches them. The contract is strict
inertness: unless the `CHARON_TPU_FAULT_INJECTION` env var or the
`--fault-injection` run flag carries a spec, `active()` is False, every
`wrap_*` returns its argument unchanged, and no wrapper object (nor the
chaos module itself) is ever constructed/imported — the un-instrumented
duty path pays zero overhead.

Spec syntax (also accepted by the CLI flag):

    CHARON_TPU_FAULT_INJECTION="seed=42,drop=0.1,bn_error=0.2"

Keys are `testutil.chaos.ChaosConfig` fields; a bare "1"/"on" installs
the wrappers with all-zero rates (useful to measure wrapper overhead).
The same seed replays the same fault schedule (see ChaosConfig.stream).
"""

from __future__ import annotations

import os

ENV_VAR = "CHARON_TPU_FAULT_INJECTION"

_plane = None  # FaultPlane | None — module-global, like featureset


def chaos_module():
    """testutil/chaos.py, where the injectors live, imported on first
    use so an inert process never loads it."""
    from charon_tpu_torch.testutil import chaos

    return chaos


class FaultPlane:
    """Bound chaos config + lazily-built injectors for one process."""

    def __init__(self, config) -> None:
        self.config = config
        # built on first use so an inert-but-installed plane still
        # constructs nothing it does not need
        self._partitioner = None

    @property
    def partitioner(self):
        if self._partitioner is None:
            Partitioner = chaos_module().Partitioner

            self._partitioner = Partitioner()
        return self._partitioner

    def wrap_beacon(self, beacon):
        ChaosBeacon = chaos_module().ChaosBeacon

        return ChaosBeacon(beacon, self.config)

    def wrap_tbls(self, impl):
        FlakyBackend = chaos_module().FlakyBackend

        if (
            not self.config.crypto_fail_rate
            and self.config.crypto_fail_after is None
        ):
            return impl
        return FlakyBackend(impl, self.config)

    def wrap_p2p_node(self, node):
        chaos_p2p_node = chaos_module().chaos_p2p_node

        chaos_p2p_node(node, self.config)
        return node


def active() -> bool:
    return _plane is not None


def plane() -> FaultPlane | None:
    return _plane


def install(config) -> FaultPlane:
    """Install a plane for this process (config: ChaosConfig or spec
    string). Tests and cmd_run call this; everything else only reads."""
    global _plane
    if isinstance(config, str):
        config_from_spec = chaos_module().config_from_spec

        config = config_from_spec(config)
    _plane = FaultPlane(config)
    return _plane


def uninstall() -> None:
    global _plane
    _plane = None


def init_from_env(environ=None) -> bool:
    """Install from CHARON_TPU_FAULT_INJECTION when set. Returns whether
    a plane is now active. Called once from app startup; the spec parse
    fails fast on typos (a chaos run that silently injects nothing is
    worse than a crash)."""
    spec = (environ if environ is not None else os.environ).get(ENV_VAR, "")
    if not spec:
        return False
    install(spec)
    return True


# Convenience pass-throughs: call sites stay one-liners and, when the
# plane is inert, these are attribute-check cheap with no allocation.


def maybe_wrap_beacon(beacon):
    return _plane.wrap_beacon(beacon) if _plane is not None else beacon


def maybe_wrap_tbls(impl):
    return _plane.wrap_tbls(impl) if _plane is not None else impl


def maybe_wrap_p2p_node(node):
    return _plane.wrap_p2p_node(node) if _plane is not None else node
