"""charon-tpu command line interface.

Mirrors ref: cmd/cmd.go:72 — subcommands: run, dkg, create cluster,
enr, version (the reference's cobra tree; argparse here, flags also bound
to CHARON_TPU_* environment variables like the reference's viper
binding, ref: cmd/run.go:50).

    python -m charon_tpu_torch.cmd.cli create-cluster --name test --nodes 4 \
        --threshold 3 --validators 2 --output-dir ./cluster
    python -m charon_tpu_torch.cmd.cli run --data-dir ./cluster/node0 --simnet
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from pathlib import Path


def _env_default(name: str, default=None):
    return os.environ.get(f"CHARON_TPU_{name.upper().replace('-', '_')}", default)


def run_coro(coro):
    """Run a command's async body to completion and return its result.

    The CLI is synchronous: each command builds exactly one coroutine
    and blocks on it — this is the single place that owns the event
    loop (no nested asyncio.run in command bodies).
    When main() is itself invoked from code that already has a running
    loop in this thread (async test harnesses), asyncio.run would
    refuse; run the coroutine on a private loop in a worker thread so
    the caller's loop keeps running.
    """
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    import threading

    box: dict = {}

    def _target():
        try:
            box["result"] = asyncio.run(coro)
        except BaseException as e:  # noqa: BLE001 — reraised in caller
            box["error"] = e

    # daemon thread, joined without a context manager: a KeyboardInterrupt
    # while a long-lived command (run/relay) blocks here must propagate to
    # the caller immediately, not hang joining the worker
    t = threading.Thread(target=_target, name="cli-run-coro", daemon=True)
    t.start()
    t.join()
    if "error" in box:
        raise box["error"]
    return box["result"]


def _init_featureset(args) -> int:
    """Apply --feature-set{,-enable,-disable} to the global feature
    registry before the node builds (ref: app/app.go:136
    featureset.Init). Returns nonzero on an unknown status or feature
    name so a typo fails fast instead of silently running defaults."""
    from charon_tpu_torch.app import featureset

    try:
        status = featureset.Status[args.feature_set.upper()]
    except KeyError:
        print(
            f"--feature-set {args.feature_set!r}: must be alpha, beta "
            "or stable",
            file=sys.stderr,
        )
        return 2

    def parse_features(raw: str, flag: str):
        out = []
        for name in filter(None, raw.split(",")):
            try:
                out.append(featureset.Feature(name.strip()))
            except ValueError:
                known = ", ".join(f.value for f in featureset.Feature)
                print(
                    f"{flag} {name.strip()!r}: unknown feature "
                    f"(known: {known})",
                    file=sys.stderr,
                )
                return None
        return out

    enable = parse_features(args.feature_set_enable, "--feature-set-enable")
    if enable is None:
        return 2
    disable = parse_features(args.feature_set_disable, "--feature-set-disable")
    if disable is None:
        return 2
    featureset.init(status, enable=enable, disable=disable)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="charon-tpu")
    sub = p.add_subparsers(dest="command", required=True)

    runp = sub.add_parser("run", help="run the distributed validator node")
    runp.add_argument("--data-dir", default=_env_default("data-dir", ".charon"))
    runp.add_argument("--node-index", type=int, default=int(_env_default("node-index", 0)))
    runp.add_argument("--simnet", action="store_true")
    runp.add_argument("--validator-api-port", type=int, default=int(_env_default("validator-api-port", 3600)))
    runp.add_argument("--monitoring-port", type=int, default=int(_env_default("monitoring-port", 3620)))
    runp.add_argument("--p2p-port", type=int, default=int(_env_default("p2p-port", 3610)))
    runp.add_argument("--slot-duration", type=float, default=float(_env_default("slot-duration", 12.0)))
    runp.add_argument(
        "--genesis-time",
        type=float,
        default=float(_env_default("genesis-time", 0.0)) or None,
        help="unix genesis timestamp (aligns simnet clocks across processes)",
    )
    runp.add_argument("--slots-per-epoch", type=int, default=int(_env_default("slots-per-epoch", 32)))
    runp.add_argument(
        "--peers",
        default=_env_default("peers", ""),
        help="comma-separated host:port per operator (index order)",
    )
    runp.add_argument("--no-tpu", action="store_true", help="use the pure-python tbls backend")
    # Empty env binding (unset compose templating) falls back to auto;
    # argparse validates `choices` only for command-line values, never
    # defaults, so a typo'd CHARON_TPU_CRYPTO_PLANE is caught in
    # cmd_run — at parser-build time it would abort EVERY subcommand.
    runp.add_argument(
        "--crypto-plane",
        choices=["auto", "on", "off"],
        default=_env_default("crypto-plane", "") or "auto",
        help="sharded multi-device crypto plane: auto installs it when "
        ">= 2 devices are visible (see core/cryptoplane.py)",
    )
    runp.add_argument(
        "--crypto-plane-window",
        type=float,
        default=float(_env_default("crypto-plane-window", 0.02)),
        help="base coalescing window in seconds; the plane grows it "
        "under load and duty deadlines shrink it (core/cryptoplane.py)",
    )
    runp.add_argument(
        "--crypto-plane-decode-workers",
        type=int,
        default=int(_env_default("crypto-plane-decode-workers", 4)),
        help="decode/pack thread-pool size for the pipelined host "
        "plane; 0 disables the pipeline (synchronous decode)",
    )
    runp.add_argument(
        "--crypto-plane-prewarm",
        choices=["auto", "on", "off"],
        default=_env_default("crypto-plane-prewarm", "") or "auto",
        help="compile the canonical duty shapes at startup: auto "
        "pre-warms on a TPU backend, or on any platform once a "
        "fresh tuned profile exists AND a prior prewarm completed "
        "under the same kernel sources (cache loads, not "
        "minutes-long compiles); the first off-TPU prewarm needs "
        "one explicit 'on' boot",
    )
    runp.add_argument(
        "--crypto-plane-decode",
        choices=["auto", "device", "python"],
        default=_env_default("crypto-plane-decode", "") or "auto",
        help="signature-decode rung: device batches point "
        "decompression into the flush programs (ops/decompress.py), "
        "python keeps the host bigint path, auto = device on TPU "
        "backends only (docs/operations.md 'Crypto-plane tuning')",
    )
    runp.add_argument(
        "--crypto-plane-warmup",
        choices=["auto", "on", "off"],
        default=_env_default("crypto-plane-warmup", "") or "auto",
        help="bulk point-cache warm-up at startup: decode the whole "
        "cluster key set through the batched device kernels so the "
        "first live slot starts warm; auto warms only on a TPU "
        "backend (docs/operations.md 'Cold start and rotation "
        "warm-up')",
    )
    runp.add_argument(
        "--crypto-autotune",
        choices=["auto", "on", "off", "force"],
        default=_env_default("crypto-autotune", "") or "auto",
        help="startup kernel auto-tune (core/autotune.py): auto loads "
        "the persisted per-platform profile or micro-benches + "
        "persists one, on refuses hosts without the device stack, "
        "force always re-benches, off applies KernelConfig defaults + "
        "the deprecated CHARON_* env pins (no profile IO, no bench) "
        "(docs/operations.md 'Kernel auto-tuning and cold start')",
    )
    runp.add_argument(
        "--crypto-autotune-profile",
        default=_env_default("crypto-autotune-profile", ""),
        help="kernel-profile path; default places it next to the "
        "persistent jit cache for the detected platform (jaxcache.py)",
    )
    runp.add_argument(
        "--crypto-tenant",
        default=_env_default("crypto-tenant", ""),
        help="tenant id this node registers with the multi-tenant "
        "crypto-plane service (core/cryptosvc.py); default = the "
        "cluster name (docs/operations.md 'Multi-tenant deployment')",
    )
    runp.add_argument(
        "--crypto-tenant-weight",
        type=float,
        default=float(_env_default("crypto-tenant-weight", 1.0)),
        help="this tenant's relative share of the per-round lane "
        "budget (weighted-fair scheduling across tenants)",
    )
    runp.add_argument(
        "--crypto-tenant-queue-lanes",
        type=int,
        default=int(_env_default("crypto-tenant-queue-lanes", 4096)),
        help="per-tenant admission bound: pending lanes beyond this "
        "shed with PlaneOverloadError onto the submitter's host rung",
    )
    runp.add_argument(
        "--crypto-tenant-queue-jobs",
        type=int,
        default=int(_env_default("crypto-tenant-queue-jobs", 256)),
        help="per-tenant admission bound on pending submissions "
        "(the jobs twin of --crypto-tenant-queue-lanes)",
    )
    runp.add_argument(
        "--crypto-plane-round-lanes",
        type=int,
        default=int(_env_default("crypto-plane-round-lanes", 4096)),
        help="total lanes the service admits per scheduling round "
        "across all tenants (split weight-proportionally)",
    )
    runp.add_argument(
        "--crypto-breaker-threshold",
        type=float,
        default=float(_env_default("crypto-breaker-threshold", 0.5)),
        help="failed-verification lane ratio that opens the tenant's "
        "circuit breaker (forged-flood quarantine to its own flushes)",
    )
    runp.add_argument(
        "--crypto-breaker-cooldown",
        type=float,
        default=float(_env_default("crypto-breaker-cooldown", 5.0)),
        help="seconds an open breaker waits before half-opening (one "
        "clean quarantined flush then closes it)",
    )
    # networked crypto plane. The auth token deliberately
    # has NO flag: tokens on the command line leak via ps/shell
    # history, so the env var is the only channel.
    runp.add_argument(
        "--crypto-remote",
        default=_env_default("crypto-remote", ""),
        help="host:port of a remote crypto-plane service to dial "
        "(core/cryptosvc_client); token via CHARON_TPU_CRYPTO_TOKEN "
        "env var only. Remote failures degrade to the local ladder.",
    )
    runp.add_argument(
        "--crypto-serve",
        type=int,
        default=int(_env_default("crypto-serve", -1)),
        help="TCP port to serve this node's crypto-plane service on "
        "(core/cryptosvc_server); 0 = ephemeral, -1/unset = off. "
        "Tenant tokens via CHARON_TPU_CRYPTO_SERVE_TOKENS "
        "('tenant=token,tenant2=token2') env var only.",
    )
    runp.add_argument(
        "--crypto-serve-host",
        default=_env_default("crypto-serve-host", "127.0.0.1"),
        help="bind address for --crypto-serve",
    )
    runp.add_argument(
        "--relay",
        default=_env_default("relay", ""),
        help="host:port of a charon-tpu relay for NAT fallback dials",
    )
    runp.add_argument(
        "--tracing-endpoint",
        default=_env_default("tracing-endpoint", ""),
        help="OTLP/HTTP collector base URL for workflow spans "
        "(e.g. http://jaeger:4318; ref charon --jaeger-address)",
    )
    runp.add_argument(
        "--tracing-jsonl",
        default=_env_default("tracing-jsonl", ""),
        help="per-node span JSONL export path; per-node files merge "
        "offline into one cross-node duty timeline (duty trace ids "
        "are deterministic across the cluster)",
    )
    runp.add_argument(
        "--beacon-urls",
        default=_env_default("beacon-urls", ""),
        help="comma-separated beacon-node HTTP endpoints (failover order)",
    )
    # feature rollout control (ref: app/featureset Init bound via flags
    # at app start, app/app.go:136)
    runp.add_argument(
        "--feature-set",
        default=_env_default("feature-set", "stable"),
        help="minimum feature rollout status to enable: alpha|beta|stable",
    )
    runp.add_argument(
        "--feature-set-enable",
        default=_env_default("feature-set-enable", ""),
        help="comma-separated feature names to force-enable",
    )
    runp.add_argument(
        "--feature-set-disable",
        default=_env_default("feature-set-disable", ""),
        help="comma-separated feature names to force-disable",
    )
    # seeded fault injection: inert unless a spec is given —
    # the env var CHARON_TPU_FAULT_INJECTION is the non-CLI equivalent
    runp.add_argument(
        "--fault-injection",
        default=_env_default("fault-injection", ""),
        help="seeded fault-injection spec, e.g. 'seed=42,drop=0.1,"
        "bn_error=0.2' (keys: testutil.chaos.ChaosConfig); empty = off",
    )

    create = sub.add_parser(
        "create-cluster",
        help="generate a full cluster locally (keys, lock, node dirs)",
    )
    create.add_argument("--name", default="charon-tpu-cluster")
    create.add_argument("--nodes", type=int, default=4)
    create.add_argument("--threshold", type=int, default=3)
    create.add_argument("--validators", type=int, default=1)
    create.add_argument("--fork-version", default="0x00000000")
    create.add_argument("--output-dir", required=True)

    dkgp = sub.add_parser("dkg", help="run the distributed key generation ceremony")
    dkgp.add_argument("--definition-file", required=True)
    dkgp.add_argument("--data-dir", required=True)
    dkgp.add_argument(
        "--node-index",
        type=int,
        default=-1,
        help="operator index; default: derived from this node's key",
    )
    dkgp.add_argument(
        "--peers",
        required=True,
        help="comma-separated host:port per operator (index order)",
    )
    dkgp.add_argument("--timeout", type=float, default=120.0)
    dkgp.add_argument("--no-tpu", action="store_true")
    dkgp.add_argument(
        "--keymanager-address",
        default="",
        help="push share keystores to this VC keymanager API after the "
        "ceremony (ref: dkg.go:118-128)",
    )
    dkgp.add_argument(
        "--publish-address",
        default="",
        help="publish the cluster lock to this Obol-API endpoint "
        "(ref: dkg.go obolapi publish)",
    )

    cenr = sub.add_parser(
        "create-enr",
        help="generate this node's p2p identity key and print its record",
    )
    cenr.add_argument("--data-dir", default=".charon")

    cdkg = sub.add_parser(
        "create-dkg",
        help="generate an unsigned cluster-definition.json for a ceremony",
    )
    cdkg.add_argument("--name", default="charon-tpu-cluster")
    cdkg.add_argument("--num-validators", type=int, default=1)
    cdkg.add_argument(
        "--threshold",
        type=int,
        default=0,
        help="0 = BFT default n - floor((n-1)/3)",
    )
    cdkg.add_argument("--fork-version", default="0x00000000")
    cdkg.add_argument(
        "--operator-enrs", required=True, help="comma-separated operator records"
    )
    cdkg.add_argument("--output", default="cluster-definition.json")

    sdef = sub.add_parser(
        "sign-definition",
        help="add this operator's signatures to a cluster definition",
    )
    sdef.add_argument("--definition-file", required=True)
    sdef.add_argument("--data-dir", default=".charon")

    enrp = sub.add_parser("enr", help="print this node's identity record")
    enrp.add_argument("--data-dir", default=".charon")

    comb = sub.add_parser(
        "combine",
        help="reconstruct group validator keys from >=threshold node dirs",
    )
    comb.add_argument(
        "--cluster-dir",
        required=True,
        help="directory containing node*/ data dirs from the same cluster",
    )
    comb.add_argument("--output-dir", required=True)
    comb.add_argument(
        "--force", action="store_true", help="overwrite existing output"
    )

    resh = sub.add_parser(
        "reshare",
        help="reshare validator key shares to a new operator set or "
        "threshold (group key unchanged, old shares retired)",
    )
    resh.add_argument(
        "--cluster-dir",
        required=True,
        help="directory containing node*/ data dirs from the same cluster",
    )
    resh.add_argument(
        "--new-nodes",
        type=int,
        default=0,
        help="new operator count (join/leave); 0 = unchanged",
    )
    resh.add_argument(
        "--threshold",
        type=int,
        default=0,
        help="new threshold; 0 = BFT default n - floor((n-1)/3) for "
        "the new operator count",
    )
    resh.add_argument(
        "--no-tpu",
        action="store_true",
        help="host-only ceremony verification (skip the device engine)",
    )

    exitp = sub.add_parser("exit", help="voluntary-exit operations")
    exitsub = exitp.add_subparsers(dest="exit_command", required=True)
    esign = exitsub.add_parser(
        "sign", help="sign this node's partial voluntary exit"
    )
    esign.add_argument("--data-dir", required=True)
    esign.add_argument("--validator-index", type=int, required=True)
    esign.add_argument(
        "--validator-pubkey", default="", help="0x group pubkey (default: by index order in lock)"
    )
    esign.add_argument("--epoch", type=int, required=True)
    esign.add_argument("--output", default="", help="partial-exit json path")
    ebcast = exitsub.add_parser(
        "broadcast",
        help="aggregate >=threshold partial exits and emit the signed exit",
    )
    ebcast.add_argument("--data-dir", required=True)
    ebcast.add_argument(
        "--partials", nargs="+", required=True, help="partial-exit json files"
    )
    ebcast.add_argument("--output", default="", help="signed-exit json path")
    elist = exitsub.add_parser(
        "list",
        help="list the cluster's validators eligible for exit "
        "(ref: cmd/exit_list.go)",
    )
    elist.add_argument("--data-dir", required=True)
    elist.add_argument(
        "--beacon-url",
        default="",
        help="also resolve on-chain index + status from this beacon node",
    )
    efetch = exitsub.add_parser(
        "fetch",
        help="fetch aggregated signed exits from the publish API "
        "(ref: cmd/exit_fetch.go)",
    )
    efetch.add_argument("--data-dir", required=True)
    efetch.add_argument(
        "--publish-address", required=True, help="obol publish API base URL"
    )
    efetch.add_argument(
        "--fetched-exit-path",
        default="",
        help="directory to store fetched signed exits (default: data dir)",
    )
    ebcast.add_argument(
        "--beacon-url", default="", help="POST the exit to this beacon node"
    )

    flightp = sub.add_parser(
        "flight", help="flight-recorder post-mortem tools"
    )
    flightsub = flightp.add_subparsers(dest="flight_command", required=True)
    fmerge = flightsub.add_parser(
        "merge",
        help="merge per-node flight dumps into one incident timeline",
    )
    fmerge.add_argument(
        "dumps", nargs="+", help="per-node flight-recorder JSONL dumps"
    )
    fmerge.add_argument(
        "--format",
        choices=("text", "jsonl"),
        default="text",
        help="text timeline (default) or merged JSONL",
    )
    fmerge.add_argument(
        "--category", default="", help="only events of this category"
    )
    fmerge.add_argument(
        "--tenant", default="", help="only events for this tenant"
    )
    fmerge.add_argument(
        "--output", default="", help="write here instead of stdout"
    )

    relayp = sub.add_parser("relay", help="run a rendezvous relay server")
    relayp.add_argument("--port", type=int, default=3640)
    relayp.add_argument("--host", default="0.0.0.0")

    alpha = sub.add_parser("alpha", help="experimental commands")
    alphasub = alpha.add_subparsers(dest="alpha_command", required=True)
    addv = alphasub.add_parser(
        "add-validators",
        help="solo: add validators to an existing cluster via the "
        "manifest mutation chain",
    )
    addv.add_argument(
        "--cluster-dir",
        required=True,
        help="directory with ALL node*/ data dirs (solo operator)",
    )
    addv.add_argument("--count", type=int, default=1)

    testp = sub.add_parser("test", help="operator diagnostics")
    testsub = testp.add_subparsers(dest="test_command", required=True)
    tpeers = testsub.add_parser("peers", help="measure peer connectivity")
    tpeers.add_argument(
        "--peers", required=True, help="comma-separated host:port list"
    )
    tpeers.add_argument("--count", type=int, default=5)
    tbeacon = testsub.add_parser("beacon", help="measure beacon-node latency")
    tbeacon.add_argument("--beacon-url", required=True)
    tbeacon.add_argument("--count", type=int, default=5)
    tvc = testsub.add_parser(
        "validator", help="measure validator-API latency (ref: cmd/testvalidator.go)"
    )
    tvc.add_argument("--validator-api-url", required=True)
    tvc.add_argument("--count", type=int, default=5)
    tmev = testsub.add_parser(
        "mev", help="measure MEV-boost relay latency (ref: cmd/testmev.go)"
    )
    tmev.add_argument("--mev-url", required=True)
    tmev.add_argument("--count", type=int, default=5)
    tperf = testsub.add_parser(
        "performance",
        help="local disk/hash/BLS throughput diagnostics "
        "(ref: cmd/testperformance.go)",
    )
    tperf.add_argument("--duration", type=float, default=1.0)

    sub.add_parser("version", help="print version")
    return p


def cmd_create_cluster(args) -> int:
    """ref: cmd/createcluster.go — an in-memory ceremony producing every
    node's directory (lock + keystores + p2p key)."""
    from charon_tpu_torch.app import k1util
    from charon_tpu_torch.cluster.definition import ClusterDefinition, Operator
    from charon_tpu_torch.dkg import frost
    from charon_tpu_torch.dkg.ceremony import MemExchangeNet, run_dkg
    from charon_tpu_torch.eth2util import enr as enrlib

    n, t, v = args.nodes, args.threshold, args.validators
    out = Path(args.output_dir)
    keys = [k1util.generate_private_key() for _ in range(n)]
    ops = tuple(
        Operator(
            address=f"operator-{i}",
            enr=enrlib.new(keys[i]).to_string(),
        )
        for i in range(n)
    )
    defn = ClusterDefinition(
        name=args.name,
        num_validators=v,
        threshold=t,
        fork_version=args.fork_version,
        operators=ops,
    )
    for i in range(n):
        defn = defn.sign_operator(i, keys[i])

    async def ceremony():
        fnet = frost.MemFrostTransport(n)
        xnet = MemExchangeNet(n)
        return await asyncio.gather(
            *(
                run_dkg(
                    defn,
                    i,
                    keys[i],
                    fnet.participant(i + 1),
                    xnet.port(i),
                    data_dir=out / f"node{i}",
                )
                for i in range(n)
            )
        )

    results = run_coro(ceremony())
    for i in range(n):
        key_path = out / f"node{i}" / "charon-enr-private-key"
        key_path.touch(mode=0o600)
        key_path.write_bytes(k1util.private_key_to_bytes(keys[i]))
    (out / "cluster-definition.json").write_text(
        json.dumps(defn.to_json(), indent=2)
    )
    print(f"created {n}-node cluster (threshold {t}, {v} validators) in {out}")
    print(f"lock hash: 0x{results[0].lock.lock_hash().hex()}")
    return 0


def cmd_run(args) -> int:
    rc, config = run_config(args)
    if rc:
        return rc
    from charon_tpu_torch.app.run import run

    run_coro(run(config))
    return 0


def run_config(args):
    """(0, the node's app.run.Config) from `run`'s parsed flags, or
    (exit code, None) after a diagnostic on stderr."""
    # flag validation runs BEFORE the app.run import: bad flags must
    # fail fast with a clean diagnostic even on hosts where the node
    # stack's optional dependencies are absent
    if args.crypto_plane not in ("auto", "on", "off"):
        # env-var default bypassed argparse choices validation
        print(
            f"--crypto-plane {args.crypto_plane!r}: must be auto, on, or off",
            file=sys.stderr,
        )
        return 2, None
    if args.crypto_plane_prewarm not in ("auto", "on", "off"):
        print(
            f"--crypto-plane-prewarm {args.crypto_plane_prewarm!r}: "
            "must be auto, on, or off",
            file=sys.stderr,
        )
        return 2, None
    if args.crypto_plane_decode not in ("auto", "device", "python"):
        print(
            f"--crypto-plane-decode {args.crypto_plane_decode!r}: "
            "must be auto, device, or python",
            file=sys.stderr,
        )
        return 2, None
    if args.crypto_plane_warmup not in ("auto", "on", "off"):
        print(
            f"--crypto-plane-warmup {args.crypto_plane_warmup!r}: "
            "must be auto, on, or off",
            file=sys.stderr,
        )
        return 2, None
    if args.crypto_autotune not in ("auto", "on", "off", "force"):
        print(
            f"--crypto-autotune {args.crypto_autotune!r}: "
            "must be auto, on, off, or force",
            file=sys.stderr,
        )
        return 2, None

    rc = _init_featureset(args)
    if rc:
        return rc, None

    if args.fault_injection:
        # fail fast: a typo'd fault spec silently injecting nothing
        # would void the whole chaos run
        try:
            from charon_tpu_torch.app.faultinject import chaos_module

            chaos_module().config_from_spec(args.fault_injection)
        except ValueError as e:
            print(f"--fault-injection: {e}", file=sys.stderr)
            return 2, None

    # networked crypto plane: validate the address shape
    # here (fail fast) and pull secrets from env only — never argv
    crypto_remote_token = ""
    if args.crypto_remote:
        host, sep, port = args.crypto_remote.rpartition(":")
        if not sep or not port.isdigit():
            print(
                f"--crypto-remote {args.crypto_remote!r}: "
                "must be host:port",
                file=sys.stderr,
            )
            return 2, None
        crypto_remote_token = os.environ.get(
            "CHARON_TPU_CRYPTO_TOKEN", ""
        )
        if not crypto_remote_token:
            print(
                "--crypto-remote requires the CHARON_TPU_CRYPTO_TOKEN "
                "environment variable (tokens never go on argv)",
                file=sys.stderr,
            )
            return 2, None
    crypto_serve_tokens = {}
    if args.crypto_serve >= 0:
        raw = os.environ.get("CHARON_TPU_CRYPTO_SERVE_TOKENS", "")
        for part in raw.split(","):
            if not part.strip():
                continue
            tenant, sep, token = part.partition("=")
            if not sep or not tenant.strip() or not token:
                print(
                    "CHARON_TPU_CRYPTO_SERVE_TOKENS: entries must be "
                    "'tenant=token', comma-separated",
                    file=sys.stderr,
                )
                return 2, None
            crypto_serve_tokens[tenant.strip()] = token
        if not crypto_serve_tokens:
            print(
                "--crypto-serve requires CHARON_TPU_CRYPTO_SERVE_TOKENS "
                "('tenant=token,...'); refusing to serve with no "
                "authenticated tenants",
                file=sys.stderr,
            )
            return 2, None

    peer_addrs = []
    if args.peers:
        for part in args.peers.split(","):
            host, port = part.rsplit(":", 1)
            peer_addrs.append((host, int(port)))

    from charon_tpu_torch.app.run import Config

    config = Config(
        data_dir=args.data_dir,
        node_index=args.node_index,
        validator_api_port=args.validator_api_port,
        monitoring_port=args.monitoring_port,
        p2p_port=args.p2p_port,
        peer_addrs=peer_addrs,
        simnet=args.simnet,
        beacon_urls=[
            u.strip() for u in args.beacon_urls.split(",") if u.strip()
        ],
        slot_duration=args.slot_duration,
        slots_per_epoch=args.slots_per_epoch,
        genesis_time=args.genesis_time,
        use_tpu_tbls=not args.no_tpu,
        crypto_plane=args.crypto_plane,
        crypto_plane_window=args.crypto_plane_window,
        crypto_plane_decode_workers=args.crypto_plane_decode_workers,
        crypto_plane_prewarm=args.crypto_plane_prewarm,
        crypto_plane_decode=args.crypto_plane_decode,
        crypto_plane_warmup=args.crypto_plane_warmup,
        crypto_autotune=args.crypto_autotune,
        crypto_autotune_profile=args.crypto_autotune_profile,
        crypto_tenant=args.crypto_tenant,
        crypto_tenant_weight=args.crypto_tenant_weight,
        crypto_tenant_queue_lanes=args.crypto_tenant_queue_lanes,
        crypto_tenant_queue_jobs=args.crypto_tenant_queue_jobs,
        crypto_plane_round_lanes=args.crypto_plane_round_lanes,
        crypto_breaker_threshold=args.crypto_breaker_threshold,
        crypto_breaker_cooldown=args.crypto_breaker_cooldown,
        crypto_remote=args.crypto_remote,
        crypto_remote_token=crypto_remote_token,
        crypto_serve=args.crypto_serve if args.crypto_serve >= 0 else None,
        crypto_serve_host=args.crypto_serve_host,
        crypto_serve_tokens=crypto_serve_tokens,
        tracing_endpoint=args.tracing_endpoint,
        tracing_jsonl=args.tracing_jsonl,
        relay_addr=args.relay,
        fault_injection=args.fault_injection,
    )
    return 0, config


def _load_node_key(data_dir):
    from charon_tpu_torch.app import k1util

    key_path = Path(data_dir) / "charon-enr-private-key"
    return k1util.private_key_from_bytes(key_path.read_bytes())


def _operator_index_for_key(defn, key) -> int:
    """This key's 0-based operator index in the definition, or -1."""
    from charon_tpu_torch.app import k1util

    from charon_tpu_torch.eth2util import enr

    my_pub = k1util.public_key_to_bytes(key.public_key())
    for i, op in enumerate(defn.operators):
        try:
            if enr.pubkey_from_string(op.enr) == my_pub:
                return i
        except ValueError:
            continue
    return -1


def cmd_dkg(args) -> int:
    """Networked ceremony over localhost/TCP (ref: dkg/dkg.go:82 Run):
    mesh up -> sync protocol -> FROST -> signed lock + keystores written
    to --data-dir."""
    from charon_tpu_torch.app import k1util
    from charon_tpu_torch.cluster.definition import ClusterDefinition
    from charon_tpu_torch.dkg.netdkg import run_networked_dkg

    defn = ClusterDefinition.from_json(
        json.loads(Path(args.definition_file).read_text())
    )
    key = _load_node_key(args.data_dir)
    node_idx = args.node_index
    if node_idx < 0:
        node_idx = _operator_index_for_key(defn, key)
        if node_idx < 0:
            print("this node's key matches no definition operator", file=sys.stderr)
            return 1

    peer_addrs = []
    for part in args.peers.split(","):
        host, port = part.rsplit(":", 1)
        peer_addrs.append((host, int(port)))
    if len(peer_addrs) != len(defn.operators):
        print(
            f"--peers must list all {len(defn.operators)} operators",
            file=sys.stderr,
        )
        return 1

    engine = None
    if not args.no_tpu:
        # the card's engine, or an error: no host fallback
        from charon_tpu_torch.ops import blsops

        engine = blsops.BlsEngine()

    result = run_coro(
        run_networked_dkg(
            defn,
            node_idx,
            key,
            peer_addrs,
            data_dir=args.data_dir,
            engine=engine,
            timeout=args.timeout,
        )
    )
    print(f"dkg complete; lock hash: 0x{result.lock.lock_hash().hex()}")

    if args.keymanager_address:
        # push share keystores into the operator's VC
        # (ref: dkg.go:118-128 keymanager import; eth2util/keymanager)
        from charon_tpu_torch.eth2util.keymanager import KeymanagerClient

        keys_dir = Path(args.data_dir) / "validator_keys"
        keystores, passwords = [], []
        i = 0
        while (keys_dir / f"keystore-{i}.json").exists():
            keystores.append(
                json.loads((keys_dir / f"keystore-{i}.json").read_text())
            )
            passwords.append(
                (keys_dir / f"keystore-{i}.txt").read_text().strip()
            )
            i += 1
        client = KeymanagerClient(args.keymanager_address)
        run_coro(client.import_keystores(keystores, passwords))
        print(f"pushed {len(keystores)} keystores to keymanager")

    if args.publish_address:
        from charon_tpu_torch.app.obolapi import ObolApiClient

        run_coro(ObolApiClient(args.publish_address).publish_lock(result.lock))
        print("lock published")
    return 0


def cmd_create_enr(args) -> int:
    """ref: cmd/createenr.go — new key + printed EIP-778 record."""
    from charon_tpu_torch.app import k1util
    from charon_tpu_torch.eth2util import enr as enrlib

    data_dir = Path(args.data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    key_path = data_dir / "charon-enr-private-key"
    if key_path.exists():
        print(f"refusing to overwrite {key_path}", file=sys.stderr)
        return 1
    key = k1util.generate_private_key()
    key_path.touch(mode=0o600)
    key_path.write_bytes(k1util.private_key_to_bytes(key))
    print(enrlib.new(key).to_string())
    return 0


def cmd_create_dkg(args) -> int:
    """ref: cmd/createdkg.go — an unsigned definition the operators then
    sign (sign-definition) before running `dkg`."""
    from charon_tpu_torch.cluster.definition import ClusterDefinition, Operator

    enrs = [e.strip() for e in args.operator_enrs.split(",") if e.strip()]
    n = len(enrs)
    if n < 3:
        print("need at least 3 operators", file=sys.stderr)
        return 1
    threshold = args.threshold or n - (n - 1) // 3
    if not 1 < threshold <= n:
        print(f"threshold must be in (1, {n}], got {threshold}", file=sys.stderr)
        return 1
    defn = ClusterDefinition(
        name=args.name,
        num_validators=args.num_validators,
        threshold=threshold,
        fork_version=args.fork_version,
        operators=tuple(
            Operator(address=f"operator-{i}", enr=enr)
            for i, enr in enumerate(enrs)
        ),
    )
    Path(args.output).write_text(json.dumps(defn.to_json(), indent=2))
    print(f"wrote {args.output} ({n} operators, threshold {threshold})")
    return 0


def cmd_sign_definition(args) -> int:
    """Each operator signs the config hash + their record in turn
    (ref: the launchpad EIP-712 signing step, cluster/eip712sigs.go)."""
    from charon_tpu_torch.app import k1util
    from charon_tpu_torch.cluster.definition import ClusterDefinition

    path = Path(args.definition_file)
    defn = ClusterDefinition.from_json(json.loads(path.read_text()))
    key = _load_node_key(args.data_dir)
    idx = _operator_index_for_key(defn, key)
    if idx < 0:
        print("this node's key matches no definition operator", file=sys.stderr)
        return 1
    defn = defn.sign_operator(idx, key)
    path.write_text(json.dumps(defn.to_json(), indent=2))
    print(f"signed as operator {idx}")
    return 0


def cmd_enr(args) -> int:
    from charon_tpu_torch.eth2util import enr as enrlib

    key = _load_node_key(args.data_dir)
    print(enrlib.new(key).to_string())
    return 0


def cmd_combine(args) -> int:
    """Reconstruct the group private keys from >= threshold node dirs
    (ref: cmd/combine — Lagrange-recover at x=0 from share keystores)."""
    from charon_tpu_torch import tbls
    from charon_tpu_torch.cluster.manifest import load_cluster_state
    from charon_tpu_torch.eth2util import keystore

    cluster_dir = Path(args.cluster_dir)
    node_dirs = sorted(
        d
        for d in cluster_dir.iterdir()
        if d.is_dir() and (d / "cluster-lock.json").exists()
    )
    if not node_dirs:
        print(f"no node dirs with cluster-lock.json in {cluster_dir}", file=sys.stderr)
        return 1

    # manifest-materialised state: includes validators added after the
    # original ceremony (ref: app/app.go:166)
    lock = load_cluster_state(node_dirs[0])
    n = len(lock.definition.operators)
    t = lock.definition.threshold
    v = len(lock.validators)

    # map each node dir to its share index by matching pubshares
    shares_by_validator: list[dict[int, bytes]] = [dict() for _ in range(v)]
    for d in node_dirs:
        if load_cluster_state(d).lock_hash() != lock.lock_hash():
            print(f"{d} belongs to a different cluster", file=sys.stderr)
            return 1
        secrets = keystore.load_keys(d / "validator_keys")
        if len(secrets) != v:
            print(f"{d} has {len(secrets)} keystores, want {v}", file=sys.stderr)
            return 1
        impl = tbls.get_implementation()
        for vi, secret in enumerate(secrets):
            pub = impl.secret_to_public_key(secret)
            pubshares = [
                bytes.fromhex(s[2:])
                for s in lock.validators[vi].public_shares
            ]
            if pub not in pubshares:
                print(f"{d} keystore {vi} matches no pubshare", file=sys.stderr)
                return 1
            shares_by_validator[vi][pubshares.index(pub) + 1] = secret

    if any(len(s) < t for s in shares_by_validator):
        got = min(len(s) for s in shares_by_validator)
        print(f"need >= {t} share keystores per validator, got {got}", file=sys.stderr)
        return 1

    out = Path(args.output_dir)
    if out.exists() and any(out.iterdir()) and not args.force:
        print(f"{out} is not empty (use --force)", file=sys.stderr)
        return 1
    secrets, pubkeys = [], []
    for vi in range(v):
        secret = tbls.recover_secret(shares_by_validator[vi], n, t)
        want = lock.validators[vi].distributed_public_key
        have = "0x" + tbls.secret_to_public_key(secret).hex()
        if want != have:
            print(f"recovered key {vi} mismatches lock pubkey", file=sys.stderr)
            return 1
        secrets.append(secret)
        pubkeys.append(want)
    # `recover` EXISTS to write the combined keys back out as
    # encrypted EIP-2335 keystores  # lint: allow(secret-flow)
    keystore.store_keys(secrets, out, pubkeys=pubkeys)
    print(f"recovered {v} validator key(s) into {out}")
    return 0


def cmd_reshare(args) -> int:
    """Local resharing ceremony over a cluster directory (dkg/reshare):
    operator join/leave, threshold change, or proactive rotation — the
    group keys never change, every share does. Keystores swap in
    atomically per node dir (the pre-reshare set stays at
    validator_keys.pre-reshare until the operator retires it); the new
    pubshare map lands in reshare-pubshares.json for the lock/manifest
    update. See docs/operations.md "Key resharing at scale"."""
    from charon_tpu_torch import tbls
    from charon_tpu_torch.cluster.manifest import load_cluster_state
    from charon_tpu_torch.crypto.g1g2 import g1_from_bytes, g1_to_bytes
    from charon_tpu_torch.dkg import reshare
    from charon_tpu_torch.eth2util import keystore

    cluster_dir = Path(args.cluster_dir)
    node_dirs = sorted(
        d
        for d in cluster_dir.iterdir()
        if d.is_dir() and (d / "cluster-lock.json").exists()
    )
    if not node_dirs:
        print(f"no node dirs with cluster-lock.json in {cluster_dir}", file=sys.stderr)
        return 1
    lock = load_cluster_state(node_dirs[0])
    n = len(lock.definition.operators)
    t = lock.definition.threshold
    v = len(lock.validators)
    pubshare_rows = [
        [bytes.fromhex(s[2:]) for s in val.public_shares]
        for val in lock.validators
    ]

    # map each dir to its share index by matching keystore pubshares
    # (cmd_combine idiom) — dealers are exactly the old nodes present
    impl = tbls.get_implementation()
    dirs_by_idx: dict[int, Path] = {}
    secrets_by_idx: dict[int, list[int]] = {}
    for d in node_dirs:
        if load_cluster_state(d).lock_hash() != lock.lock_hash():
            print(f"{d} belongs to a different cluster", file=sys.stderr)
            return 1
        secrets = keystore.load_keys(d / "validator_keys")
        if len(secrets) != v:
            print(f"{d} has {len(secrets)} keystores, want {v}", file=sys.stderr)
            return 1
        pub = impl.secret_to_public_key(secrets[0])
        if pub not in pubshare_rows[0]:
            print(f"{d} keystore matches no pubshare", file=sys.stderr)
            return 1
        idx = pubshare_rows[0].index(pub) + 1
        dirs_by_idx[idx] = d
        secrets_by_idx[idx] = [int.from_bytes(s, "big") for s in secrets]

    old_indices = tuple(sorted(dirs_by_idx))
    if len(old_indices) < t:
        print(
            f"need >= threshold ({t}) node dirs to reshare, got "
            f"{len(old_indices)}",
            file=sys.stderr,
        )
        return 1
    n_new = args.new_nodes or n
    t_new = args.threshold or (n_new - (n_new - 1) // 3)
    new_indices = tuple(range(1, n_new + 1))
    try:
        cfg = reshare.ReshareConfig(
            old_indices=old_indices,
            new_indices=new_indices,
            t_old=t,
            t_new=t_new,
            num_validators=v,
        )
    except reshare.ReshareError as e:
        print(f"bad reshare parameters: {e}", file=sys.stderr)
        return 1

    old_pubshares = [
        {j: g1_from_bytes(row[j - 1]) for j in range(1, n + 1)}
        for row in pubshare_rows
    ]
    group_pubkeys = [
        g1_from_bytes(bytes.fromhex(val.distributed_public_key[2:]))
        for val in lock.validators
    ]
    engine = None
    if not args.no_tpu:
        # the card's engine, or an error: no host fallback
        from charon_tpu_torch.ops.blsops import BlsEngine

        engine = BlsEngine()

    participants = sorted(set(old_indices) | set(new_indices))
    transport = reshare.MemReshareTransport(dealer_indices=old_indices)

    async def ceremony():
        return await asyncio.gather(
            *(
                reshare.run_reshare_parallel(
                    transport.participant(i),
                    i,
                    cfg,
                    old_pubshares,
                    group_pubkeys,
                    share_secrets=secrets_by_idx.get(i),
                    engine=engine,
                )
                for i in participants
            )
        )

    try:
        results = dict(zip(participants, run_coro(ceremony())))
    except reshare.ReshareError as e:
        print(f"reshare aborted: {e}", file=sys.stderr)
        return 1

    pubshare_map: dict[int, list[str]] = {}
    for j in new_indices:
        res = results[j]
        target = dirs_by_idx.get(j, cluster_dir / f"node{j - 1}")
        hexes = [
            "0x" + g1_to_bytes(r.pubshares[j]).hex() for r in res
        ]
        pubshare_map[j] = hexes
        reshare.write_reshare_outputs(target, res, pubshare_hexes=hexes)
    (cluster_dir / "reshare-pubshares.json").write_text(
        json.dumps(
            {
                "threshold": t_new,
                "num_operators": n_new,
                "public_shares": {str(j): pubshare_map[j] for j in new_indices},
            },
            indent=2,
        )
    )
    left = sorted(set(old_indices) - set(new_indices))
    print(
        f"reshared {v} validator(s): {len(old_indices)} dealers -> "
        f"{n_new} operators (threshold {t} -> {t_new})"
    )
    if left:
        print(
            f"operators {left} left the cluster — retire their "
            "validator_keys.pre-reshare directories"
        )
    print(
        "new pubshares in reshare-pubshares.json; update the cluster "
        "lock/manifest before restarting nodes"
    )
    return 0


def cmd_exit(args) -> int:
    from charon_tpu_torch import tbls
    from charon_tpu_torch.cluster.manifest import load_cluster_state
    from charon_tpu_torch.core.eth2data import SignedData, VoluntaryExit
    from charon_tpu_torch.eth2util import keystore

    data_dir = Path(args.data_dir)
    lock = load_cluster_state(data_dir)
    fork = lock.fork_info()

    if args.exit_command == "sign":
        # ref: cmd/exit_sign.go — one partial exit signed with this
        # node's share key
        vi = args.validator_index
        if not 0 <= vi < len(lock.validators):
            print("validator index out of range", file=sys.stderr)
            return 1
        dv = lock.validators[vi]
        if args.validator_pubkey and args.validator_pubkey.lower() != dv.distributed_public_key.lower():
            print("pubkey does not match lock validator at that index", file=sys.stderr)
            return 1
        secrets = keystore.load_keys(data_dir / "validator_keys")
        secret = secrets[vi]
        impl = tbls.get_implementation()
        my_pubshare = impl.secret_to_public_key(secret)
        share_idx = [
            bytes.fromhex(s[2:]) for s in dv.public_shares
        ].index(my_pubshare) + 1

        exit_msg = VoluntaryExit(epoch=args.epoch, validator_index=vi)
        root = SignedData("exit", exit_msg).signing_root(fork, args.epoch)
        sig = tbls.sign(secret, root)
        out = {
            "validator_pubkey": dv.distributed_public_key,
            "validator_index": vi,
            "epoch": args.epoch,
            "share_idx": share_idx,
            "partial_signature": sig.hex(),
        }
        path = args.output or str(
            data_dir / f"exit-partial-{vi}-{share_idx}.json"
        )
        Path(path).write_text(json.dumps(out, indent=2))
        print(f"wrote partial exit {path}")
        return 0

    if args.exit_command == "list":
        # ref: cmd/exit_list.go — the cluster's validators with (when a
        # BN is reachable) their on-chain index and status
        rows = []
        chain: dict[str, dict] = {}
        if args.beacon_url:
            import aiohttp

            async def fetch_statuses():
                async with aiohttp.ClientSession() as s:
                    ids = ",".join(
                        dv.distributed_public_key for dv in lock.validators
                    )
                    async with s.get(
                        args.beacon_url.rstrip("/")
                        + "/eth/v1/beacon/states/head/validators",
                        params={"id": ids},
                    ) as resp:
                        if resp.status != 200:
                            raise RuntimeError(
                                f"beacon validators query: HTTP {resp.status}"
                            )
                        for v in (await resp.json())["data"]:
                            chain[v["validator"]["pubkey"].lower()] = v

            run_coro(fetch_statuses())
        for i, dv in enumerate(lock.validators):
            onchain = chain.get(dv.distributed_public_key.lower(), {})
            rows.append(
                {
                    "cluster_index": i,
                    "validator_pubkey": dv.distributed_public_key,
                    "validator_index": onchain.get("index"),
                    "status": onchain.get("status"),
                }
            )
        print(json.dumps(rows, indent=2))
        return 0

    if args.exit_command == "fetch":
        # ref: cmd/exit_fetch.go — pull the aggregated signed exit for
        # each cluster validator from the publish API once threshold
        # partial shares were uploaded
        from charon_tpu_torch.app.obolapi import ObolApiClient

        client = ObolApiClient(args.publish_address)
        out_dir = Path(args.fetched_exit_path or data_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        lock_hash = lock.lock_hash()

        async def fetch_all() -> int:
            fetched = 0
            for i, dv in enumerate(lock.validators):
                full = await client.fetch_full_exit(
                    lock_hash, dv.distributed_public_key
                )
                if full is None:
                    print(
                        f"validator {i}: exit not ready (needs threshold "
                        "partial shares)",
                    )
                    continue
                path = out_dir / f"exit-{dv.distributed_public_key}.json"
                path.write_text(json.dumps(full, indent=2))
                print(f"validator {i}: wrote {path}")
                fetched += 1
            return fetched

        run_coro(fetch_all())
        return 0

    # broadcast: aggregate >= t partials, verify, emit/submit
    # (ref: cmd/exit_broadcast.go)
    partials = [json.loads(Path(p).read_text()) for p in args.partials]
    vi = partials[0]["validator_index"]
    epoch = partials[0]["epoch"]
    if any(p["validator_index"] != vi or p["epoch"] != epoch for p in partials):
        print("partials disagree on validator/epoch", file=sys.stderr)
        return 1
    if not 0 <= vi < len(lock.validators):
        print(
            f"partials reference validator {vi}, cluster has "
            f"{len(lock.validators)}",
            file=sys.stderr,
        )
        return 1
    t = lock.definition.threshold
    # dedup by share index BEFORE the threshold count/slice so duplicate
    # files can't silently under-fill the quorum
    by_share = {
        p["share_idx"]: bytes.fromhex(p["partial_signature"])
        for p in partials
    }
    if len(by_share) < t:
        print(
            f"need >= {t} distinct share partials, got {len(by_share)}",
            file=sys.stderr,
        )
        return 1
    exit_msg = VoluntaryExit(epoch=epoch, validator_index=vi)
    root = SignedData("exit", exit_msg).signing_root(fork, epoch)
    subset = dict(sorted(by_share.items())[:t])
    sig = tbls.threshold_aggregate(subset)
    group_pk = bytes.fromhex(
        lock.validators[vi].distributed_public_key[2:]
    )
    try:
        tbls.verify(group_pk, root, sig)
    except Exception as e:
        print(f"aggregated exit signature invalid: {e}", file=sys.stderr)
        return 1
    signed = {
        "message": {"epoch": str(epoch), "validator_index": str(vi)},
        "signature": "0x" + sig.hex(),
    }
    path = args.output or str(data_dir / f"exit-{vi}.json")
    Path(path).write_text(json.dumps(signed, indent=2))
    print(f"wrote signed exit {path}")
    if args.beacon_url:
        import aiohttp

        async def submit():
            async with aiohttp.ClientSession() as s:
                async with s.post(
                    args.beacon_url.rstrip("/")
                    + "/eth/v1/beacon/pool/voluntary_exits",
                    json=signed,
                ) as resp:
                    if resp.status != 200:
                        raise RuntimeError(
                            f"beacon rejected exit: HTTP {resp.status}"
                        )

        run_coro(submit())
        print("broadcast to beacon node")
    return 0


def cmd_alpha(args) -> int:
    """alpha add-validators: a solo operator (holding every node dir)
    extends the cluster with new distributed validators via the manifest
    mutation chain (ref: cmd/addvalidators.go add-validators-solo +
    cluster/manifest mutations)."""
    from charon_tpu_torch.cluster.lock import DistributedValidator
    from charon_tpu_torch.cluster.manifest import Manifest, load_cluster_state
    from charon_tpu_torch.crypto.g1g2 import g1_to_bytes
    from charon_tpu_torch.dkg import frost
    from charon_tpu_torch.eth2util import keystore

    cluster_dir = Path(args.cluster_dir)
    node_dirs = sorted(
        d
        for d in cluster_dir.iterdir()
        if d.is_dir() and (d / "charon-enr-private-key").exists()
    )
    if not node_dirs:
        print(f"no node dirs in {cluster_dir}", file=sys.stderr)
        return 1
    lock = load_cluster_state(node_dirs[0])
    n = len(lock.definition.operators)
    t = lock.definition.threshold
    if len(node_dirs) != n:
        print(f"solo add-validators needs all {n} node dirs", file=sys.stderr)
        return 1
    # map each dir to its OPERATOR index via its key — directory sort
    # order is lexicographic (node10 < node2) and must not decide share
    # indices
    by_op: dict[int, object] = {}
    for d in node_dirs:
        key = _load_node_key(d)
        idx = _operator_index_for_key(lock.definition, key)
        if idx < 0:
            print(f"{d} key matches no operator", file=sys.stderr)
            return 1
        by_op[idx] = (d, key)
    if sorted(by_op) != list(range(n)):
        print("node dirs do not cover all operators", file=sys.stderr)
        return 1
    node_dirs = [by_op[i][0] for i in range(n)]
    keys = [by_op[i][1] for i in range(n)]

    # new FROST ceremony for the added validators only
    async def ceremony():
        net = frost.MemFrostTransport(n)
        return await asyncio.gather(
            *(
                frost.run_frost_parallel(
                    net.participant(i + 1),
                    i + 1,
                    n,
                    t,
                    args.count,
                    lock.lock_hash(),  # context binds to the cluster
                )
                for i in range(n)
            )
        )

    per_node_results = run_coro(ceremony())
    new_validators = [
        DistributedValidator(
            distributed_public_key="0x"
            + g1_to_bytes(r.group_pubkey).hex(),
            public_shares=tuple(
                "0x" + g1_to_bytes(r.pubshares[j]).hex()
                for j in range(1, n + 1)
            ),
        )
        for r in per_node_results[0]
    ]

    # manifest chain: genesis (if absent) -> add_validators -> approvals
    manifest_path = node_dirs[0] / "cluster-manifest.json"
    manifest = (
        Manifest.load(str(manifest_path))
        if manifest_path.exists()
        else Manifest.genesis(lock)
    )
    mutation = manifest.propose_add_validators(new_validators)
    manifest = manifest.append(mutation)
    for key in keys:  # every operator approves (solo holds all keys)
        manifest = manifest.append(manifest.approve(mutation.hash(), key))
    state = manifest.materialise()

    existing = len(lock.validators)
    for i, d in enumerate(node_dirs):
        manifest.save(str(d / "cluster-manifest.json"))
        share_secrets = [
            (r.secret_share % (1 << 256)).to_bytes(32, "big")
            for r in per_node_results[i]
        ]
        # add-validators writes the new shares as encrypted keystores
        # next to the existing set  # lint: allow(secret-flow)
        keystore.store_keys(
            share_secrets,
            d / "validator_keys",
            pubkeys=[dv.public_shares[i] for dv in new_validators],
            start_index=existing,
        )
    print(
        f"added {args.count} validator(s); cluster now has "
        f"{len(state.validators)} (manifest head 0x{manifest.head().hex()[:16]})"
    )
    return 0


def cmd_relay(args) -> int:
    """ref: cmd/relay — run the rendezvous/forwarding relay daemon."""
    from charon_tpu_torch.p2p.relay import RelayServer

    async def serve():
        server = RelayServer()
        port = await server.start(args.host, args.port)
        print(f"relay listening on {args.host}:{port}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        run_coro(serve())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_test(args) -> int:
    """ref: cmd/test.go — operator diagnostics with latency stats."""
    import statistics
    import time

    def stats_line(name, samples_ms, errs):
        if samples_ms:
            line = (
                f"{name}: min={min(samples_ms):.1f}ms "
                f"median={statistics.median(samples_ms):.1f}ms "
                f"max={max(samples_ms):.1f}ms ok={len(samples_ms)}"
            )
        else:
            line = f"{name}: unreachable"
        if errs:
            line += f" errors={errs}"
        print(line)
        return bool(samples_ms)

    if args.test_command == "peers":
        async def probe_peer(host, port):
            samples, errs = [], 0
            for _ in range(args.count):
                t0 = time.perf_counter()
                try:
                    _, w = await asyncio.wait_for(
                        asyncio.open_connection(host, port), timeout=3
                    )
                    samples.append((time.perf_counter() - t0) * 1000)
                    w.close()
                except Exception:
                    errs += 1
            return samples, errs

        async def run_all():
            ok = True
            for part in args.peers.split(","):
                host, port = part.rsplit(":", 1)
                samples, errs = await probe_peer(host, int(port))
                ok &= stats_line(f"peer {part}", samples, errs)
            return 0 if ok else 1

        return run_coro(run_all())

    if args.test_command == "performance":
        # local machine diagnostics (ref: cmd/testperformance.go measures
        # disk and networking envelopes): sequential disk write MB/s,
        # SHA-256 MB/s, and host-backend BLS verify sigs/sec — the three
        # resources a charon-tpu node leans on.
        import hashlib
        import os
        import tempfile

        chunk = os.urandom(4 << 20)
        t0, written = time.perf_counter(), 0
        with tempfile.NamedTemporaryFile(dir=".") as f:
            while time.perf_counter() - t0 < args.duration:
                f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
                written += len(chunk)
        disk = written / (time.perf_counter() - t0) / 1e6
        print(f"disk_write: {disk:.0f} MB/s")

        t0, hashed = time.perf_counter(), 0
        while time.perf_counter() - t0 < args.duration:
            hashlib.sha256(chunk).digest()
            hashed += len(chunk)
        print(f"sha256: {hashed / (time.perf_counter() - t0) / 1e6:.0f} MB/s")

        try:
            from charon_tpu_torch.tbls.native_impl import NativeImpl

            impl = NativeImpl()
            sk = (123).to_bytes(32, "big")
            pk = impl.secret_to_public_key(sk)
            sig = impl.sign(sk, b"perf-probe")
            t0, n = time.perf_counter(), 0
            while time.perf_counter() - t0 < args.duration:
                impl.verify(pk, b"perf-probe", sig)
                n += 1
            print(f"bls_verify_host: {n / (time.perf_counter() - t0):.0f} sigs/s")
        except Exception as e:  # native backend optional on exotic hosts
            print(f"bls_verify_host: unavailable ({e})")
        return 0

    # test beacon / validator / mev: HTTP latency probes against the
    # service's cheap status endpoint
    import aiohttp

    probes = {
        "beacon": ("beacon_url", "/eth/v1/node/version"),
        "validator": ("validator_api_url", "/eth/v1/node/version"),
        "mev": ("mev_url", "/eth/v1/builder/status"),
    }
    attr, path = probes[args.test_command]
    base = getattr(args, attr)

    async def probe_http():
        samples, errs = [], 0
        url = base.rstrip("/") + path
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=3)
        ) as s:
            for _ in range(args.count):
                t0 = time.perf_counter()
                try:
                    async with s.get(url) as resp:
                        await resp.read()
                        if resp.status == 200:
                            samples.append(
                                (time.perf_counter() - t0) * 1000
                            )
                        else:
                            errs += 1
                except Exception:
                    errs += 1
        return (
            0
            if stats_line(f"{args.test_command} {base}", samples, errs)
            else 1
        )

    return run_coro(probe_http())


def cmd_flight(args) -> int:
    """Post-mortem tooling over flight-recorder dumps (app/flightrec):
    merge per-node JSONL rings — dumped on SIGTERM/crash/stop or pulled
    from /debug/flight — into one wall-clock-ordered incident timeline,
    deduped by (node, seq)."""
    import json as _json

    from charon_tpu_torch.app import flightrec

    events = flightrec.merge_jsonl(args.dumps)
    if args.category:
        events = [e for e in events if e.get("category") == args.category]
    if args.tenant:
        events = [e for e in events if e.get("tenant") == args.tenant]
    if args.format == "jsonl":
        out = "".join(_json.dumps(e) + "\n" for e in events)
    else:
        out = flightrec.render_timeline(events)
    if args.output:
        Path(args.output).write_text(out, encoding="utf-8")
        print(f"wrote {len(events)} events -> {args.output}")
    else:
        sys.stdout.write(out)
    return 0


def _host_tbls() -> None:
    """The tbls backend of the commands but `run` (which installs its own
    in app/run.build_node): the host's, as the reference's registry
    defaults to its host backend where the port's defaults to TorchImpl on
    the card. NativeImpl, or PythonImpl where the native library does not
    load; a backend already installed stays."""
    from charon_tpu_torch import tbls

    if tbls._current is not None:
        return
    try:
        from charon_tpu_torch.tbls.native_impl import NativeImpl

        tbls.set_implementation(NativeImpl())
    except Exception:  # noqa: BLE001 — the native library is optional
        from charon_tpu_torch.tbls.python_impl import PythonImpl

        tbls.set_implementation(PythonImpl())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        from charon_tpu_torch import __version__

        print(f"charon-tpu {__version__}")
        return 0
    if args.command != "run":
        _host_tbls()
    return {
        "run": cmd_run,
        "create-cluster": cmd_create_cluster,
        "dkg": cmd_dkg,
        "create-enr": cmd_create_enr,
        "create-dkg": cmd_create_dkg,
        "sign-definition": cmd_sign_definition,
        "enr": cmd_enr,
        "combine": cmd_combine,
        "reshare": cmd_reshare,
        "exit": cmd_exit,
        "flight": cmd_flight,
        "relay": cmd_relay,
        "alpha": cmd_alpha,
        "test": cmd_test,
    }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
