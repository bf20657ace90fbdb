"""Compose: multi-PROCESS cluster harness.

Mirrors ref: testutil/compose — the reference code-generates a
docker-compose.yml and smoke-tests whole clusters as separate containers
(compose/smoke/smoke_test.go). Here the same isolation comes from OS
processes: `generate()` creates the cluster on disk plus a compose.json
describing every node's command line; `ComposeCluster` launches each
node as `python -m charon_tpu_torch.cmd.cli run ...` with real TCP p2p between
them, waits for readiness via the monitoring endpoint, and polls
Prometheus metrics to assert duty completion.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def generate(
    out_dir: str | Path,
    n: int = 4,
    threshold: int = 3,
    validators: int = 1,
    slot_duration: float = 1.0,
    slots_per_epoch: int = 8,
) -> dict:
    """create-cluster + compose.json describing every node's run command
    (ref: compose/compose.go config generation)."""
    from charon_tpu_torch.cmd import cli

    out_dir = Path(out_dir)
    rc = cli.main(
        [
            "create-cluster",
            "--name",
            "compose",
            "--nodes",
            str(n),
            "--threshold",
            str(threshold),
            "--validators",
            str(validators),
            "--output-dir",
            str(out_dir),
        ]
    )
    if rc != 0:
        raise RuntimeError("create-cluster failed")

    p2p_ports = _free_ports(n)
    vapi_ports = _free_ports(n)
    mon_ports = _free_ports(n)
    peers = ",".join(f"127.0.0.1:{p}" for p in p2p_ports)
    genesis = time.time() + 2.0  # all nodes share one aligned genesis

    nodes = []
    for i in range(n):
        nodes.append(
            {
                "data_dir": str(out_dir / f"node{i}"),
                "node_index": i,
                "p2p_port": p2p_ports[i],
                "validator_api_port": vapi_ports[i],
                "monitoring_port": mon_ports[i],
                "argv": [
                    sys.executable,
                    "-m",
                    "charon_tpu_torch.cmd.cli",
                    "run",
                    "--data-dir",
                    str(out_dir / f"node{i}"),
                    "--node-index",
                    str(i),
                    "--simnet",
                    "--no-tpu",
                    "--peers",
                    peers,
                    "--p2p-port",
                    str(p2p_ports[i]),
                    "--validator-api-port",
                    str(vapi_ports[i]),
                    "--monitoring-port",
                    str(mon_ports[i]),
                    "--slot-duration",
                    str(slot_duration),
                    "--slots-per-epoch",
                    str(slots_per_epoch),
                    "--genesis-time",
                    str(genesis),
                ],
            }
        )
    config = {"nodes": nodes, "genesis_time": genesis}
    (out_dir / "compose.json").write_text(json.dumps(config, indent=2))
    return config


class ComposeCluster:
    """Launch + observe + tear down the generated cluster
    (ref: compose/smoke/smoke_test.go)."""

    def __init__(self, config: dict, env: dict | None = None):
        self.config = config
        self.procs: list[subprocess.Popen] = []
        self._killed: set[int] = set()
        self.env = dict(os.environ)
        self.env["JAX_PLATFORMS"] = "cpu"
        self.env["PYTHONPATH"] = (
            str(REPO) + os.pathsep + self.env.get("PYTHONPATH", "")
        )
        self.env.update(env or {})

    def start(self) -> None:
        for node in self.config["nodes"]:
            self.procs.append(self._spawn(node, mode="w"))

    def _spawn(self, node: dict, mode: str = "a") -> subprocess.Popen:
        # per-node log files, NOT pipes: an undrained pipe blocks a chatty
        # node once the OS buffer fills and stalls the whole cluster
        log_path = Path(node["data_dir"]) / "node.log"
        node["log_path"] = str(log_path)
        log_file = open(log_path, mode)
        proc = subprocess.Popen(
            node["argv"],
            env=self.env,
            cwd=str(REPO),
            stdout=log_file,
            stderr=subprocess.STDOUT,
            text=True,
        )
        log_file.close()  # child holds its own fd
        return proc

    def kill_node(self, i: int) -> None:
        """CRASH node i (SIGKILL — no graceful shutdown, mirroring the
        crash-only recovery story: durable state is only what's on disk).
        The node is excluded from liveness checks until restarted."""
        self.procs[i].kill()
        self.procs[i].wait()
        self._killed.add(i)

    def restart_node(self, i: int) -> None:
        """Relaunch a killed node with its original command line — it
        must recover purely from its on-disk state (keystores, lock) and
        the shared genesis-time clock."""
        assert self.procs[i].poll() is not None, f"node {i} still running"
        self.procs[i] = self._spawn(self.config["nodes"][i])
        self._killed.discard(i)

    def metrics(self, i: int) -> str:
        port = self.config["nodes"][i]["monitoring_port"]
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=3
        ) as resp:
            return resp.read().decode()

    def metric_value(self, i: int, name: str) -> float:
        total = 0.0
        found = False
        for line in self.metrics(i).splitlines():
            if line.startswith(name):
                total += float(line.rsplit(" ", 1)[1])
                found = True
        return total if found else 0.0

    def wait_metric(
        self,
        name: str,
        minimum: float,
        timeout: float = 60.0,
        nodes: list[int] | None = None,
    ) -> None:
        """Block until each listed node's `name` metric reaches
        `minimum` (all nodes when `nodes` is None)."""
        idxs = (
            [i for i in range(len(self.config["nodes"])) if i not in self._killed]
            if nodes is None
            else nodes
        )
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                if all(self.metric_value(i, name) >= minimum for i in idxs):
                    return
            except Exception:
                pass  # node still starting
            self._check_alive(idxs)
            time.sleep(0.5)
        raise TimeoutError(f"metric {name} never reached {minimum}")

    def node_log(self, i: int) -> str:
        try:
            return Path(self.config["nodes"][i]["log_path"]).read_text()
        except OSError:
            return ""

    def _check_alive(self, nodes: list[int] | None = None) -> None:
        idxs = (
            [i for i in range(len(self.procs)) if i not in self._killed]
            if nodes is None
            else nodes
        )
        for i in idxs:
            if self.procs[i].poll() is not None:
                raise RuntimeError(
                    f"node {i} exited rc={self.procs[i].returncode}:\n"
                    f"{self.node_log(i)[-4000:]}"
                )

    def stop(self) -> list[str]:
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        return [self.node_log(i) for i in range(len(self.procs))]
