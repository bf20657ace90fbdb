"""charon-tpu's crypto plane in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

A port of the JAX package `charon_tpu`, which stays the reference; this
package imports neither jax nor `charon_tpu`. Layout mirrors the
reference: `crypto/` (host copies of the pure-Python BLS12-381 modules),
`ops/` (the batched engine, kernels K1-K6 in `ops/mont_kernels.py`),
`csrc/` (their CUDA sources), `parallel/` (the slot crypto plane),
`core/` (kernel routing, the startup tuner, the plane's coalescer and
its multi-tenant service, and the node's duty workflow), `tbls/` (the
backend registry and the `TorchImpl` backend), `dkg/` (the FROST and
resharing ceremonies), `eth2util/` and `app/` (host copies the workflow
needs: SSZ and signing roots, logging, retries, tracing), `testutil/`
(beacon and validator mocks, the in-process cluster, the multi-process
compose harness), `cmd/` (the `charon` CLI: `python -m
charon_tpu_torch.cmd.cli`), and `convert.py` (limb arrays between the two
packages' layouts). Entry points run on the CUDA card unless the caller
passes device="cpu".
"""

__version__ = "0.1.0"
