"""charon-tpu's crypto plane in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

A port of the JAX package `charon_tpu`, which stays the reference; this
package imports neither jax nor `charon_tpu`. Layout mirrors the
reference: `crypto/` (host copies of the pure-Python BLS12-381 modules),
`ops/` (the batched engine, kernels K1-K6 in `ops/mont_kernels.py`),
`csrc/` (their CUDA sources), `core/` (kernel routing and the startup
tuner), `tbls/` (the `TorchImpl` backend), and `convert.py` (limb arrays
between the two packages' layouts). Entry points
run on the CUDA card unless the caller passes device="cpu".
"""
