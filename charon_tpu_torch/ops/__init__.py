"""Batched BLS12-381 engine in PyTorch, bottom up:

  limb.py         Montgomery limb arithmetic (24-bit limbs in int64)
  limb_mxu.py     int8 piece tables of the constant convolutions (K4-K6)
  mont_kernels.py kernels K1-K6 (CUDA) with their plain versions and build
  fptower.py      Fp2/Fp6/Fp12 tower, muls and squares stacked per level
  curve.py        G1/G2 complete projective point ops
  msm.py          Pippenger and Straus multi-scalar multiplication
  pairing.py      Miller loop, final exponentiation, batched verify checks
  decompress.py   batched G1/G2 point decompression and subgroup checks
  sswu.py         batched hash-to-curve (SSWU, isogeny, cofactor clearing)
  blsops.py       BlsEngine: verify, threshold-aggregate, aggregate, decode;
                  the registry of program families
"""
