"""Carry device state between the JAX package and the port.

The JAX package packs field elements as numpy/JAX limb arrays in one of two
geometries, named by its ModCtx names:

  "fp", "fr"      24-bit limbs in uint64 (16 / 11 limbs) — the port's own
                  layout, so conversion is a dtype change;
  "fp32", "fr32"  12-bit limbs in uint32 (32 / 22 limbs) — the TPU layout;
                  two 12-bit limbs make one 24-bit limb.

Both use the Montgomery radix R = 2^384 (Fp) / 2^264 (Fr), so a reduced
Montgomery value is the same integer in either geometry and in the port.
Points are nested tuples of limb arrays (affine G1: (x, y); affine G2:
((x0, x1), (y0, y1)), as the JAX package's curve.g1_pack / g2_pack build
them); the point helpers convert every leaf.
"""

from __future__ import annotations

import numpy as np
import torch

# name -> (limb bits, limb count, numpy dtype) of the JAX package's contexts
GEOMETRIES = {
    "fp": (24, 16, np.uint64),
    "fr": (24, 11, np.uint64),
    "fp32": (12, 32, np.uint32),
    "fr32": (12, 22, np.uint32),
}


def _geometry(name: str):
    try:
        return GEOMETRIES[name]
    except KeyError:
        raise ValueError(f"unknown limb geometry {name!r}") from None


def limbs_from_jax(arr, src_ctx_name: str, device="cpu") -> torch.Tensor:
    """JAX-package limb array (..., n) in geometry `src_ctx_name` -> the
    port's int64 24-bit limb tensor on `device`."""
    bits, n, _ = _geometry(src_ctx_name)
    a = np.asarray(arr)
    if a.shape[-1] != n:
        raise ValueError(f"{src_ctx_name} arrays have {n} limbs, got {a.shape[-1]}")
    a = a.astype(np.int64)
    if bits == 12:
        a = a[..., 0::2] | (a[..., 1::2] << 12)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def limbs_to_jax(t: torch.Tensor, dst_ctx_name: str) -> np.ndarray:
    """The inverse of limbs_from_jax: a numpy array in the JAX package's
    `dst_ctx_name` geometry."""
    bits, n, dtype = _geometry(dst_ctx_name)
    a = t.detach().cpu().numpy().astype(np.int64)
    if bits == 12:
        out = np.empty((*a.shape[:-1], n), np.int64)
        out[..., 0::2] = a & 0xFFF
        out[..., 1::2] = a >> 12
        a = out
    if a.shape[-1] != n:
        raise ValueError(f"{dst_ctx_name} arrays have {n} limbs, got {a.shape[-1]}")
    return a.astype(dtype)


def point_from_jax(point, src_ctx_name: str, device="cpu"):
    """A packed point — affine G1 (x, y) or G2 ((x0, x1), (y0, y1)) as the
    JAX package's curve.g1_pack / g2_pack produce, or any nested tuple of
    limb arrays (Fp12 elements too) -> the same structure of port tensors."""
    if isinstance(point, (tuple, list)):
        return tuple(point_from_jax(x, src_ctx_name, device) for x in point)
    return limbs_from_jax(point, src_ctx_name, device)


def point_to_jax(point, dst_ctx_name: str):
    """The inverse of point_from_jax."""
    if isinstance(point, (tuple, list)):
        return tuple(point_to_jax(x, dst_ctx_name) for x in point)
    return limbs_to_jax(point, dst_ctx_name)
