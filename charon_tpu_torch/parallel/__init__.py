"""The slot crypto plane: the whole slot's verify and recombine work as a
few batched programs, with the validator axis split over devices.

  mesh.py  SlotCryptoPlane (the ten programs and their host API) and
           make_mesh (the plane's shards: a list of torch devices)
"""

from charon_tpu_torch.parallel.mesh import SlotCryptoPlane, make_mesh  # noqa: F401
