"""PyTorch port: the launch geometry of the tiled kernels K2 and K5.

ops/mont_kernels.fp2_geometry turns a row count and the card's SM count
into the tiled launch (elements a tile, threads, grid, dynamic shared
bytes); the C entry points check it and the kernels walk it. Here, on the
CPU: every row is computed by exactly one block, once; a block stays
inside the card's limits on threads and shared memory; the resident blocks
fit one SM; and the constants the wrapper mirrors, and the C signatures it
declares, match the sources in charon_tpu_torch/csrc.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import pytest

from charon_tpu_torch.ops import mont_kernels as MK

CSRC = pathlib.Path(MK.__file__).resolve().parent.parent / "csrc"
TILED = ["fp2_mul", "fp2_mul_mxu"]
ROWS = [1, 2, 3, 31, 32, 33, 135, 3072, 4099, 6144, 8192, 12288, 16384, 24576,
        33857, 65533, 65536, 65537, 262147]
H100_SMS = 132
# What one block may take on the card, and what an SM holds (H100)
MAX_THREADS = 1024
MAX_SMEM = 232448  # 227 KB a block, as dynamic shared memory
SM_SHARED = 233472  # 228 KB an SM
BLOCK_RESERVED = 1024  # shared bytes the card reserves for each resident block
SM_REGISTERS = 65536


def _block_tiles(g, block):
    """The rows block `block` computes, tile by tile: the kernels' loop
    (fp2_tile.cuh fp2_mul_tiles) walks tiles block, block + grid, ..."""
    tiles = -(-g.rows // g.elems)
    return [range(t * g.elems, min(g.rows, (t + 1) * g.elems)) for t in range(block, tiles, g.grid)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kernel", TILED)
def test_geometry_covers_every_row_once(kernel, rows):
    g = MK.fp2_geometry(kernel, rows, H100_SMS)
    tiles = -(-rows // g.elems)
    seen = [r for b in range(g.grid) for tile in _block_tiles(g, b) for r in tile]
    assert sorted(seen) == list(range(rows))
    assert 1 <= g.grid <= tiles
    # a launch of more tiles than the card holds at once runs in persistent blocks
    assert g.grid == min(tiles, H100_SMS * MK._RESIDENT[kernel])
    # and every block takes its share of whole tiles, give or take one
    assert {len(_block_tiles(g, b)) for b in range(g.grid)} <= {tiles // g.grid, -(-tiles // g.grid)}


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("kernel", TILED)
def test_geometry_within_card_limits(kernel, sms):
    for rows in ROWS:
        g = MK.fp2_geometry(kernel, rows, sms)
        assert g.threads == 3 * g.elems and g.threads % 32 == 0
        assert g.threads <= MAX_THREADS
        assert g.smem <= MAX_SMEM
        assert g.grid <= min(2**31 - 1, sms * MK._RESIDENT[kernel])
    # the blocks counted as resident fit one SM's shared memory and registers
    assert MK._RESIDENT[kernel] * (g.smem + BLOCK_RESERVED) <= SM_SHARED
    assert SM_REGISTERS // (MK._RESIDENT[kernel] * g.threads) >= 64


def test_geometry_mirrors_the_sources():
    tile = (CSRC / "fp2_tile.cuh").read_text()
    assert re.search(r"kTileElems = (\d+);", tile).group(1) == str(MK.TILE_ELEMS)
    blocks = {
        "fp2_mul": re.search(r"kFp2MulBlocks = (\d+);", (CSRC / "fp2.cu").read_text()),
        "fp2_mul_mxu": re.search(r"kFp2MulMxuBlocks = (\d+);", (CSRC / "fp2_mxu.cu").read_text()),
    }
    assert {k: int(m.group(1)) for k, m in blocks.items()} == MK._RESIDENT
    # shared bytes: the tile's four staged operands (rows of 18 int64) and
    # five padded limb planes of 32-bit words, and for K5 the 16-byte piece
    # rows, one 32-column pass and the tables
    tile = 4 * MK.TILE_ELEMS * 18 * 8 + 5 * 16 * (MK.TILE_ELEMS + 1) * 4
    rows = 3 * MK.TILE_ELEMS
    assert MK._SMEM == {
        "fp2_mul": tile,
        "fp2_mul_mxu": tile + 2 * 2 * rows * 16 + 32 * (rows + 4) * 4 + 2 * 2 * (32 + 64) * 16,
    }
    assert MK._SMEM == {"fp2_mul": 28992, "fp2_mul_mxu": 54080}


_C_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


@pytest.mark.parametrize("source", sorted(MK._SOURCES))
def test_ctypes_signatures_match_c_entry_points(source):
    """The argtypes the loader declares are the C functions' parameters:
    a pointer for every pointer and the stream, int64 and int where the
    C code has them."""
    text = (CSRC / source).read_text()
    for fn, argtypes in MK._SOURCES[source].items():
        params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text).group(1)
        want = []
        for p in params.split(","):
            p = " ".join(p.split())
            want.append(ctypes.c_void_p if "*" in p else _C_TYPES[p.rsplit(" ", 1)[0].removeprefix("const ")])
        assert argtypes == want, fn


def test_tiled_wrapper_passes_geometry(monkeypatch):
    """The wrapper hands a tiled kernel fp2_geometry's numbers after the
    row count, and an untiled one none."""
    calls = []

    class FakeFn:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    class FakeLib:
        def __getattr__(self, name):
            return FakeFn(name)

    class FakeTensor:
        def __init__(self, rows):
            self.device = type("D", (), {"type": "cuda"})()
            self.dtype = MK.limb.DTYPE
            self.shape = (rows, 16)

        def numel(self):
            return self.shape[0] * 16

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 4096

    monkeypatch.setattr(MK, "library", lambda source: FakeLib())
    monkeypatch.setattr(MK, "sm_count", lambda device: 114)
    monkeypatch.setattr(MK.torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(MK.torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 7})())
    MK.reset_launches()
    for kernel, fn, n in (("fp2_mul", "charon_fp2_mul", 6), ("fp2_sqr", "charon_fp2_sqr", 4)):
        MK._launch("fp2.cu", fn, MK.limb.FP, kernel, [FakeTensor(24576)] * n)
    g = MK.fp2_geometry("fp2_mul", 24576, 114)
    (_, mul_args), (_, sqr_args) = calls
    assert mul_args[6:11] == (24576, g.elems, g.threads, g.grid, g.smem)
    assert sqr_args[4:6] == (24576, 16)
    assert MK.ROWS["fp2_mul"] == {24576: 1} and MK.ROWS["fp2_sqr"] == {24576: 1}
    MK.reset_launches()
    assert MK.ROWS["fp2_mul"] == {} and MK.LAUNCHES["fp2_mul"] == 0
