"""PyTorch port: the launch geometry of the tiled kernels K1-K6.

ops/mont_kernels.fp2_geometry (K2, K3, K5, K6) and mont_geometry (K1 and
K4, Fp and Fr) turn a row count and the card's SM count into the tiled launch
(elements a tile, threads, grid, dynamic shared bytes); the C entry points
check it and the kernels walk it. Here, on the CPU: every row is computed
by exactly one block, once; a block stays inside the card's limits on
threads and shared memory; the resident blocks fit one SM; and the
constants the wrapper mirrors, and the C signatures it declares, match the
sources in charon_tpu_torch/csrc.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import pytest
import torch

from charon_tpu_torch.ops import mont_kernels as MK

CSRC = pathlib.Path(MK.__file__).resolve().parent.parent / "csrc"
TILED = ["fp2_mul", "fp2_sqr", "fp2_mul_mxu", "fp2_sqr_mxu"]
MONT = ["mont_mul_fp", "mont_mul_fr", "mont_mul_mxu_fp", "mont_mul_mxu_fr"]
# the Fp2 kernels' duty row counts (K2/K5: 48, 384, 6144, 24576; K3/K6: 9,
# 18, 2048, 8192), tile edges, and their waves on 132 SMs (K2/K5: 16,896
# rows, K6: 25,344, K3: 33,792) plus two tiles and one
ROWS = [1, 2, 3, 9, 18, 31, 32, 33, 48, 135, 384, 2048, 3072, 4099, 6144, 8192, 12288, 16384,
        16961, 24576, 25409, 33791, 33792, 33793, 33857, 65533, 65536, 65537, 262147]
# K1's and K4's own edges, their duty's row counts (1, 8, 384, 1024, 4096),
# and their waves on 132 SMs (K4: 50,688 rows, K1: 67,584) plus two tiles
# and one
MONT_ROWS = [1, 2, 8, 9, 18, 31, 32, 33, 63, 64, 65, 127, 128, 129, 384, 1024, 2048, 4096,
             8192, 50945, 65536, 67583, 67584, 67585, 67649, 262147]
H100_SMS = 132
# What one block may take on the card, and what an SM holds (H100)
MAX_THREADS = 1024
MAX_SMEM = 232448  # 227 KB a block, as dynamic shared memory
SM_SHARED = 233472  # 228 KB an SM
BLOCK_RESERVED = 1024  # shared bytes the card reserves for each resident block
SM_REGISTERS = 65536


def _block_tiles(g, block):
    """The rows block `block` computes, tile by tile: the kernels' loop
    (tile.cuh tile_loop) walks tiles block, block + grid, ..."""
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


@pytest.mark.parametrize("rows", MONT_ROWS)
@pytest.mark.parametrize("kernel", MONT)
def test_mont_geometry_covers_every_row_once(kernel, rows):
    """K1 and K4: one one-warp block up to a warp's rows, else tiles of the
    kernel's size (K1: a warp's rows, K4: 128) in at most the card's
    resident blocks."""
    g = MK.mont_geometry(kernel, rows, H100_SMS)
    tiles = -(-rows // g.elems)
    seen = [r for b in range(g.grid) for tile in _block_tiles(g, b) for r in tile]
    assert sorted(seen) == list(range(rows))
    assert g.elems == g.threads == (32 if rows <= 32 else MK.MONT_TILE_ROWS[kernel])
    # K1 takes a launch of at most a warp's rows straight into registers:
    # no shared memory; everything else stages its tiles
    unstaged = rows <= 32 and kernel in ("mont_mul_fp", "mont_mul_fr")
    assert g.smem == (0 if unstaged else MK._SMEM[kernel, g.elems])
    assert g.grid == min(tiles, H100_SMS * MK._RESIDENT[kernel])
    assert {len(_block_tiles(g, b)) for b in range(g.grid)} <= {tiles // g.grid, -(-tiles // g.grid)}
    assert MK.geometry(kernel, rows, H100_SMS) == g


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("kernel", MONT)
def test_mont_geometry_within_card_limits(kernel, sms):
    for rows in MONT_ROWS:
        g = MK.mont_geometry(kernel, rows, sms)
        assert g.threads % 32 == 0 and g.threads <= MAX_THREADS
        assert g.smem <= MAX_SMEM
        assert 1 <= g.grid <= min(2**31 - 1, sms * MK._RESIDENT[kernel])
        if rows > MK.WARP_ROWS:
            # the blocks counted as resident fit one SM's shared memory and registers
            assert MK._RESIDENT[kernel] * (g.smem + BLOCK_RESERVED) <= SM_SHARED
            assert SM_REGISTERS // (MK._RESIDENT[kernel] * g.threads) >= 128
        else:
            assert g.grid == 1


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("kernel", TILED)
def test_geometry_within_card_limits(kernel, sms):
    for rows in ROWS:
        g = MK.fp2_geometry(kernel, rows, sms)
        assert g.threads == MK._ROLES[kernel] * g.elems and g.threads % 32 == 0
        assert g.threads <= MAX_THREADS
        assert g.smem <= MAX_SMEM
        assert g.grid <= min(2**31 - 1, sms * MK._RESIDENT[kernel])
    # the blocks counted as resident fit one SM's shared memory and registers
    assert MK._RESIDENT[kernel] * (g.smem + BLOCK_RESERVED) <= SM_SHARED
    assert SM_REGISTERS // (MK._RESIDENT[kernel] * g.threads) >= 64


def test_geometry_mirrors_the_sources():
    tile = (CSRC / "tile.cuh").read_text()
    k1 = (CSRC / "mont_mul.cu").read_text()
    k23 = (CSRC / "fp2.cu").read_text()
    k4 = (CSRC / "mont_mxu.cu").read_text()
    k56 = (CSRC / "fp2_mxu.cu").read_text()
    assert re.search(r"kTileElems = (\d+);", tile).group(1) == str(MK.TILE_ELEMS)
    assert re.search(r"kWarpRows = (\d+);", tile).group(1) == str(MK.WARP_ROWS)
    k1_tile = int(re.search(r"kMontTileRows = (\d+);", k1).group(1))
    k4_tile = int(re.search(r"kMontMxuThreads = (\d+);", k4).group(1))
    assert MK.MONT_TILE_ROWS == {"mont_mul_fp": k1_tile, "mont_mul_fr": k1_tile,
                                 "mont_mul_mxu_fp": k4_tile, "mont_mul_mxu_fr": k4_tile}
    blocks = {
        "mont_mul_fp": re.search(r"kMontBlocks = (\d+);", k1),
        "mont_mul_fr": re.search(r"kMontBlocks = (\d+);", k1),
        "fp2_mul": re.search(r"kFp2MulBlocks = (\d+);", k23),
        "fp2_sqr": re.search(r"kFp2SqrBlocks = (\d+);", k23),
        "mont_mul_mxu_fp": re.search(r"kMontMxuBlocks = (\d+);", k4),
        "mont_mul_mxu_fr": re.search(r"kMontMxuBlocks = (\d+);", k4),
        "fp2_mul_mxu": re.search(r"kFp2MulMxuBlocks = (\d+);", k56),
        "fp2_sqr_mxu": re.search(r"kFp2SqrMxuBlocks = (\d+);", k56),
    }
    assert {k: int(m.group(1)) for k, m in blocks.items()} == MK._RESIDENT
    # the launch bounds name those constants
    assert "__launch_bounds__(Elems, kMontBlocks)" in k1
    assert re.search(r"if \(rows <= kWarpRows\) \{\n\s+if \(smem != 0\)", k1)
    assert "__launch_bounds__(kFp2SqrThreads, kFp2SqrBlocks)" in k23
    # roles: threads a tile over its elements
    assert re.search(r"kFp2MulThreads = (\d+) \* kTileElems;", tile).group(1) == str(MK._ROLES["fp2_mul"])
    assert re.search(r"kFp2SqrThreads = (\d+) \* kTileElems;", tile).group(1) == str(MK._ROLES["fp2_sqr"])
    assert MK._ROLES["fp2_mul_mxu"] == MK._ROLES["fp2_mul"] and MK._ROLES["fp2_sqr_mxu"] == MK._ROLES["fp2_sqr"]
    # shared bytes: the staged operands (rows of 18 int64 for Fp, 11 for
    # Fr), the product and output limb planes of 32-bit words, and for the
    # int8 kernels, 32-byte aligned, the 16-byte piece rows, one 32-column
    # pass at a stride of rows + 4 and the 6,144-byte tables
    e = MK.TILE_ELEMS

    def conv(rows):
        return 2 * 2 * rows * 16 + 32 * (rows + 4) * 4 + 6144

    fp2_mul = 4 * e * 18 * 8 + 5 * 16 * (e + 1) * 4
    assert MK._SMEM == {
        ("mont_mul_fp", 32): 2 * 32 * 18 * 8 + 16 * 33 * 4,
        ("mont_mul_fr", 32): 7088,  # 2 x 32 x 11 x 8 + 11 x 33 x 4 = 7084, aligned
        ("fp2_mul", e): fp2_mul,
        ("fp2_sqr", e): 2 * e * 18 * 8 + 2 * 16 * (e + 1) * 4,
        ("fp2_mul_mxu", e): fp2_mul + conv(3 * e),
        ("fp2_sqr_mxu", e): 2 * e * 18 * 8 + 2 * 16 * (e + 1) * 4 + conv(2 * e),
        ("mont_mul_mxu_fp", 32): 2 * 32 * 18 * 8 + 16 * 33 * 4 + conv(32),
        ("mont_mul_mxu_fp", 128): 2 * 128 * 18 * 8 + 16 * 129 * 4 + conv(128),
        ("mont_mul_mxu_fr", 32): 7104 + conv(32),  # 2 x 32 x 11 x 8 + 11 x 33 x 4 = 7084, aligned
        ("mont_mul_mxu_fr", 128): 28224 + conv(128),  # 22,528 + 5,676 = 28,204, aligned
    }
    assert list(MK._SMEM.values()) == [11328, 7088, 28992, 13440, 54080, 32384, 24128, 76352, 19904, 59456]


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


class _FakeTensor:
    """What _launch reads of a CUDA tensor of `rows` rows of n limbs."""

    def __init__(self, rows, n=16):
        self.device = type("D", (), {"type": "cuda"})()
        self.dtype = MK.limb.DTYPE
        self.shape = (rows, n)

    def numel(self):
        return self.shape[0] * self.shape[1]

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


@pytest.fixture
def fake_card(monkeypatch):
    """_launch against a card of 114 SMs whose libraries record each call
    (function name, arguments) instead of launching."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(MK, "library", lambda source: FakeLib())
    monkeypatch.setattr(MK, "sm_count", lambda device: 114)
    monkeypatch.setattr(MK.torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(MK.torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(MK.limb_mxu, "device_tables", lambda ctx, device: type("T", (), {"data_ptr": lambda self: 8192})())
    MK.reset_launches()
    yield calls
    MK.reset_launches()


@pytest.mark.parametrize("rows", [1, 8, 9, 32, 33, 384, 1024, 2048, 24576, 65536])
def test_tiled_wrapper_passes_geometry(fake_card, rows):
    """K1 (Fp and Fr) gets mont_geometry's numbers after the row count, K2
    and K3 fp2_geometry's; each launch is counted under its kernel and row
    count, and reset_launches clears the counts."""
    calls = fake_card
    launches = (("mont_mul.cu", "charon_mont_mul", MK.limb.FP, "mont_mul_fp", 3, 16),
                ("mont_mul.cu", "charon_mont_mul", MK.limb.FR, "mont_mul_fr", 3, 11),
                ("fp2.cu", "charon_fp2_mul", MK.limb.FP, "fp2_mul", 6, 16),
                ("fp2.cu", "charon_fp2_sqr", MK.limb.FP, "fp2_sqr", 4, 16))
    for source, fn, ctx, kernel, n_ptr, n in launches:
        MK._launch(source, fn, ctx, kernel, [_FakeTensor(rows, n)] * n_ptr)
    for (source, fn, _, kernel, n_ptr, n), (called, args) in zip(launches, calls):
        g = MK.geometry(kernel, rows, 114)
        assert called == fn
        assert args[n_ptr:n_ptr + 6] == (rows, g.elems, g.threads, g.grid, g.smem, n)
        assert len(args) == len(MK._SOURCES[source][fn])
        assert MK.ROWS[kernel] == {rows: 1} and MK.LAUNCHES[kernel] == 1
    MK.reset_launches()
    assert MK.ROWS["fp2_mul"] == {} and MK.LAUNCHES["fp2_mul"] == 0


@pytest.mark.parametrize("rows", [1, 8, 32, 33, 384, 1024, 4096, 65536])
def test_int8_wrapper_passes_geometry(fake_card, rows):
    """K4 (Fp and Fr) gets the tables and mont_geometry's numbers after the
    row count, K6 the tables and fp2_geometry's; each launch is counted
    under its kernel and row count."""
    calls = fake_card
    MK._launch("mont_mxu.cu", "charon_mont_mul_mxu", MK.limb.FP, "mont_mul_mxu_fp", [_FakeTensor(rows)] * 3, tables=True)
    MK._launch("mont_mxu.cu", "charon_mont_mul_mxu", MK.limb.FR, "mont_mul_mxu_fr", [_FakeTensor(rows, 11)] * 3, tables=True)
    MK._launch("fp2_mxu.cu", "charon_fp2_sqr_mxu", MK.limb.FP, "fp2_sqr_mxu", [_FakeTensor(rows)] * 4, tables=True)
    (fp_fn, fp_args), (fr_fn, fr_args), (sqr_fn, sqr_args) = calls
    assert fp_fn == fr_fn == "charon_mont_mul_mxu" and sqr_fn == "charon_fp2_sqr_mxu"
    for args, kernel, n_ptr, n in ((fp_args, "mont_mul_mxu_fp", 3, 16), (fr_args, "mont_mul_mxu_fr", 3, 11),
                                   (sqr_args, "fp2_sqr_mxu", 4, 16)):
        g = MK.geometry(kernel, rows, 114)
        assert args[n_ptr] == 8192  # the tables
        assert args[n_ptr + 1:n_ptr + 7] == (rows, g.elems, g.threads, g.grid, g.smem, n)
        assert len(args) == len(MK._SOURCES["fp2_mxu.cu" if kernel == "fp2_sqr_mxu" else "mont_mxu.cu"][
            "charon_fp2_sqr_mxu" if kernel == "fp2_sqr_mxu" else "charon_mont_mul_mxu"])
        assert MK.ROWS[kernel] == {rows: 1} and MK.LAUNCHES[kernel] == 1
    # every kernel is tiled: K1 and K3 take the geometry of K4 and K6's shape
    assert MK.geometry("mont_mul_fp", rows, 114) == MK.mont_geometry("mont_mul_fp", rows, 114)
    assert MK.geometry("fp2_sqr", rows, 114) == MK.fp2_geometry("fp2_sqr", rows, 114)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [16, 11])
def test_aligned_copies_only_views_off_16_byte_words(n, offset):
    """The tiles move in 16-byte words: _aligned hands a view that starts on
    one through as it is, copies one that starts between them (an Fr view
    at an odd row), and counts each copy under its kernel."""
    MK.reset_launches()
    base = torch.arange(9 * n, dtype=torch.int64).view(9, n)
    view = base[offset:offset + 4]
    (got,) = MK._aligned("mont_mul_fr", [view])
    assert torch.equal(got, view) and got.data_ptr() % 16 == 0
    copied = view.data_ptr() % 16 != 0
    assert copied == (n % 2 == 1 and offset == 1)
    assert (got.data_ptr() != view.data_ptr()) == copied
    assert MK.ALIGN_COPIES["mont_mul_fr"] == int(copied)
    MK.reset_launches()
    assert MK.ALIGN_COPIES["mont_mul_fr"] == 0
