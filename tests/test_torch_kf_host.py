"""K-f's device code (csrc/ht_dec.cu) compiled for the host and held to its
plain version on the CPU: coefficients and stop flags, exactly.

The kernel's source up to its host entry points is built by g++ against
the shim of tests/cuda_host_shim.py (a std::thread a CUDA thread, one
block after another, every global load checked against the launch's
buffers). The launch is the wrapper's (ht_cuda.DEC_WARPS warps a block,
GROUPS codeblocks a warp, where a case sets no fewer), into output rows filled with a sentinel (the kernel
writes every sample), with a guard row after them and a guard flag that
must stay untouched; the bytes past each segment are seeded garbage the
kernel must not read. What this cannot show: timing, occupancy, and
anything nvcc compiles differently from g++; the `cuda` tests of
tests/test_torch_cuda.py hold the card."""

import ctypes
import functools
import re

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from test_torch_ke_host import vlc_stress
from grok_tpu_torch import kernels
from grok_tpu_torch.t1 import ht
from grok_tpu_torch.t1 import ht_cuda as hc

HARNESS = r"""
#include "shim.h"
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) uint8_t s_dyn[1 << 16];
extern "C" int host_decode(const void* data, const void* lengths, const void* heights,
                           const void* widths, const void* tab, void* out, void* stopped,
                           int n, int L, int bh, int bw, int warps) {
    auto R = [](const void* p, size_t b) { return Range{(const char*)p, (const char*)p + b}; };
    g_ranges = {R(data, (size_t)n * L), R(lengths, 4 * n), R(heights, 4 * n),
                R(widths, 4 * n), R(tab, 4 * (T_MEL_EXP + 13))};
    if (block_bytes(bw, warps) > (int)sizeof(s_dyn)) return 1;
    blockDim = {(unsigned)(warps * 32), 1, 1};
    for (int b = 0; b < (n + GROUPS * warps - 1) / (GROUPS * warps); ++b) {
        Barrier blk;
        blk.n = warps * 32;
        g_block = &blk;
        std::vector<Barrier> wb(warps);
        std::vector<Exch> ex(warps);
        for (auto& w : wb) w.n = 32;
        std::vector<std::thread> th;
        for (int t = 0; t < warps * 32; ++t)
            th.emplace_back([&, t] {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                t_warp = &wb[t / 32];
                t_exch = &ex[t / 32];
                ht_dec_kernel((const uint8_t*)data, (const int32_t*)lengths,
                              (const int32_t*)heights, (const int32_t*)widths,
                              (const int32_t*)tab, (int32_t*)out, (uint8_t*)stopped, n, L, bh,
                              bw);
            });
        for (auto& x : th) x.join();
    }
    return 0;
}
"""

SENTINEL = 0x5A5A5A5A


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("kf_host"), (kernels.CSRC / "ht_dec.cu").read_text(),
                "static cudaError_t set_smem", HARNESS, "kf")
    lib.host_decode.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    return lib


def _host_decode(lib, data, lens, h, w, bh, bw, tab, warps=None):
    """(out [n, bh, bw] int32, stopped [n] bool) of a launch laid out as the
    wrapper lays it out."""
    n, L = data.shape
    out = torch.full((n + 1, bh, bw), SENTINEL, dtype=torch.int32)
    stopped = torch.full((n + 1,), 0xCC, dtype=torch.uint8)
    rc = lib.host_decode(data.data_ptr(), lens.data_ptr(), h.data_ptr(), w.data_ptr(),
                         tab.data_ptr(), out.data_ptr(), stopped.data_ptr(), n, L, bh, bw,
                         warps or hc.DEC_WARPS)
    assert rc == 0
    assert bool((out[n] == SENTINEL).all()) and int(stopped[n]) == 0xCC, "a write past the rows"
    assert bool((stopped[:n] <= 1).all())
    return out[:n], stopped[:n].bool()


# ------------------------------------------------------------------ inputs
def pack_segments(segs, seed=0):
    """data [n, L] uint8 (the bytes past each segment seeded garbage) and
    lengths [n] int32."""
    rng = np.random.default_rng(seed)
    L = max(max(map(len, segs), default=0), 2)
    data = rng.integers(0, 256, size=(len(segs), L), dtype=np.uint8)
    for i, s in enumerate(segs):
        data[i, :len(s)] = np.frombuffer(bytes(s), dtype=np.uint8)
    return torch.from_numpy(data), torch.tensor([len(s) for s in segs], dtype=torch.int32)


def encode_blocks(c, h, w):
    """The plain encoder's segments of coefficient blocks c [n, bh, bw]."""
    return [ht.encode_cleanup(c[i], int(h[i]), int(w[i]))
            if np.abs(c[i, :h[i], :w[i]]).max(initial=0) else b"" for i in range(len(c))]


def _blocks(seed, n, bh, bw, mag, density=0.6, ragged=False):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, mag + 1, size=(n, bh, bw)) * (rng.random((n, bh, bw)) < density)
    c = np.where(rng.random((n, bh, bw)) < 0.5, -c, c).astype(np.int64)
    h = rng.integers(1, bh + 1, size=n) if ragged else np.full(n, bh)
    w = rng.integers(1, bw + 1, size=n) if ragged else np.full(n, bw)
    for i in range(n):
        c[i, h[i]:] = 0
        c[i, :, w[i]:] = 0
    return c, h, w


def _full(n, v):
    return np.full(n, v)


def cut_segments(segs, seed):
    """Each segment cut at a seeded length (at least 2 bytes)."""
    rng = np.random.default_rng(seed)
    return [s[:int(rng.integers(2, len(s) + 1))] if len(s) > 2 else s for s in segs]


def flip_bytes(segs, seed, flips=3):
    """Each segment with ``flips`` seeded bytes XORed with seeded values."""
    rng = np.random.default_rng(seed)
    out = []
    for s in segs:
        b = bytearray(s)
        for _ in range(flips if len(b) else 0):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    return out


def invalid_rho15_tables():
    """DEC_TBL with every codeword that decodes to rho 15 made invalid (the
    reference's tables have no invalid codeword): (the tuple ht.decode_cleanup
    reads, the kernels' int32 table)."""
    dec = tuple(tuple(tuple(None if e is not None and e[0] == 15 else e for e in ctx)
                      for ctx in t) for t in ht.DEC_TBL)
    tab = hc.pack_ht_tables(ht.MEL_EXP, ht.ENC_TBL, dec, ht._U_PRE, ht._U_PRE_LEN,
                            ht._U_SUF, ht._U_SUF_LEN)
    return dec, tab


def one_full_quad(seed, bh, bw, qy, qx):
    """A bh x bw block whose only quad with four significant samples is
    (qy, qx): under invalid_rho15_tables the decode stops at its codeword."""
    rng = np.random.default_rng(seed)
    c = rng.integers(1, 40, size=(bh, bw)) * np.where(rng.random((bh, bw)) < 0.5, -1, 1)
    c[1::2, 1::2] = 0  # every quad's bottom-right sample
    c[2 * qy + 1, 2 * qx + 1] = 9
    return c.astype(np.int64)


def invalid_codeword_case():
    """Blocks whose decode stops at an invalid codeword at a pair's first
    quad (qx even) and at its second (qx odd), on line 0 and below it, in
    the first 32-quad chunk and the second: (c, h, w, the full quads)."""
    spots = [(8, 16, 1, 2), (8, 16, 1, 3), (4, 16, 0, 5), (6, 80, 2, 33), (6, 80, 1, 36)]
    bh, bw = 8, 80
    c = np.zeros((len(spots), bh, bw), dtype=np.int64)
    h, w = np.zeros(len(spots), int), np.zeros(len(spots), int)
    for i, (bh_i, bw_i, qy, qx) in enumerate(spots):
        c[i, :bh_i, :bw_i] = one_full_quad(70 + i, bh_i, bw_i, qy, qx)
        h[i], w[i] = bh_i, bw_i
    return c, h, w, [(qy, qx) for (_, _, qy, qx) in spots]


def wide_mid_quad():
    """A 2x2 block whose quad decodes its first sample (a 32-bit field) and
    stops at its second field (33 bits): the first sample stays, wrapped."""
    c = np.zeros((2, 2), dtype=np.int64)
    c[0, 0], c[0, 1], c[1, 1] = (1 << 31) + 7, 5, 5
    return c


@functools.lru_cache(maxsize=None)
def _cases():
    """name -> (segments, h, w, bh, bw, warps, tables): tables None for the
    reference's, else invalid_rho15_tables()."""
    def enc(c, h, w):
        return encode_blocks(c, h, w), h, w, c.shape[1], c.shape[2]

    c64 = _blocks(1, 3, 64, 64, 300)
    c64[0][1] = 0  # an all-zero codeblock has an empty segment
    top = (1 << 24) - 1
    big = np.random.default_rng(2).choice([top, -top, top - 1, -(top - 2)], size=(2, 16, 16))
    wide = np.zeros((3, 32, 32), dtype=np.int64)
    wide[0, :4, :4] = (1 << 29) + 12345
    wide[1, 2, 2] = -(1 << 30)
    wide[1, 5, 5] = (1 << 31) + 5  # alone in its quad: a 32-bit field
    wide[2, ::3, ::2] = (1 << 30) + 3
    ff = np.zeros((4, 6, 8), dtype=np.int64)
    for i, k in enumerate((3, 7, 8, 15)):  # every sample -2^k: runs of ones in MagSgn
        ff[i] = -(1 << k)
    ff[3, ::2, ::3] = -(1 << 16)
    sparse = np.zeros((2, 64, 64), dtype=np.int64)
    sparse[0, 5, 7], sparse[0, 40, 3], sparse[0, 63, 63] = 3, -200, 1
    sparse[1, ::9, ::11] = 5
    edge = _blocks(3, 6, 3, 5, 90, 0.9)
    edge[1][:], edge[2][:] = [1, 3, 1, 3, 2, 3], [1, 5, 5, 1, 3, 4]
    for i in range(6):
        edge[0][i, edge[1][i]:] = 0
        edge[0][i, :, edge[2][i]:] = 0
    small = _blocks(4, 8, 16, 16, 200, 0.7)
    rng = np.random.default_rng(5)
    garbage = [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes()
               for k in rng.integers(0, 300, size=10)]
    for b in (0x7F, 0xFF):  # Scup 21; the first VLC byte after the nibble above 0x8F stuffed
        garbage.append(garbage[-1][:37] + bytes([b, 0x95, 0x01]))
    mid = wide_mid_quad()
    bad_scup = encode_blocks(*_blocks(6, 3, 8, 8, 50, 1.0))
    bad_scup = [bad_scup[0][:-1] + b"\xff",  # Scup above Lcup
                bad_scup[1][:-2] + bytes([bad_scup[1][-2] & 0xF0 | 1, 0]),  # Scup 1
                bad_scup[2]]
    inv = invalid_codeword_case()
    n8 = lambda v: _full(3, v)  # noqa: E731
    return {
        "clean 64x64, an empty codeblock": (*enc(*c64), 2),
        "clean 4x1024: 16 chunks a row": (*enc(*_blocks(7, 2, 4, 1024, 60)), 1),
        "clean 1024x4: 512 rows": (*enc(*_blocks(8, 1, 1024, 4, 60)), 1),
        "clean ragged 16x16, the wrapper's blocks": (*enc(*_blocks(9, 20, 16, 16, 120, 0.7,
                                                                    ragged=True)), None),
        "clean 1x1 to 3x5 codeblocks": (*enc(*edge), 3),
        "25-bit MagSgn fields": (*enc(big, _full(2, 16), _full(2, 16)), 2),
        "31- and 32-bit MagSgn fields, wrapped": (*enc(wide, n8(32), n8(32)), 3),
        "MagSgn 0xFF": (*enc(ff, _full(4, 6), _full(4, 8)), 2),
        "VLC 0x8F/0x7F": (*enc(vlc_stress(1, 8, 64).numpy().astype(np.int64), _full(1, 8),
                                _full(1, 64)), 1),
        "MEL runs": (*enc(sparse, _full(2, 64), _full(2, 64)), 1),
        "cut at seeded lengths": (cut_segments(encode_blocks(*small), 10), small[1], small[2],
                                  16, 16, 4),
        "seeded bytes flipped": (flip_bytes(encode_blocks(*small), 11), small[1], small[2],
                                 16, 16, 4),
        "seeded random bytes": (garbage, np.random.default_rng(12).integers(1, 33, 12),
                                np.random.default_rng(13).integers(1, 33, 12), 32, 32, 4),
        "invalid codeword at a pair's first and second quad": (
            encode_blocks(*inv[:3]), inv[1], inv[2], 8, 80, 2),
        "a MagSgn field over 32 bits mid-quad": (encode_blocks(mid[None], [2], [2]), [2], [2],
                                                 2, 2, 1),
        "invalid Scup": (bad_scup, n8(8), n8(8), 8, 8, 1),
    }


def plain(segs, h, w, bh, bw, dec_tbl=None, monkeypatch=None):
    """ht_cleanup_dec_plain of the segments, under ``dec_tbl`` if given."""
    data, lens = pack_segments(segs)
    h32, w32 = (torch.tensor(np.asarray(a), dtype=torch.int32) for a in (h, w))
    if dec_tbl is not None:
        monkeypatch.setattr(ht, "DEC_TBL", dec_tbl)
    return hc.ht_cleanup_dec_plain(data, lens, h32, w32, bh, bw)


@pytest.mark.parametrize("case", list(_cases()))
def test_device_code_equals_plain(host_lib, monkeypatch, case):
    segs, h, w, bh, bw, warps = _cases()[case]
    invalid = case.startswith("invalid codeword")
    dec_tbl, tab = invalid_rho15_tables() if invalid else (None, hc.ht_tables(torch.device("cpu")))
    data, lens = pack_segments(segs)
    h32, w32 = (torch.tensor(np.asarray(a), dtype=torch.int32) for a in (h, w))
    got, got_stop = _host_decode(host_lib, data, lens, h32, w32, bh, bw, tab, warps)
    ref, ref_stop = plain(segs, h, w, bh, bw, dec_tbl, monkeypatch)
    assert torch.equal(got_stop, ref_stop)
    assert torch.equal(got, ref)
    if case.startswith("clean"):
        assert not bool(ref_stop.any())
    if case.startswith(("cut", "seeded", "invalid", "a MagSgn")) or case == "invalid Scup":
        assert bool(ref_stop.any())
    if invalid:  # every quad before the full one decoded, its pair not
        spots = invalid_codeword_case()[3]
        assert bool(ref_stop.all())
        for i, (qy, qx) in enumerate(spots):
            pair = ref[i, 2 * qy:2 * qy + 2, 4 * (qx // 2):4 * (qx // 2) + 4]
            assert not bool(pair.any()) and bool(ref[i, :2 * qy + 2, :4 * (qx // 2)].any())
    if case.startswith("a MagSgn"):
        assert int(ref[0, 0, 0]) == (1 << 31) + 7 - (1 << 32)
        assert int(ref[0].count_nonzero()) == 1
    if case.startswith("31-"):
        assert int(ref[1, 5, 5]) == -2147483643


def test_device_code_flags_codeblocks_larger_than_their_rows(host_lib):
    """A codeblock taller or wider than the output rows (which the plain
    version refuses) is flagged and left zero; its neighbours decode."""
    c, h, w = _blocks(14, 3, 8, 8, 50, 1.0)
    segs = encode_blocks(c, h, w)
    data, lens = pack_segments(segs)
    h32 = torch.tensor([8, 8, 9], dtype=torch.int32)
    w32 = torch.tensor([8, 10, 8], dtype=torch.int32)
    got, stop = _host_decode(host_lib, data, lens, h32, w32, 8, 8,
                             hc.ht_tables(torch.device("cpu")), 2)
    assert stop.tolist() == [False, True, True]
    assert torch.equal(got[0], torch.from_numpy(c[0].astype(np.int32)))
    assert not bool(got[1:].any())


# ----------------------------------------------- the wrapper's host logic
def test_constants_match_the_source():
    """The wrapper's limits and table layout are the kernel's."""
    src = (kernels.CSRC / "ht_dec.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert define["WARPS"] == hc.DEC_WARPS and 32 // define["G"] == hc.DEC_GROUPS
    assert define["T_DEC"] == 4096 and define["T_MEL_EXP"] == 6144
    assert define["HEAD_BYTES"] >= 8208 + 2 * 256
    assert 2 * define["NQW_MAX"] == 1024


def test_wrapper_refuses_wide_rows():
    """Rows wider than 1024 samples are refused before any launch."""
    data = torch.zeros((1, 4), dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="1024"):
        hc.ht_cleanup_dec(data, one, one, one, hc.ht_tables(torch.device("cpu")), 1, 1025)
