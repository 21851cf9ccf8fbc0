#!/usr/bin/env python3
"""Drive grok_tpu_torch's lossless paths on one CUDA card: the Part-1
encode and decode, and the HTJ2K encode and decode.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero before the last
line):
  1. device   card name and power limit (nvidia-smi)
  2. build    nvcc of every kernel source, in parallel, with build seconds
  3. kernels  every kernel of the paths and the TPU kernel it replaces
  4. check    each kernel against its plain version on inputs from the
              3840x2160x3 image: K-a, K-b, K-g and K-h on the whole image
              (plain versions on the card), K-c, K-d, K-e, K-f and K-i on a
              seeded sample of codeblocks from every band type (plain
              versions on the CPU; K-e, K-f and K-i timed on the whole
              batch; K-i's sample once whole and once cut after a seeded
              pass, and the whole batch decoded back to K-c's input); all
              integer, compared exactly
  5. slice    256x256x3 compress on the card, byte-identical to the plain
              path (device="cpu") and to grok_tpu's stream (REF_SHA256);
     slice_p1dec  the Part-1 stream decoded on the card, equal to the plain
              path's decode and to the input
     slice_ht the same with ht=True, and the card's decode of it equal to
              the plain path's and to the input
  6. e2e      3840x2160x3 lossless53 (CompressParams(num_resolutions=6))
              compressed three times like three requests: per-stage ms,
              end-to-end ms, MP/s, bytes; each stream must have grok_tpu's
              length and SHA-256 (REF_SHA256), and every kernel of the path
              must have launched
     e2e_dec  the three streams decoded like three requests, each image
              equal to the input; K-i, K-g and K-h must have launched
  7. e2e_ht   3840x2160x3 ht_lossless (the same with ht=True) compressed
              three times, each stream with grok_tpu's length and SHA-256,
              then decoded three times, each image equal to the input;
              every kernel of the path must have launched
Then the kernel summary line, the nvidia-smi line and the result line.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
INT32_OPS_PER_S = 33.5e12  # H100 SXM peak INT32 rate, NVIDIA H100 white paper
W, H, NC = 3840, 2160, 3
# (bytes, SHA-256) of grok_tpu.compress on natural_image at num_resolutions=6
# (tests/test_torch_chip_digest.py holds the reference to these constants)
# and, under the keys "ht ...", with ht=True
REF_SHA256 = {
    "256x256x3": (147007, "c8e5192c60295212783a605cc25055a893555e279f14797bf4913bd12baea422"),
    "2160x3840x3": (18521590,
                    "871125ffbdb4a5224ec007141915b9ef1668cc55aae99b59bb83f4b283006e25"),
    "ht 256x256x3": (156314,
                     "981b10cd866a02d916f23f83803eabed0a674dbecef23ee88ff70b29c624762e"),
    "ht 2160x3840x3": (19715221,
                       "79cb44cc7426e51a469c80f9274908a7b356066fc835aed2d089309819b7f64f"),
}
PART1_KERNELS = ("dc_rct_fwd", "dwt53_fwd_level", "ebcot_symbols", "mq_pack")
PART1_DEC_KERNELS = ("ebcot_decode", "dwt53_inv_level", "rct_inv_dc_clip")
HT_KERNELS = ("dc_rct_fwd", "dwt53_fwd_level", "ht_cleanup_enc", "ht_cleanup_dec",
              "dwt53_inv_level", "rct_inv_dc_clip")


def natural_image(h, w, nc=3):
    """bench.py's synthetic content (numpy, seed 3)."""
    r = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 23) * np.cos(yy / 31)
    tex = r.standard_normal((h, w)) * 0.02
    edges = ((xx // 40 + yy // 40) % 2) * 0.2
    g = (np.clip(base + tex + edges, 0, 1) * 255).astype(np.int32)
    if nc == 1:
        return g
    return np.stack(
        [g] + [np.clip(g + r.integers(-20, 20, (h, w)), 0, 255) for _ in range(nc - 1)],
        axis=-1,
    ).astype(np.int32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest_ok(stream: bytes, key: str) -> tuple[str, bool]:
    """SHA-256 of a stream and whether it and its length are grok_tpu's."""
    sha = hashlib.sha256(stream).hexdigest()
    return sha, (len(stream), sha) == REF_SHA256[key]


def cuda_ms(torch, fn, reps=5):
    """Mean device milliseconds of fn over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cpu_ms(fn):
    t = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t) * 1e3, out


def dec_inputs(torch, plan, numbps, npasses, seg_len, buf, idx=None, keep=None, lens=None):
    """K-i's inputs for codeblocks ``idx`` (all by default) of a K-d output:
    lanes [7, n] int32, the segments back to back, their starts. ``keep``
    and ``lens`` cut codeblocks to fewer passes and bytes."""
    if idx is None:
        idx = torch.arange(numbps.numel(), device=numbps.device)
    lens = seg_len[idx] if lens is None else lens
    keep = npasses[idx] if keep is None else keep
    lanes = torch.stack([numbps[idx], keep, plan.heights[idx], plan.widths[idx],
                         plan.orients[idx], plan.styles[idx], lens]).to(torch.int32)
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    total = int(ends[-1]) if lens.numel() else 0
    pos = torch.arange(total, device=lens.device)
    lane = torch.searchsorted(ends, pos, right=True)
    data = buf[idx[lane], 1 + pos - starts[lane]].contiguous()
    return lanes.contiguous(), data, starts.contiguous()


def _device(torch):
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import grok_tpu_torch as gt
    from grok_tpu_torch import kernels
    from grok_tpu_torch.codestream.compress import build_siz, build_tcp
    from grok_tpu_torch.codestream.quantizer import apply_band_quant
    from grok_tpu_torch.ops import transform as tr
    from grok_tpu_torch.t1 import ebcot_cuda as ec
    from grok_tpu_torch.t1 import ht_cuda as hc
    from grok_tpu_torch.t1.ebcot import lane_numbps
    from grok_tpu_torch.tile.tile_processor import TileProcessor, _repair_pass_rates

    dev = _device(torch)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build
    build_s = kernels.build_all()
    regs = {}
    for k in kernels.KERNELS.values():
        log = kernels.BUILD_DIR / (k.source.rsplit(".", 1)[0] + ".log")
        if log.exists():
            regs[k.source] = [ln.strip() for ln in log.read_text().splitlines()
                              if "registers" in ln]
    emit({"phase": "build", "seconds": round(build_s, 3), "ptxas": regs})

    # ---- 3. kernels
    emit({"phase": "kernels", "path_kernels": [
        {"name": k.name, "route": "cuda", "source": f"grok_tpu_torch/csrc/{k.source}",
         "replaces": k.replaces} for k in kernels.KERNELS.values()]})

    # ---- 4. each kernel against its plain version
    arr = natural_image(H, W, NC)
    image = gt.Image.from_array(arr)
    params = gt.CompressParams(num_resolutions=6)
    siz, tcp = build_siz(image, params), build_tcp(image, params)
    tp = TileProcessor(siz, tcp, 0, dev)
    for c in range(NC):
        apply_band_quant(tp.geoms[c], tcp.tccps[c])
    planes = [torch.from_numpy(np.ascontiguousarray(arr[:, :, c])).to(dev) for c in range(NC)]
    dcs = [128] * NC
    stats = {}

    # K-a on the whole image
    got = tr.dc_rct_fwd(planes, dcs, True)
    ref = tr.dc_rct_fwd_plain(planes, dcs, True)
    err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
    stats["dc_rct_fwd"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: tr.dc_rct_fwd(planes, dcs, True)),
        plain_ms=cuda_ms(torch, lambda: tr.dc_rct_fwd_plain(planes, dcs, True)),
        bytes=6 * 4 * W * H, ops=8 * W * H, library_ms=None, shape=f"3 x {H}x{W} int32")

    # K-b on the whole image: all levels of all components
    levels = []
    for g in tp.geoms:
        cur = g.rect
        for _ in range(5):
            levels.append((cur.height, cur.width, cur.y0 & 1, cur.x0 & 1))
            cur = cur.ceil_div_pow2(1)

    def dwt_all(fn, ps):
        for c, p in enumerate(ps):
            for (h, w, py, px) in levels[5 * c:5 * c + 5]:
                fn(p, h, w, py, px)
    kern = [p.clone() for p in got]
    plain = [p.clone() for p in got]
    dwt_all(tr.dwt53_fwd_level, kern)
    dwt_all(tr.dwt53_fwd_level_plain, plain)
    err = max(int((a - b).abs().max()) for a, b in zip(kern, plain))
    packed_ref = [p.clone() for p in plain]
    stats["dwt53_fwd_level"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: dwt_all(tr.dwt53_fwd_level, kern)),
        plain_ms=cuda_ms(torch, lambda: dwt_all(tr.dwt53_fwd_level_plain, plain)),
        bytes=sum(8 * h * w for (h, w, _, _) in levels),
        ops=sum(9 * h * w for (h, w, _, _) in levels), library_ms=None,
        shape="5 levels x 3 comps from 2160x3840 (ms per image)")
    coeffs = tr.forward_transform(planes, [g.rect for g in tp.geoms], [5] * NC, dcs, True)
    if any(not torch.equal(a, b) for a, b in zip(coeffs, packed_ref)):
        raise AssertionError("forward_transform differs from the level-by-level check")

    # K-c / K-d: full batch on the card, sample against the plain versions
    plan = tp.gather_plan()
    batch = tp.gather(coeffs, plan)
    n, bh, bw = batch.shape
    numbps = lane_numbps(batch.abs(), plan.heights, plan.widths)
    pmax = int(numbps.max())
    pmaxc = -(-pmax // 4) * 4
    lanes = torch.stack([numbps, plan.heights, plan.widths, plan.orients,
                         plan.styles]).to(torch.int32).contiguous()
    tabs = ec.device_tables(dev)
    sym = ec.ebcot_symbols(batch, lanes, tabs["ctx"], pmaxc)
    ms_c = cuda_ms(torch, lambda: ec.ebcot_symbols(batch, lanes, tabs["ctx"], pmaxc), reps=3)
    nb32 = lanes[0].contiguous()
    st32 = lanes[4].contiguous()
    packed = ec.mq_pack(sym, nb32, st32, tabs["mq"], bh, bw, pmax)
    ms_d = cuda_ms(torch, lambda: ec.mq_pack(sym, nb32, st32, tabs["mq"], bh, bw, pmax), reps=3)

    rng = np.random.default_rng(7)
    orients = plan.orients.cpu().numpy()
    pick = np.concatenate([rng.choice(np.flatnonzero(orients == o),
                                      size=min(20, int((orients == o).sum())), replace=False)
                           for o in range(4)])
    idx = torch.from_numpy(np.sort(pick)).to(dev)
    s_batch = batch[idx].contiguous()
    s_lanes = lanes[:, idx].contiguous()
    s_pmax = int(s_lanes[0].max())
    s_pmaxc = -(-s_pmax // 4) * 4
    s_sym = ec.ebcot_symbols(s_batch, s_lanes, tabs["ctx"], s_pmaxc)
    sample_ms_c = cuda_ms(torch, lambda: ec.ebcot_symbols(s_batch, s_lanes, tabs["ctx"],
                                                          s_pmaxc), reps=3)
    plain_ms_c, p_sym = cpu_ms(lambda: ec.ebcot_symbols_plain(
        s_batch.cpu(), s_lanes.cpu(), tabs["ctx"].cpu(), s_pmaxc))
    err_c = int((s_sym.cpu().to(torch.int32) - p_sym.to(torch.int32)).abs().max())
    k_out = ec.mq_pack(s_sym, s_lanes[0].contiguous(), s_lanes[4].contiguous(),
                       tabs["mq"], bh, bw, s_pmax)
    sample_ms_d = cuda_ms(torch, lambda: ec.mq_pack(s_sym, s_lanes[0].contiguous(),
                                                    s_lanes[4].contiguous(), tabs["mq"],
                                                    bh, bw, s_pmax), reps=3)
    plain_ms_d, p_out = cpu_ms(lambda: ec.mq_pack_plain(
        p_sym, s_lanes[0].cpu(), s_lanes[4].cpu(), tabs["mq"].cpu(), bh, bw, s_pmax))
    err_d = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(k_out, p_out))
    s_pad = sym.shape[3]
    s_spp, s_mrp, s_cup, _ = ec.slot_counts(-(-bh // 4), bw)
    nbh = numbps.cpu().numpy()
    read_d = int(sum(max(int(b) - 1, 0) * (s_spp + s_mrp) + int(b) * s_cup for b in nbh))
    written_d = int(packed[1].sum()) + n  # segment bytes and each lane's carry byte
    # the records the coder codes: what sizes K-d's serial chain
    valid = torch.cat([(sym[i:i + 512] >= 0x80).reshape(-1, pmaxc * 3 * s_pad).sum(1)
                       for i in range(0, n, 512)])
    records = pmaxc * 3 * s_pad * n
    sample = (f"{len(pick)} codeblocks ("
              + ", ".join(f"{(orients[pick] == o).sum()} orient {o}" for o in range(4))
              + "), plain on cpu")
    # operations: at least one integer operation per record written (K-c)
    # or read (K-d); any form of the scan or the coder does more
    stats["ebcot_symbols"] = dict(
        max_abs_err=err_c, ms=ms_c, plain_ms=plain_ms_c, library_ms=None,
        bytes=n * bh * bw * 4 + records, ops=records,
        shape=f"{n} codeblocks {bh}x{bw}, pmaxc {pmaxc}, records {records} B",
        plain_shape=sample, sample_ms=sample_ms_c)
    stats["mq_pack"] = dict(
        max_abs_err=err_d, ms=ms_d, plain_ms=plain_ms_d, library_ms=None,
        bytes=read_d + written_d + n * 8 + packed[2].numel() * 8, ops=read_d,
        shape=f"{n} codeblocks, records of coded planes {read_d} B, segments {written_d} B",
        plain_shape=sample, sample_ms=sample_ms_d, valid_records=int(valid.sum()),
        max_valid_records_one_codeblock=int(valid.max()),
        sample_max_valid_records=int(valid[idx].max()))

    # K-i: the whole 4K batch's segments back to the coefficients K-c read,
    # timed on the card; the sample against the plain version on the CPU,
    # once whole and once cut after a seeded pass at that pass's rate
    buf, seg_len, rates = packed
    npasses = (numbps * 3 - 2).clamp(min=0)
    dec_lanes, dec_data, dec_starts = dec_inputs(torch, plan, numbps, npasses, seg_len, buf)
    no_segs = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    dec = ec.ebcot_decode(dec_data, dec_starts, dec_lanes, no_segs, tabs["ctx"], tabs["mq"],
                          bh, bw)
    ms_i = cuda_ms(torch, lambda: ec.ebcot_decode(dec_data, dec_starts, dec_lanes, no_segs,
                                                  tabs["ctx"], tabs["mq"], bh, bw), reps=3)
    whole_ok = torch.equal(dec, batch)
    err_i = int((dec.to(torch.int64) - batch).abs().max())
    del dec
    rate_np = rates.cpu().numpy().astype(np.int64)
    np_passes = npasses.cpu().numpy()
    _repair_pass_rates(rate_np, np_passes)
    s_np = idx.cpu().numpy()
    s_passes = np_passes[s_np]
    cut = rng.integers(1, np.maximum(s_passes, 1) + 1)
    cut = np.where(s_passes > 0, np.minimum(cut, s_passes), 0)
    cut_len = np.where(cut > 0, rate_np[s_np, np.maximum(cut - 1, 0)], 0)
    cut_len = np.minimum(cut_len, seg_len.cpu().numpy()[s_np])
    i_checks = {}
    for label, keep, lens in (("whole", s_passes, seg_len.cpu().numpy()[s_np]),
                              ("cut", cut, cut_len)):
        s_lanes, s_data, s_starts = dec_inputs(
            torch, plan, numbps, npasses, seg_len, buf, idx,
            torch.from_numpy(keep).to(dev), torch.from_numpy(lens).to(dev))
        s_seg = torch.zeros((len(s_np), 1), dtype=torch.int32, device=dev)
        k_dec = ec.ebcot_decode(s_data, s_starts, s_lanes, s_seg, tabs["ctx"], tabs["mq"],
                                bh, bw)
        p_ms, p_dec = cpu_ms(lambda: ec.ebcot_decode_plain(
            s_data.cpu(), s_starts.cpu(), s_lanes.cpu(), s_seg.cpu(), tabs["ctx"].cpu(),
            tabs["mq"].cpu(), bh, bw))
        i_checks[label] = dict(max_abs_err=int((k_dec.cpu().to(torch.int64) - p_dec).abs().max()),
                               plain_ms=p_ms, passes=int(keep.sum()), bytes=int(lens.sum()))
        if label == "whole":
            err_i = max(err_i, i_checks[label]["max_abs_err"],
                        int((k_dec.to(torch.int64) - s_batch).abs().max()))
        else:
            err_i = max(err_i, i_checks[label]["max_abs_err"])
    if not whole_ok:
        raise AssertionError("ebcot_decode of the 4K batch is not the batch")
    dec_bytes = int(seg_len.sum())
    samples_i = int((plan.heights * plan.widths).sum())
    stats["ebcot_decode"] = dict(
        max_abs_err=err_i, ms=ms_i, plain_ms=i_checks["whole"]["plain_ms"], library_ms=None,
        bytes=dec_bytes + samples_i * 4 + n * (7 * 4 + 8), ops=int(valid.sum()),
        shape=f"{n} codeblocks {bh}x{bw}, {samples_i} samples, segments {dec_bytes} B, "
              f"{int(valid.sum())} decisions (at most {int(valid.max())} in one codeblock)",
        plain_shape=sample, sample_checks=i_checks,
        ns_per_decision_longest=ms_i * 1e6 / int(valid.max()))
    del sym, packed, s_sym, buf, dec_data

    # K-e / K-f: full 4K batch on the card, the same sample against the
    # plain versions on the CPU
    h32 = plan.heights.to(torch.int32).contiguous()
    w32 = plan.widths.to(torch.int32).contiguous()
    htab = hc.ht_tables(dev)
    mmax = max((2 * int(batch.abs().max()) - 1).bit_length(), 1)
    hbuf, hlen = hc.ht_cleanup_enc(batch, h32, w32, htab, mmax)
    ms_e = cuda_ms(torch, lambda: hc.ht_cleanup_enc(batch, h32, w32, htab, mmax), reps=3)
    seg_bytes = int(hlen.sum())
    hdata = hbuf[:, :int(hlen.max())].contiguous()
    hlen32 = hlen.to(torch.int32)
    dec, dec_wide = hc.ht_cleanup_dec(hdata, hlen32, h32, w32, htab, bh, bw)
    ms_f = cuda_ms(torch, lambda: hc.ht_cleanup_dec(hdata, hlen32, h32, w32, htab, bh, bw),
                   reps=3)
    if bool(dec_wide.any()) or not torch.equal(dec, batch):
        raise AssertionError("ht_cleanup_dec of the 4K batch is not the batch")
    del dec, dec_wide
    s_h, s_w = h32[idx].contiguous(), w32[idx].contiguous()
    k_enc = hc.ht_cleanup_enc(s_batch, s_h, s_w, htab, mmax)
    plain_ms_e, p_enc = cpu_ms(lambda: hc.ht_cleanup_enc_plain(
        s_batch.cpu(), s_h.cpu(), s_w.cpu(), k_enc[0].shape[1]))
    err_e = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(k_enc, p_enc))
    s_data = k_enc[0][:, :max(int(k_enc[1].max()), 2)].contiguous()
    s_len32 = k_enc[1].to(torch.int32)
    k_dec = hc.ht_cleanup_dec(s_data, s_len32, s_h, s_w, htab, bh, bw)
    plain_ms_f, p_dec = cpu_ms(lambda: hc.ht_cleanup_dec_plain(
        s_data.cpu(), s_len32.cpu(), s_h.cpu(), s_w.cpu(), bh, bw))
    err_f = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(k_dec, p_dec))
    samples = int((h32.to(torch.int64) * w32).sum())  # inside the codeblocks
    stats["ht_cleanup_enc"] = dict(
        max_abs_err=err_e, ms=ms_e, plain_ms=plain_ms_e, library_ms=None,
        bytes=samples * 4 + seg_bytes + n * 8, ops=samples,
        shape=f"{n} codeblocks {bh}x{bw}, {samples} samples, segments {seg_bytes} B, "
              f"MagSgn fields <= {mmax} bits", plain_shape=sample)
    stats["ht_cleanup_dec"] = dict(
        max_abs_err=err_f, ms=ms_f, plain_ms=plain_ms_f, library_ms=None,
        bytes=seg_bytes + samples * 4 + n, ops=samples,
        shape=f"{n} codeblocks {bh}x{bw}, {samples} samples, segments {seg_bytes} B",
        plain_shape=sample)
    del hbuf, hdata, batch

    # K-g / K-h on the whole image, from the packed planes back to samples
    inv_levels = [lv for c in range(NC) for lv in reversed(levels[5 * c:5 * c + 5])]

    def idwt_all(fn, ps):
        for c, p in enumerate(ps):
            for (h, w, py, px) in reversed(levels[5 * c:5 * c + 5]):
                fn(p, h, w, py, px)
    kern = [p.clone() for p in coeffs]
    plain = [p.clone() for p in coeffs]
    idwt_all(tr.dwt53_inv_level, kern)
    idwt_all(tr.dwt53_inv_level_plain, plain)
    err = max(int((a - b).abs().max()) for a, b in zip(kern, plain))
    scratch = [p.clone() for p in coeffs]  # timed in place, as K-b is
    stats["dwt53_inv_level"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: idwt_all(tr.dwt53_inv_level, scratch)),
        plain_ms=cuda_ms(torch, lambda: idwt_all(tr.dwt53_inv_level_plain, scratch)),
        bytes=sum(8 * h * w for (h, w, _, _) in inv_levels),
        ops=sum(9 * h * w for (h, w, _, _) in inv_levels), library_ms=None,
        shape="5 levels x 3 comps to 2160x3840 (ms per image)")
    rng8 = [(0, 255)] * NC
    k_out = tr.rct_inv_dc_clip([p.clone() for p in kern], dcs, rng8, True)
    p_out = tr.rct_inv_dc_clip_plain([p.clone() for p in kern], dcs, rng8, True)
    err = max(int((a - b).abs().max()) for a, b in zip(k_out, p_out))
    if any(not torch.equal(k_out[c].cpu(), torch.from_numpy(np.ascontiguousarray(arr[:, :, c])))
           for c in range(NC)):
        raise AssertionError("inverse chain of the 4K coefficients is not the image")
    stats["rct_inv_dc_clip"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: tr.rct_inv_dc_clip(kern, dcs, rng8, True)),
        plain_ms=cuda_ms(torch, lambda: tr.rct_inv_dc_clip_plain(kern, dcs, rng8, True)),
        bytes=6 * 4 * W * H, ops=10 * W * H, library_ms=None, shape=f"3 x {H}x{W} int32")
    del kern, plain, k_out, p_out, scratch

    for name, s in stats.items():
        bytes_ms = s["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = s["ops"] / INT32_OPS_PER_S * 1e3
        s["bound_ms"] = max(bytes_ms, ops_ms)
        s["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        emit({"phase": "check", "kernel": name, "tolerance": 0, **s})
        if s["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from its plain version")

    # ---- 5. whole slice at 256x256x3: kernel path == plain path
    small = natural_image(256, 256, 3)
    t0 = time.perf_counter()
    s_gpu = gt.compress(gt.Image.from_array(small), gt.CompressParams(num_resolutions=6))
    t1 = time.perf_counter()
    s_cpu = gt.compress(gt.Image.from_array(small), gt.CompressParams(num_resolutions=6),
                        device="cpu")
    t2 = time.perf_counter()
    sha, ref_ok = digest_ok(s_gpu, "256x256x3")
    emit({"phase": "slice", "image": "256x256x3", "bytes": len(s_gpu), "identical": s_gpu == s_cpu,
          "sha256": sha, "reference_digest": ref_ok,
          "gpu_ms": (t1 - t0) * 1e3, "plain_cpu_ms": (t2 - t1) * 1e3})
    if s_gpu != s_cpu or not ref_ok:
        raise AssertionError("256x256 card stream differs from the plain path or grok_tpu's")

    t0 = time.perf_counter()
    p_gpu = gt.decompress(s_gpu)
    t1 = time.perf_counter()
    p_cpu = gt.decompress(s_gpu, device="cpu")
    t2 = time.perf_counter()
    p_same = all(np.array_equal(a.data, b.data) and np.array_equal(a.data, small[:, :, c])
                 for c, (a, b) in enumerate(zip(p_gpu.components, p_cpu.components)))
    emit({"phase": "slice_p1dec", "image": "256x256x3", "decode_equal": p_same,
          "gpu_dec_ms": (t1 - t0) * 1e3, "plain_cpu_ms": (t2 - t1) * 1e3})
    if not p_same:
        raise AssertionError("256x256 Part-1 card decode differs from the plain path or the input")

    ht6 = dict(num_resolutions=6, ht=True)
    t0 = time.perf_counter()
    h_gpu = gt.compress(gt.Image.from_array(small), gt.CompressParams(**ht6))
    t1 = time.perf_counter()
    d_gpu = gt.decompress(h_gpu)
    t2 = time.perf_counter()
    h_cpu = gt.compress(gt.Image.from_array(small), gt.CompressParams(**ht6), device="cpu")
    d_cpu = gt.decompress(h_gpu, device="cpu")
    t3 = time.perf_counter()
    sha, ref_ok = digest_ok(h_gpu, "ht 256x256x3")
    dec_same = all(np.array_equal(a.data, b.data) and np.array_equal(a.data, small[:, :, c])
                   for c, (a, b) in enumerate(zip(d_gpu.components, d_cpu.components)))
    emit({"phase": "slice_ht", "image": "256x256x3", "bytes": len(h_gpu),
          "identical": h_gpu == h_cpu, "sha256": sha, "reference_digest": ref_ok,
          "decode_equal": dec_same, "gpu_enc_ms": (t1 - t0) * 1e3,
          "gpu_dec_ms": (t2 - t1) * 1e3, "plain_cpu_ms": (t3 - t2) * 1e3})
    if h_gpu != h_cpu or not ref_ok or not dec_same:
        raise AssertionError("256x256 HT card stream or decode differs from the plain path, "
                             "grok_tpu's stream or the input")

    # ---- 6. full size, three requests
    gt.reset_launch_counts()
    runs = []
    p1_streams = []
    for i in range(3):
        stage: dict[str, float] = {}
        img = gt.Image.from_array(arr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gt.compress(img, gt.CompressParams(num_resolutions=6), stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        sha, ref_ok = digest_ok(out, f"{H}x{W}x{NC}")
        runs.append({"request": i, "e2e_ms": e2e, "mp_per_s": W * H / 1e6 / (e2e / 1e3),
                     "bytes": len(out), "sha256": sha, "reference_digest": ref_ok,
                     "stage_ms": stage})
        emit({"phase": "e2e", **runs[-1]})
        if not ref_ok:
            raise AssertionError(f"request {i}: the stream is not grok_tpu's ({len(out)} B)")
        p1_streams.append(out)
    counts = gt.launch_counts()
    emit({"phase": "e2e_launches", "image": f"{W}x{H}x{NC} lossless53", "requests": 3,
          "launches": counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if any(counts[k] <= 0 for k in PART1_KERNELS):
        raise AssertionError(f"a kernel of the path never launched: {counts}")

    # ---- 6b. the Part-1 decode of those streams, three requests
    gt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for i, stream in enumerate(p1_streams):
        stage = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = gt.decompress(stream, stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        exact = all(np.array_equal(c.data, arr[:, :, k]) for k, c in enumerate(back.components))
        emit({"phase": "e2e_dec", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "exact": exact, "stage_ms": stage})
        if not exact:
            raise AssertionError(f"Part-1 decode {i}: not the input")
    dec_counts = gt.launch_counts()
    emit({"phase": "e2e_dec_launches", "image": f"{W}x{H}x{NC} lossless53", "requests": 3,
          "launches": dec_counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if any(dec_counts[k] <= 0 for k in PART1_DEC_KERNELS):
        raise AssertionError(f"a kernel of the Part-1 decode never launched: {dec_counts}")
    counts["ebcot_decode"] = dec_counts["ebcot_decode"]
    del p1_streams

    # ---- 7. HT at full size: three encodes, three decodes
    gt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    streams = []
    for i in range(3):
        stage = {}
        img = gt.Image.from_array(arr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gt.compress(img, gt.CompressParams(num_resolutions=6, ht=True), stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        sha, ref_ok = digest_ok(out, f"ht {H}x{W}x{NC}")
        emit({"phase": "e2e_ht", "op": "encode", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "bytes": len(out), "sha256": sha,
              "reference_digest": ref_ok, "stage_ms": stage})
        if not ref_ok:
            raise AssertionError(f"HT request {i}: the stream is not grok_tpu's ({len(out)} B)")
        streams.append(out)
    for i, stream in enumerate(streams):
        stage = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = gt.decompress(stream, stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        exact = all(np.array_equal(c.data, arr[:, :, k]) for k, c in enumerate(back.components))
        emit({"phase": "e2e_ht", "op": "decode", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "exact": exact, "stage_ms": stage})
        if not exact:
            raise AssertionError(f"HT decode {i}: not the input")
    ht_counts = gt.launch_counts()
    emit({"phase": "e2e_ht_launches", "image": f"{W}x{H}x{NC} ht_lossless", "requests": 3,
          "launches": ht_counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if any(ht_counts[k] <= 0 for k in HT_KERNELS):
        raise AssertionError(f"a kernel of the HT path never launched: {ht_counts}")
    for k in HT_KERNELS[2:]:
        counts[k] = ht_counts[k]

    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": f"grok_tpu_torch/csrc/{k.source}",
         "replaces": k.replaces, "launches": counts[k.name],
         "max_abs_err": stats[k.name]["max_abs_err"], "ms": stats[k.name]["ms"],
         "plain_ms": stats[k.name]["plain_ms"], "bound_ms": stats[k.name]["bound_ms"],
         "bound_by": stats[k.name]["bound_by"], "library_ms": stats[k.name]["library_ms"]}
        for k in kernels.KERNELS.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
