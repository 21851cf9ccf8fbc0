#!/usr/bin/env python3
"""Drive grok_tpu_torch on one CUDA card: the Part-1 and HTJ2K encode and
decode, lossless (5/3 + RCT) and lossy (9/7 + ICT), with quality layers
and PCRD rate control, the Part-2 array MCT and component ROI (RGN), and
the multi-device layer (K6: the distributed encode, decode and frame
entry points and the sharded strip wavelet) over a mesh of the cards
present, or of four shards on one card.

Run from the repository root:  python3 chip_smoke.py
On a machine with two or more cards, ``python3 chip_smoke.py --cards``
runs the K6 phases alone (slice_dist, e2e_dist, e2e_frames, slice_strip),
over every card and then over a virtual mesh of as many shards on the
first card. ``python3 chip_smoke.py --check`` stops after phase 4.
``python3 chip_smoke.py --ke-warps`` times K-e's C entry at 1 to 16
warps a block on the first launch of an HT encode of 256x256x3 and of
3840x2160x3 (the measurement behind ht_cuda.ENC_WARPS), and stops.

Phases, one JSON line each (any failure exits non-zero before the last
line):
  1. device   card name and power limit (nvidia-smi)
  2. build    nvcc of every kernel source, in parallel, with build seconds
  3. kernels  every kernel of the paths and the TPU kernel it replaces
  4. check    each kernel against its plain version on inputs from the
              3840x2160x3 image: K-a, K-b, K-g and K-h, and K-j, K-k, K-l,
              K-m, K-n and K-o on the whole image (plain versions on the
              card; the 9/7 kernels compared on their float32 bits), K-c,
              K-d, K-e, K-f and K-i on a seeded sample of codeblocks from
              every band type (plain versions on the CPU; K-e, K-f and K-i
              timed on the whole batch; K-i's sample once whole and once cut
              after a seeded pass, and the whole batch decoded back to K-c's
              input; the cut sample with seeded ROI shifts in the style bits
              of every other codeblock); K-e's block energy on the sample
              (plain on the CPU) and the whole batch (plain on the card),
              its C entry alone in turns with its wrapper, its quads, MEL
              events, stuffed bytes, launch (resident codeblocks, waves)
              and ptxas, and its bound on the segment bytes alone; K-e on
              a seeded batch of magnitudes from 2^24 to INT32_MIN's 2^31
              (segments and energies, plain on the CPU); K-l and K-m as the
              chains call them, one call (one launch) a tile, warm and
              cold, with the call's host enqueue, and on the QUANT_ODD
              tiles (odd sizes and origins, views off 16-byte alignment,
              ten components: two launches a call); K-f's
              sample also cut at seeded lengths and with seeded bytes
              flipped (stops and values against the plain version), its C
              entry in turns with its wrapper, its launch and ptxas, and
              its bound on the bytes inside the codeblocks beside that on
              the rows it writes whole; K-p
              and K-q on the sample (plain on the CPU) and on the whole 4K
              lossy97 batch (K-p's plain on the card, K-q's on the CPU),
              with K-p's passes summed by the exact reduction and by the
              ordered chain, the record-row bytes it reads, its launch and
              ptxas; K-b, K-g, K-k and K-n as forward_transform and
              inverse_transform call them (dwt53_fwd_levels,
              dwt53_inv_levels, dwt97_fwd_levels, dwt97_inv_levels: 15
              launches an image, warm and cold) and by their in-place
              one-level entries, each level of a component alone (C
              entry), a 1024x1024 tile's five levels, their launches and
              ptxas, and the stages they run in (the 5/3 encode's
              transform, K-a and K-b; the 5/3 decode's inverse, K-g and
              K-h; the 9/7 encode's transform, K-j, K-k and K-l; the 9/7
              decode's inverse, K-m, K-n and K-o: host enqueue, wall and
              device ms); K-r and K-s (the Part-2 MCT with M3 and back,
              warm and cold, with a call's host enqueue and K-r's launch)
              and K-t (a packed plane shifted up and down) on the whole
              image, plain on the card, and K-r and K-s with M4, with 127
              components and on views one sample off 16-byte alignment
              (mct_checks: launches and allocations a call); K-u, K-v
              on the level-0 sub-block of a shard of the 4096x4096 strip,
              K-b/K-g/K-k/K-n's horizontal halves on the level-0 sub-blocks
              of the card's shards in one launch, as slice_strip launches
              them, warm and cold, and on one sub-block alone, with their
              launch, ptxas and the form taken, K-w on
              the 4K tile batch, plain on the card; all compared exactly,
              the float outputs on their bits. Kernel times (KernelTimer):
              one event pair a launch, the median, least and largest of
              REPS launches after a warm-up, in turns with the row's
              library call where it has one; warm, and also cold (the L2
              flushed before each launch) for K-t, K-v and any row with a
              warm reading under the HBM time of its bytes, which is
              printed as "l2": true and not as a share of the bound;
              plain versions one mean of back-to-back launches
     check_forms  K-v's one-pass form at each band that fits and its
              two-pass form on that sub-block, each against the plain
              version, timed in turns with index_select, warm and cold
     check_long_lines  a 2 x 65,536 plane through every form of the four
              horizontal halves: the "scratch" form (the wrappers' at this
              length) on whole lines, the "smem" form on their first
              MAX_LINE samples, both parities, each equal to its plain
              version; parity 0 timed warm
     check_form_choice  both forms of each horizontal half on the
              LONG_GROUPS launches, each equal to the plain version, timed
              in turns, warm, beside the form transform.h_form picks
  5. slice    256x256x3 compress on the card, byte-identical to the plain
              path (device="cpu") and to grok_tpu's stream (REF_SHA256);
     slice_p1dec  the Part-1 stream decoded on the card, equal to the plain
              path's decode and to the input
     slice_ht the same with ht=True, and the card's decode of it equal to
              the plain path's and to the input
     slice_97 the same with irreversible=True (9/7 + ICT): the card stream
              equal to the plain path's and grok_tpu's, its card decode
              equal to the plain path's and to grok_tpu's decode (REF_MD5)
     slice_rc the RC_CASES (layers with rate or PSNR targets, 5/3 and 9/7,
              Part-1 and HT, both PCRD searches) on the card: each stream
              with grok_tpu's length and SHA-256, its card decodes with
              max_layers 0 and 1 with grok_tpu's digests; K-p, K-e and K-q
              must launch
     slice_mct_roi  the MCT_ROI_CASES (the Part-2 MCT, 9/7 Part-1 and HT,
              three and four components; ROI on 5/3 HT and on 9/7 Part-1
              with layers) on the card: each stream with grok_tpu's length
              and SHA-256, its decodes with max_layers 0 and 1 with
              grok_tpu's digests; a PLAIN_CUT crop of each image coded and
              decoded on the card and by the plain path, identical; K-r,
              K-s and both entries of K-t must launch
     slice_ht_wide  WIDE_HT_CASES (HT at WIDE_BITS = 28 bits, 5/3 and 9/7)
              on a 64x64x3 wide_image: coefficients from 2^24 up; each
              card stream equal to the plain path's and with grok_tpu's
              length and SHA-256, its card decode equal to the plain
              path's (and to the input, 5/3); every kernel of the path
              must launch
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
  8. e2e_97   3840x2160x3 lossy97 without a rate target (irreversible=True,
              one layer holding every pass) compressed three times and
              decoded three times: each stream with grok_tpu's length and
              SHA-256, each decode with the digest of grok_tpu's decode;
              K-j, K-k, K-l, K-c, K-d, K-i, K-m, K-n and K-o must launch
     e2e_1bpp bench.py's lossy97_1bpp row (P1BPP: 9/7 + ICT, one layer at
              a rate of 8:1, PCRD with exact packet simulations) at
              3840x2160x3, three encodes (stage times with t1_dist, hull,
              pcrd and the number of simulations) and three decodes: each
              stream with grok_tpu's length and SHA-256, each decode with
              its digest; the 9/7 kernels, K-p and K-q must launch
     e2e_mct  PMCT (the Part-2 MCT with M3, 9/7 Part-1) at 3840x2160x3,
              three encodes and three decodes, held to REF_SHA256 and
              REF_MD5; K-r and K-s (and the 9/7 kernels) must launch
     e2e_roi  PROI (ROI maxshift 4 on component 0, 5/3 Part-1) likewise,
              each decode equal to the input; K-t's up entry and K-i must
              launch
     e2e_roi_ht  PROI_HT (the same on HTJ2K) likewise; both entries of K-t
              must launch (the down entry runs on HT decodes only)
  9. truncated  a 40x40x3 stream with 24x24 tiles, Part-1 and HT, cut to
              10-99% of its length: the card's planes equal the plain path's
     slice_dist  K6 over the mesh (mesh: every card when there are two or
              more, else four shards on the one card): 256x256x3 at 64x64
              and 37x37 tiles (the odd-parity regression), 5/3 and 9/7,
              Part-1 and HT, through compress_distributed (the port's
              compress stream), decompress_distributed (its decompress
              planes) and, once a coding, compress_frames of three frames
              (each frame's compress stream)
     e2e_dist 3840x2160x3 at 1024x1024 tiles (BASELINE config 4), lossless53
              and lossy97, three compress_distributed and three
              decompress_distributed requests each: streams held to
              REF_SHA256["dist53 ..."/"dist97 ..."], 5/3 decodes equal to the
              input, 9/7 decodes to REF_MD5; then make_sharded_transform on
              the 4K tile batch (eight 1024x960 tiles), equal to the
              unsharded K-a + K-b; every kernel of the path, K-w included,
              must launch
     e2e_frames  compress_frames of four 3840x2160x3 frames (lossy97,
              natural_image seeds 3-6), twice: frame 0 with the pinned
              "97 ..." digest, the others equal to the port's compress
     slice_strip  a 4096x4096 plane, 5 levels, over the mesh: the 5/3
              strip through the layout bridge equal to K-b unsharded and
              its inverse the input, the 9/7 strip equal to K-k unsharded
              on the float32 bits; the bridged 5/3 coefficients through
              encode_tile_to_blob inside the port's compress stream of the
              plane; ms of forward, bridge and inverse, halo copies; K-u,
              K-v and the horizontal halves must launch, each half once a
              level a card (5 a pass on one card)
     slice_strip_long  a 128 x 65,536 plane (LONG_STRIP), LONG_LEVELS
              levels, over the mesh: level 0's lines take the horizontal
              halves' "scratch" form, the others the form h_form picks; 9/7
              equal to K-k unsharded on the float32 bits and 5/3 to K-b,
              the inverses to the unsharded K-n and K-g inverses and the
              input (9/7 within 1e-3, 5/3 exactly)
 10. corpus   every .j2k of tests/corpus/streams decoded on the card with
              the manifest's decode parameters: identical to grok_tpu's
              decode (CORPUS_REF_MD5), or refused by name; none may differ
 11. walls    the wall seconds of each phase above
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
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
FP64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores, NVIDIA data sheet
REPS = 21  # timed launches of each kernel and library call, after a warm-up launch
LEAD_CYCLES = 1_000_000  # the spin ahead of each timed launch, about 0.5 ms on an H100
FLUSH_BYTES = 128 << 20  # the cold mode's overwrite and read: each over the 50 MB L2
W, H, NC = 3840, 2160, 3
# codeblocks of each band orientation in the kernel check's seeded sample,
# which the plain versions code on the CPU (about 1.7 s a codeblock for
# K-c, K-d and K-i together)
SAMPLE_PER_ORIENT = 10
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
    # and under "97 ...", with P97 (irreversible=True)
    "97 256x256x3": (84562, "8440126c3d3c48c84b37bcfe86f3217c295caad4c82147886af8281b5adc55ca"),
    "97 2160x3840x3": (10616803,
                       "9e62acf19ebb02a2c45bd96aa6bc77bbdbac2ae0276585dd9314f9756a2c5e37"),
    # under "<case> ...", with RC_CASES[case], and under "1bpp ...", with P1BPP
    "rc_a 256x256x3": (24396, "a14bd4febc5cf491062445d96ec68a1e2181db628c468c286f2c7833160ec65f"),
    "rc_b 256x256x3": (147107,
                       "b515fa3433c7d3e262f3baf1a097208dad693bdaa603df381564c10fd916aa84"),
    "rc_c 256x256x3": (56326, "8582c1ffa808ea082ecfc615b9d988e1da4b45f55a294fef895fb35fa945ad6a"),
    "rc_d 256x256x3": (90972, "e18b879cf32467386e0c67282dd39c4b2fb5dc5ff27c9fc84c5568b15cebd989"),
    "rc_e 256x256x3": (24396, "a20ec85d1186d468f4f5caccf99902fcb6906917060c6f97d4ca432fd48635d5"),
    "1bpp 2160x3840x3": (3092523,
                         "10640d5fcb4dacbff02b52b4f079f8dca75f3e2fa7fd96bedce9bc2e8f327581"),
    # under "<case> 256x256x<nc>", with MCT_ROI_CASES[case] on natural_image
    # of nc components; under "mct ...", "roi ..." and "roi_ht ..." at 4K,
    # PMCT, PROI and PROI_HT
    "mct 256x256x3": (85326, "7469b049081f67c6e317f9bef20e71ecf824eac73decb5ee2ffaa2736fd53966"),
    "mct_ht 256x256x3": (92297,
                         "b8194d3547954386cc7e1da93dc122928b24f2dc75e6cf7b7639f9f04aa19861"),
    "mct4 256x256x4": (113920,
                       "576c4353dac4ba2a67a562dc6588e464574899acdbfe3f61273899021d217391"),
    "roi_ht 256x256x3": (188299,
                         "d732c3ebf81aba7b73fb0ec76a8e374a049598f29ad41489da6ee53fde7f15fa"),
    "roi97 256x256x3": (24548, "b55e6aa3d963a4296b22453bd18533b361e55a968dd753c52e5b3c25fa2b1308"),
    "mct 2160x3840x3": (10714753,
                        "9020a473ae92ab134fe369e64f6304ee148aedb3973535aa25532ad339acbf90"),
    "roi 2160x3840x3": (18551900,
                        "9ad1fc85850d30df105d0484c6b32334c357afc33a3c1f6d10b4b5928e1a3b38"),
    "roi_ht 2160x3840x3": (23759587,
                           "1fb0ed0a5dd90542253c19e7e77b67bc8fdc2257bb8ab0ec76aeda3d03348455"),
    # under "ht <case> 64x64x3", with WIDE_HT_CASES[case] on wide_image at WIDE_BITS
    "ht wide53 64x64x3": (41416,
                          "de44e1b3d9ff81335d1fa1451e29d3656237759219764e284a678e7ae0053e14"),
    "ht wide97 64x64x3": (38096,
                          "70e6dd7efb314e5a179e91edb6663b226f91f4c7b2ace71d434fa59de5af67d7"),
    # under "dist53 ..." and "dist97 ...", with DIST53 and DIST97 (1024x1024 tiles)
    "dist53 2160x3840x3": (18526634,
                           "9dc7e7cc3f979e9b00705b2092b3c8dcd29139618d5cc54cd5de6932a36cac68"),
    "dist97 2160x3840x3": (10622856,
                           "f42ed47cd43db0f86423586f80ef71129633d3015b35d5bfd59ec077012c0cbe"),
}
PART1_KERNELS = ("dc_rct_fwd", "dwt53_fwd_level", "ebcot_symbols", "mq_pack")
PART1_DEC_KERNELS = ("ebcot_decode", "dwt53_inv_level", "rct_inv_dc_clip")
HT_KERNELS = ("dc_rct_fwd", "dwt53_fwd_level", "ht_cleanup_enc", "ht_cleanup_dec",
              "dwt53_inv_level", "rct_inv_dc_clip")
K97_KERNELS = ("dc_ict_fwd", "dwt97_fwd_level", "quant_deadzone", "ebcot_symbols", "mq_pack",
               "ebcot_decode", "dequant_midbin", "dwt97_inv_level", "ict_inv_dc_round_clip")
P97 = dict(num_resolutions=6, irreversible=True)
# HT at WIDE_BITS: coefficients from 2^24 up (the slice_ht_wide phase)
WIDE_BITS = 28
WIDE_HT_CASES = {"wide53": dict(num_resolutions=6, ht=True),
                 "wide97": dict(num_resolutions=6, ht=True, irreversible=True)}
WIDE_HT_KERNELS = {
    "wide53": HT_KERNELS,
    "wide97": ("dc_ict_fwd", "dwt97_fwd_level", "quant_deadzone", "ht_cleanup_enc",
               "ht_cleanup_dec", "dequant_midbin", "dwt97_inv_level", "ict_inv_dc_round_clip"),
}
# K-l and K-m on odd tiles: (h, w, components, levels, origin (x0, y0))
QUANT_ODD = ((1081, 1917, 3, 5, (1, 3)), (45, 77, 4, 3, (2, 3)), (70, 131, 10, 5, (1, 0)))
# bench.py's lossy97_1bpp row: one layer at a compression ratio of 8
P1BPP = dict(num_resolutions=6, irreversible=True, num_layers=1, layer_rates=[8])
# slice_rc: layers with rate targets (exact simulations, or rc_algorithm=1's
# header estimate) and PSNR targets, 9/7 and 5/3, Part-1 and HT
RC_CASES = {
    "rc_a": dict(num_resolutions=6, irreversible=True, num_layers=3, layer_rates=[32, 16, 8]),
    "rc_b": dict(num_resolutions=6, num_layers=2, layer_rates=[16, 1]),
    "rc_c": dict(num_resolutions=6, irreversible=True, num_layers=2, layer_psnrs=[30, 40]),
    "rc_d": dict(num_resolutions=6, ht=True, irreversible=True, num_layers=2,
                 layer_rates=[20, 1]),
    "rc_e": dict(num_resolutions=6, irreversible=True, num_layers=3, layer_rates=[32, 16, 8],
                 rc_algorithm=1),
}
RC_KERNELS = ("ebcot_pass_dist", "hull_slopes")
K1BPP_KERNELS = K97_KERNELS + RC_KERNELS
# the Part-2 MCT: tests/test_device_pipeline.py:62's matrix, and a 4 x 4 one
M3 = [[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]]
M4 = [[0.5, 0.2, 0.2, 0.1], [-0.2, 0.5, -0.2, -0.1], [0.1, -0.3, 0.4, -0.2],
      [0.1, 0.1, -0.2, 0.6]]
# slice_mct_roi: (components, parameters) of the Part-2 MCT (9/7 Part-1 and
# HT, three and four components) and of component ROI (5/3 HT; 9/7 Part-1
# with three rate-controlled layers, decoded at max_layers 0 and 1)
MCT_ROI_CASES = {
    "mct": (3, dict(num_resolutions=6, mct_matrix=M3)),
    "mct_ht": (3, dict(num_resolutions=6, mct_matrix=M3, ht=True)),
    "mct4": (4, dict(num_resolutions=6, mct_matrix=M4)),
    "roi_ht": (3, dict(num_resolutions=6, roi_comp=0, roi_shift=4, ht=True)),
    "roi97": (3, dict(num_resolutions=6, roi_comp=1, roi_shift=6, irreversible=True,
                      num_layers=3, layer_rates=[32, 16, 8])),
}
# the cut of slice_mct_roi's images that the plain path codes on the CPU
PLAIN_CUT = (48, 40)
MCT_ROI_KERNELS = ("dc_mct_fwd", "mct_inv_round_clip", "roi_up", "roi_down")
PMCT = dict(num_resolutions=6, mct_matrix=M3)
PROI = dict(num_resolutions=6, roi_comp=0, roi_shift=4)
PROI_HT = dict(PROI, ht=True)
MCT_KERNELS = ("dc_mct_fwd", "dwt97_fwd_level", "quant_deadzone", "ebcot_symbols", "mq_pack",
               "ebcot_decode", "dequant_midbin", "dwt97_inv_level", "mct_inv_round_clip")
ROI_KERNELS = PART1_KERNELS + ("roi_up",) + PART1_DEC_KERNELS
ROI_HT_KERNELS = HT_KERNELS + ("roi_up", "roi_down")
# K6: the distributed encode and decode at BASELINE config 4's tile size,
# lossless53 and lossy97 (e2e_dist; digests under "dist53 ..." and "dist97
# ..."); the frame batch of e2e_frames (natural_image seeds 3-6, lossy97);
# the strip wavelet's plane and levels (slice_strip); the slice_dist cases
DIST53 = dict(num_resolutions=6, tile_size=(1024, 1024))
DIST97 = dict(DIST53, irreversible=True)
FRAME_SEEDS = (3, 4, 5, 6)
STRIP, STRIP_LEVELS = 4096, 5
# slice_strip_long: lines past transform.MAX_LINE
LONG_STRIP, LONG_LEVELS = (128, 65536), 3
# check_form_choice: launches of a few long lines (planes, rows a plane,
# columns), where transform.h_form weighs the forms: a 2-row plane,
# slice_strip_long's levels 1 and 2 on one shard and on four, and lines on
# either side of h_form's thresholds
LONG_GROUPS = ((1, 2, 51200), (1, 16, 32768), (4, 16, 32768), (1, 8, 16384), (4, 8, 16384),
               (1, 32, 16384), (1, 128, 16384), (4, 32, 51200))
# the 4K tile batch of make_sharded_transform: 8 tiles of 1024 x 960 from
# the top 2048 rows of the 4K image
TILE_BATCH = (2, 4, 1024, 960)
DIST_CASES = {
    f"{t}{'_ht' if ht else ''}_t{ts}": dict(num_resolutions=6, tile_size=(ts, ts), ht=ht,
                                             irreversible=t == "97")
    for t in ("53", "97") for ht in (False, True) for ts in (64, 37)}
STRIP_KERNELS = ("strip53_step", "strip97_step", "strip_pack_v", "strip_unpack_v",
                 "dwt53_fwd_h", "dwt53_inv_h", "dwt97_fwd_h", "dwt97_inv_h")
DIST_KERNELS = ("dc_rct_fwd", "dwt53_fwd_level", "ebcot_symbols", "mq_pack", "ebcot_decode",
                "dwt53_inv_level", "rct_inv_dc_clip", "blk_stats")
# md5 of grok_tpu.decompress's planes (golden_md5) of the "97 ...", "1bpp
# ..." and "<case> ..." streams above, the last decoded with max_layers 0
# and 1 ("... L0", "... L1"); tests/test_torch_chip_digest.py holds the
# reference to these
REF_MD5 = {
    "97 256x256x3": "7c51a8bd0b5abf07f51e726ab6ad9694",
    "97 2160x3840x3": "87ee403c75cc2803a3df68ad7f904790",
    "1bpp 2160x3840x3": "c9fd3bdae61c7d6da25488973d8b6bc2",
    "rc_a 256x256x3 L0": "fcbb2f16079d413e4813bee27305ed6d",
    "rc_a 256x256x3 L1": "55e51e20ff25daefb80b3967ddeb2d1b",
    "rc_b 256x256x3 L0": "e0eaa24105ab6f58a18e47eb83ab5d61",
    "rc_b 256x256x3 L1": "5748d247acc7a7f3e525f3ca5f4a90ba",
    "rc_c 256x256x3 L0": "521df51a990c57d6256d8b8853010f07",
    "rc_c 256x256x3 L1": "1283631872aee305ed365d182aa5e93d",
    "rc_d 256x256x3 L0": "7c51a8bd0b5abf07f51e726ab6ad9694",
    "rc_d 256x256x3 L1": "cf58f7859d31fe18fa92822c197f6616",
    "rc_e 256x256x3 L0": "fcbb2f16079d413e4813bee27305ed6d",
    "rc_e 256x256x3 L1": "394c441df18005c5489b4a3da42eae92",
    # the MCT_ROI_CASES streams with max_layers 0 and 1, and PMCT's at 4K
    "mct 256x256x3 L0": "1da735b7d6ce941bcec746267947cc79",
    "mct 256x256x3 L1": "1da735b7d6ce941bcec746267947cc79",
    "mct_ht 256x256x3 L0": "1da735b7d6ce941bcec746267947cc79",
    "mct_ht 256x256x3 L1": "1da735b7d6ce941bcec746267947cc79",
    "mct4 256x256x4 L0": "724ccedecc9ed0c5f74b58396035fa66",
    "mct4 256x256x4 L1": "724ccedecc9ed0c5f74b58396035fa66",
    "roi_ht 256x256x3 L0": "e0eaa24105ab6f58a18e47eb83ab5d61",
    "roi_ht 256x256x3 L1": "e0eaa24105ab6f58a18e47eb83ab5d61",
    "roi97 256x256x3 L0": "52c45ec13e054cc9e512d0b6675218f0",
    "roi97 256x256x3 L1": "040097d724f7a7c7df08cf0ac5aebf4f",
    "mct 2160x3840x3": "c8c9387318a387481a3bf328ccd99f61",
    "dist97 2160x3840x3": "f4622b4cd47a4bad4aa0e94392ee31e0",
}
# golden_md5 of grok_tpu.decompress's planes for every corpus stream the
# port decodes, with the manifest's decode parameters (anchored by
# tests/test_torch_chip_digest.py); the other corpus streams are refused by
# name
CORPUS_REF_MD5 = {
    "allstyles.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "big_offset.j2k": "514e9b4e7f5643385720a6fb84cd5265",
    "bypass.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "bypass_ht_mix_gray.j2k": "a7f96c70be9d0cc42925fad697b88b78",
    "cblk16.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "cblk_1024x4.j2k": "402fe7f760e8ae101add7699407ca33c",
    "cblk_128x32.j2k": "92bb931150b350bf3694de73b9f04aab",
    "cblk_16x64_tiles.j2k": "402fe7f760e8ae101add7699407ca33c",
    "cblk_4x1024.j2k": "402fe7f760e8ae101add7699407ca33c",
    "cblk_4x4.j2k": "ccbbac3aed83ea6db10d14e619b3a8af",
    "cmyk8.j2k": "069c9176ce3b1d53b3b5619a1a7d51f8",
    "cmyk8_tiles.j2k": "069c9176ce3b1d53b3b5619a1a7d51f8",
    "coc_qcc_redundant.j2k": "402fe7f760e8ae101add7699407ca33c",
    "coc_qcc_redundant_ht.j2k": "402fe7f760e8ae101add7699407ca33c",
    "col_200x1.j2k": "c1b4379f10d7d633786e6e17b8bb8e11",
    "comment_marker.j2k": "a7f96c70be9d0cc42925fad697b88b78",
    "comment_tiles_layers.j2k": "afb3c0d15319aa1c70d662db9627f6ef",
    "cprl.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "cprl_tiny_tiles.j2k": "a7f96c70be9d0cc42925fad697b88b78",
    "crg_gray.j2k": "a7f96c70be9d0cc42925fad697b88b78",
    "crg_rgb_tiles.j2k": "402fe7f760e8ae101add7699407ca33c",
    "gray10_tiles.j2k": "d0970b35349bd679e6d3567dddd02346",
    "gray12.j2k": "f3601c75d8a941fb9cc2c4abee9a88e1",
    "gray12_ht.j2k": "f3601c75d8a941fb9cc2c4abee9a88e1",
    "gray12_tiles_layers.j2k": "59f85ede74c284d4859bc4b4e81c0eb3",
    "gray14_bypass.j2k": "7c26ce069329c320483dc7972da3b0af",
    "gray16.j2k": "60698d9742314ef8072a648d4d845750",
    "gray16_tiles.j2k": "60698d9742314ef8072a648d4d845750",
    "gray2.j2k": "731c3db3bafef73f58200a72042b54f5",
    "gray4.j2k": "4b3c10732ee183877adf620464bf1239",
    "gray6.j2k": "e86ab5fb1df315fb53223487ff915b62",
    "guard3.j2k": "a7f96c70be9d0cc42925fad697b88b78",
    "guard4_gray12.j2k": "f3601c75d8a941fb9cc2c4abee9a88e1",
    "ht.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "ht_cblk32x128.j2k": "402fe7f760e8ae101add7699407ca33c",
    "ht_gray.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "ht_gray16.j2k": "b134467ede0af88847979ccc4c023f60",
    "ht_psnr.j2k": "402fe7f760e8ae101add7699407ca33c",
    "layers.j2k": "777c0bb89d218b518a4307be8206ce10",
    "layers10.j2k": "c56a6891bec8148dca17f138b902349d",
    "layers10_l7.j2k": "29c098709bb06b5037bf01f16234aa6b",
    "layers6.j2k": "402fe7f760e8ae101add7699407ca33c",
    "layers6_l3.j2k": "20f1e8fd83ff124558e8e057bfc792d9",
    "layers8_gray.j2k": "a3d98750b140f399ebe25fa396ec9a06",
    "layers8_l5.j2k": "a62b049cf4728f4245b68dd5d6ac6fc1",
    "levels2.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "lossless_gray.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "lossless_odd.j2k": "1f5149b07daabf4866a9526865213327",
    "lossless_rgb.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "lossy97.j2k": "39bd97c126a29a6e3d3aaf4838b0e2b8",
    "lossy97_gray.j2k": "39bd97c126a29a6e3d3aaf4838b0e2b8",
    "lossy97_gray16.j2k": "7c10ca378205ff4d73a8120e872f66bc",
    "lossy97_ht.j2k": "5cc31918f8fe9768e8057b99ce1905ed",
    "lossy97_psnr.j2k": "1eed9a15173b1e963fe73e6d504222d4",
    "lossy97_rates.j2k": "cb1af7b6fd7ad495676f7da87c74a6ac",
    "lossy97_tiles.j2k": "c1f3c464fd0544fcc80b4d07c3ca1a31",
    "lossy97_tiles_l1.j2k": "562ab58a24baed957afcc3f805cc7c4b",
    "mode_all_0x3f.j2k": "402fe7f760e8ae101add7699407ca33c",
    "mode_all_tiles16.j2k": "b134467ede0af88847979ccc4c023f60",
    "mode_bypass_reset.j2k": "402fe7f760e8ae101add7699407ca33c",
    "mode_pterm.j2k": "402fe7f760e8ae101add7699407ca33c",
    "mode_pterm_segsym.j2k": "402fe7f760e8ae101add7699407ca33c",
    "mode_reset_termall.j2k": "402fe7f760e8ae101add7699407ca33c",
    "mode_segsym.j2k": "402fe7f760e8ae101add7699407ca33c",
    "mode_vsc.j2k": "402fe7f760e8ae101add7699407ca33c",
    "offset.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "offset_tiles.j2k": "92bb931150b350bf3694de73b9f04aab",
    "pcrl.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "pcrl_tiles_layers.j2k": "c13d5091f55fe6ab936be96891ab5a0f",
    "psnr4_l2.j2k": "f65c4d8c6335fabce3afc21a3c079ba9",
    "psnr_layers.j2k": "0acd52a0d853224c7385dfc89a219b77",
    "pterm.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "res2_offset.j2k": "b134467ede0af88847979ccc4c023f60",
    "res7.j2k": "9846cbdc31c99cbd69833ac0a509266d",
    "res8_big.j2k": "9673caeb964c206dc8a050649b5fa8dd",
    "reset.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "roi_both_comps.j2k": "926e74fdfd454de633f9b800d18718c2",
    "roi_c0_u4.j2k": "f7a6f2cb3b98fa405b5575e35373cbd1",
    "roi_c1_u6_tiles.j2k": "3bcfd0a8265979e88b9b6f6f564af02d",
    "roi_gray16.j2k": "ec3246f22bfc32636b1c12e7385ce9c6",
    "roi_lossy.j2k": "8450a0c1537145d2e752e9b25d7e0fdb",
    "rlcp.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "rlcp_bypass_layers.j2k": "4d12fa2ef11fd847b82f10e466a76fcb",
    "rlcp_layers_l1.j2k": "84162286d8ea83dff82ddfa69da69624",
    "rlcp_offset_tiles.j2k": "402fe7f760e8ae101add7699407ca33c",
    "row_1x200.j2k": "7dabf36e9d42c193bd9c5e1c1f1492ee",
    "rpcl_tiles.j2k": "402fe7f760e8ae101add7699407ca33c",
    "segsym.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "single_res.j2k": "92bb931150b350bf3694de73b9f04aab",
    "sub420_16.j2k": "bbe34a4a0a7cd8612a45744c67553f47",
    "sub420_16_ht.j2k": "bbe34a4a0a7cd8612a45744c67553f47",
    "sub420_8.j2k": "3626fbdf2b0e01d98f1b4976f10a464f",
    "termall.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "tiles.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "tiny_5x3.j2k": "feaecdf360312f317c72b9ec66897b60",
    "tp_divider_C.j2k": "92bb931150b350bf3694de73b9f04aab",
    "tp_divider_R.j2k": "92bb931150b350bf3694de73b9f04aab",
    "tp_divider_R_ht.j2k": "402fe7f760e8ae101add7699407ca33c",
    "vsc.j2k": "83a77dad4db71756b1ab67bd4f74e716",
    "ycc_off.j2k": "402fe7f760e8ae101add7699407ca33c",
}
CUTS = (0.1, 0.3, 0.6, 0.9, 0.99)


def natural_image(h, w, nc=3, seed=3):
    """bench.py's synthetic content (numpy, seed 3 unless told)."""
    r = np.random.default_rng(seed)
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


def wide_image(h, w, nc, bits, seed=5):
    """natural_image's content at ``bits`` bits: its 8-bit samples in the
    top bits, seeded noise below."""
    base = natural_image(h, w, nc).astype(np.int64) << (bits - 8)
    noise = np.random.default_rng(seed).integers(0, 1 << (bits - 8), size=base.shape)
    return (base | noise).astype(np.int32)


def wide_blocks(n, bh, bw, seed=46):
    """K-e's wide sample, int32 [n, bh, bw] with full heights and widths:
    magnitudes from 2^24 to 2^31 - 1 (log-uniform), the named ones 2^24,
    2^30 - 1, 2^30, 2^31 - 1 and INT32_MIN, and small values beside wide
    ones (tests/test_torch_ke_host.py wide_batch)."""
    rng = np.random.default_rng(seed)
    mag = np.minimum(np.exp2(rng.uniform(24, 31, size=(n, bh, bw))), (1 << 31) - 1)
    c = np.where(rng.random((n, bh, bw)) < 0.5, -1, 1) * mag.astype(np.int64)
    c *= rng.random((n, bh, bw)) < 0.8
    named = [1 << 24, (1 << 30) - 1, 1 << 30, (1 << 31) - 1]
    c[1] = rng.choice(named + [-v for v in named] + [-(1 << 31)], size=(bh, bw))
    c[2, :, ::2] = rng.integers(-3, 4, size=(bh, (bw + 1) // 2))
    c[3, 0, 0] = -(1 << 31)
    return c.astype(np.int32), np.full(n, bh, dtype=np.int32), np.full(n, bw, dtype=np.int32)


def quant_odd_checks(torch, gt, tr, kernels, dev):
    """K-l and K-m on the QUANT_ODD tiles against their plain versions on
    the card, bit for bit, and the launches a call: the dequantization
    reads its planes as views of one buffer one sample past 16-byte
    alignment, as the decode's staging planes may lie."""
    from grok_tpu_torch.codestream.compress import build_siz, build_tcp
    from grok_tpu_torch.tile.tile_processor import TileProcessor

    out = {}
    rng = np.random.default_rng(17)
    for h, w, nc, levels, (x0, y0) in QUANT_ODD:
        img = gt.Image.from_array(np.zeros((h, w, nc), dtype=np.uint8))
        img.x0, img.y0, img.x1, img.y1 = x0, y0, x0 + w, y0 + h
        img.finalize()
        p = gt.CompressParams(num_resolutions=levels + 1, irreversible=True)
        tp = TileProcessor(build_siz(img, p), build_tcp(img, p), 0, "cpu")
        tp._apply_band_quant()
        bands = tp.band_tables()
        shapes = [(g.rect.height, g.rect.width) for g in tp.geoms]
        planes = [torch.from_numpy((rng.standard_normal(s) * 300).astype(np.float32)).to(dev)
                  for s in shapes]
        n0 = [kernels.KERNELS[k].launches for k in ("quant_deadzone", "dequant_midbin")]
        q = tr.quant_deadzone(planes, bands)
        sizes = [a * b for a, b in shapes]
        flat = torch.empty(sum(sizes) + 1, dtype=torch.int32, device=dev)
        views = [flat[1 + sum(sizes[:c]):1 + sum(sizes[:c + 1])].view(s)
                 for c, s in enumerate(shapes)]
        for v, a in zip(views, q):
            v.copy_(a)
        d = tr.dequant_midbin(views, bands)
        launches = [kernels.KERNELS[k].launches - n for k, n in
                    zip(("quant_deadzone", "dequant_midbin"), n0)]
        equal = all(torch.equal(a, tr.quant_deadzone_plain(x, b))
                    for a, x, b in zip(q, planes, bands)) and all(
            torch.equal(a.view(torch.int32), tr.dequant_midbin_plain(v, b).view(torch.int32))
            for a, v, b in zip(d, views, bands))
        out[f"{nc} x {h}x{w} at ({x0}, {y0}), {levels} levels"] = dict(
            equal=equal, launches_a_call=launches)
    return out


def mct_checks(torch, tr, kernels, dev, planes):
    """K-r and K-s beyond the M3 row, each against its plain version bit for
    bit, with the launches and the allocations of a call once its matrix is
    on the card (the outputs' only): M4 on the 4K planes (the first twice),
    127 components of 16x16, and M3 on views of one buffer, the first one
    sample past 16-byte alignment, 4,096 samples a plane (every plane at
    that alignment: K-r's 16-byte path, quads shifted) and 4,097 (the
    others at other alignments: sample by sample). The plain versions of
    the small cases run on the CPU."""
    rng = np.random.default_rng(23)
    cases = {f"M4, 4 x {H}x{W}": (planes + planes[:1], np.asarray(M4, dtype=np.float32))}
    big = [torch.from_numpy(rng.integers(0, 256, (16, 16)).astype(np.int32)).to(dev)
           for _ in range(127)]
    cases["127 x 16x16"] = (big, (np.eye(127) + rng.uniform(-0.02, 0.02, (127, 127)))
                            .astype(np.float32))
    for size in (4096, 4097):
        flat = torch.from_numpy(rng.integers(0, 256, 3 * size + 8).astype(np.int32)).to(dev)
        base = (1 - (flat.data_ptr() >> 2)) & 3
        cases[f"M3 on views of 1x{size}, one sample past 16 B"] = (
            [flat[base + k * size:base + (k + 1) * size].view(1, size) for k in range(3)],
            np.asarray(M3, dtype=np.float32))
    out = {}
    names = ("dc_mct_fwd", "mct_inv_round_clip")
    for label, (ps, m) in cases.items():
        n = len(ps)
        inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        dcs, offs, rng8 = [128] * n, [128.0] * n, [(0, 255)] * n
        tr.mct_inv_round_clip(tr.dc_mct_fwd(ps, dcs, m), inv, offs, rng8)  # caches the matrices
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        n0 = [kernels.KERNELS[k].launches for k in names]
        fwd = tr.dc_mct_fwd(ps, dcs, m)
        back = tr.mct_inv_round_clip(fwd, inv, offs, rng8)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs
        launches = [kernels.KERNELS[k].launches - c for k, c in zip(names, n0)]
        on = ps if ps[0].numel() > 1 << 20 else [p.cpu() for p in ps]
        f_on = fwd if on is ps else [f.cpu() for f in fwd]
        equal = all(torch.equal(a.view(torch.int32).to(b.device), b.view(torch.int32))
                    for a, b in zip(fwd, tr.dc_mct_fwd_plain(on, dcs, m))) and all(
            torch.equal(a.to(b.device), b)
            for a, b in zip(back, tr.mct_inv_round_clip_plain(f_on, inv, offs, rng8)))
        aligned = all(f.data_ptr() % 16 == ps[0].data_ptr() % 16 for f in fwd)
        out[label] = dict(ok=equal and aligned and launches == [1, 1] and allocs == 2 * n,
                          equal=equal, launches_a_call=launches, allocations_a_call=allocs,
                          outputs_aligned_as_input=aligned)
    return out


def golden_md5(planes) -> str:
    """The corpus's digest recipe (tests/conftest.py golden_md5): md5 over
    each component plane as contiguous int32 bytes + str(shape), in
    component order."""
    h = hashlib.md5()
    for a in planes:
        a = np.ascontiguousarray(np.asarray(a).astype(np.int32))
        h.update(a.tobytes())
        h.update(str(a.shape).encode())
    return h.hexdigest()


def cut_streams(gt, device=None):
    """The truncated phase's inputs: a 40x40x3 random image with 24x24
    tiles and 3 resolutions, Part-1 and HT, cut to CUTS of its length."""
    arr = np.random.default_rng(0).integers(0, 256, (40, 40, 3)).astype(np.int32)
    out = []
    for ht in (False, True):
        s = gt.compress(gt.Image.from_array(arr),
                        gt.CompressParams(tile_size=(24, 24), num_resolutions=3, ht=ht),
                        device=device)
        out += [(f"{'ht' if ht else 'part1'} {frac}", s[:int(len(s) * frac)]) for frac in CUTS]
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest_ok(stream: bytes, key: str) -> tuple[str, bool]:
    """SHA-256 of a stream and whether it and its length are grok_tpu's."""
    sha = hashlib.sha256(stream).hexdigest()
    return sha, (len(stream), sha) == REF_SHA256[key]


def time_turns(fns, reps, event, sync, before):
    """Per-launch times of each function of ``fns``, in turns: fns[0],
    fns[1], ... and then backwards (kernel, library, library, kernel, ...),
    ``reps`` rounds after one warm-up launch of each. ``before()`` runs
    ahead of every launch, outside its event pair; ``event()`` makes an
    event with ``record()`` and ``elapsed_time(other)`` in ms; ``sync()``
    waits for the device. Returns, for each function, the median, the
    least and the largest of its times and their count."""
    for fn in fns:
        fn()
    sync()
    pairs = [[] for _ in fns]
    for i in range(reps):
        for j in (range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))):
            before()
            a, b = event(), event()
            a.record()
            fns[j]()
            b.record()
            pairs[j].append((a, b))
    sync()
    out = []
    for ps in pairs:
        t = sorted(a.elapsed_time(b) for a, b in ps)
        mid = (t[(len(t) - 1) // 2] + t[len(t) // 2]) / 2
        out.append({"ms": mid, "min": t[0], "max": t[-1], "n": len(t)})
    return out


class KernelTimer:
    """``time_turns`` on the card, REPS rounds. Warm: each launch finds the
    data as the launch before left it, in the L2 cache where it fits, as
    the path finds what the kernel before wrote. Cold: before each launch
    FLUSH_BYTES are overwritten and another FLUSH_BYTES read, so the L2
    holds none of the launch's data and only clean lines: the launch reads
    its inputs from HBM and evicts nothing dirty (its own writes may stay
    in the L2). Either way a spin of LEAD_CYCLES runs ahead
    of each launch, so the host has queued the launch before the card
    reaches its first event: the pair times the device, not the host."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.dirty = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        self.clean = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def turns(self, fns, cold=False):
        def before():
            if cold:
                self.dirty.fill_(1)
                self.clean.sum()
            self.torch.cuda._sleep(LEAD_CYCLES)
        return time_turns(fns, REPS, lambda: self.torch.cuda.Event(enable_timing=True),
                          self.torch.cuda.synchronize, before)

    def warm(self, fn):
        """fn's warm median, ms."""
        return self.turns([fn])[0]["ms"]

    def row(self, fn, lib=None, cold=False, bytes_=0):
        """The times of a kernel's row: fn's warm median, least and largest
        (ms, ms_min, ms_max), the library call ``lib``'s in turns with it
        (library_ms ...; None without one), and, where ``cold`` asks or a
        warm median is under the HBM time of ``bytes_``, the same cold
        (cold_ms ..., library_cold_ms ...)."""
        fns = [fn] if lib is None else [fn, lib]
        out = {"library_ms": None}
        warm = self.turns(fns)
        for pre, t in zip(("", "library_"), warm):
            out.update({f"{pre}ms": t["ms"], f"{pre}ms_min": t["min"], f"{pre}ms_max": t["max"]})
        if cold or min(t["ms"] for t in warm) < bytes_ / HBM_BYTES_PER_S * 1e3:
            for pre, t in zip(("cold_", "library_cold_"), self.turns(fns, cold=True)):
                out.update({f"{pre}ms": t["ms"], f"{pre}ms_min": t["min"],
                            f"{pre}ms_max": t["max"]})
        return out


def bound_shares(s, bytes_ms):
    """For each of a row's times (warm and cold, kernel and library): "l2"
    True where it is under the HBM time of the row's bytes (it cannot have
    come from HBM), else False and its share of the row's bound."""
    out = {}
    for pre in ("", "library_", "cold_", "library_cold_"):
        v = s.get(f"{pre}ms")
        if v is None:
            continue
        out[f"{pre}l2"] = v < bytes_ms
        if v >= bytes_ms:
            out[f"{pre}x_bound"] = v / s["bound_ms"]
    return out


def pack_forms(torch, timer, k6, x_i, x_f, rows_of):
    """K-v's forms on one sub-block: the one-pass form at each band whose
    rows fit shared memory, and the two-pass form (the one a sub-block
    taller than 7,264 rows takes), each equal to the plain version on int32
    and float32 bits, then timed in turns with each other and with
    index_select of the row permutation, warm and cold."""
    h, w = x_i.shape
    forms = [k6.PackForm("smem", b, -(-w // b)) for b in (8, 16, 32)
             if h * b * 4 <= k6.SMEM_BYTES] + [k6.PackForm("two_pass", 0, 0)]
    for unpack, plain in ((False, k6.strip_pack_v_plain), (True, k6.strip_unpack_v_plain)):
        name = "strip_unpack_v" if unpack else "strip_pack_v"
        equal = []
        for f in forms:
            ok = True
            for x in (x_i, x_f):
                got, ref = x.clone(), x.clone()
                k6.launch_pack(got, h, w, f, unpack)
                plain(ref, h, w)
                ok = ok and torch.equal(got.view(torch.int32), ref.view(torch.int32))
            equal.append(ok)
        scratch = x_i.clone()
        fns = [lambda f=f: k6.launch_pack(scratch, h, w, f, unpack) for f in forms]
        fns.append(lambda: scratch.index_select(0, rows_of[unpack]))
        warm, cold = timer.turns(fns), timer.turns(fns, cold=True)
        labels = [f"{f.form} {f.band}" if f.band else f.form for f in forms] + ["index_select"]
        emit({"phase": "check_forms", "kernel": name, "shape": f"int32 {h}x{w}",
              "chosen": list(k6.pack_form(h, w)), "bytes": 8 * h * w,
              "times": {lab: {"warm": a, "cold": b, "equal": e}
                        for lab, a, b, e in zip(labels, warm, cold, equal + [None])}})
        if not all(equal):
            raise AssertionError(f"{name}: a form differs from the plain version: "
                                 f"{dict(zip(labels, equal))}")


def long_lines(torch, tr, kernels, timer, same_bits, dev):
    """The four horizontal halves on a 2 x 65,536 plane in each form: the
    "scratch" form through the wrappers (the form they take at this
    length) on whole lines, the "smem" form through ``tr.launch_h`` on the
    first MAX_LINE samples of each line; both parities, each equal to its
    plain version on the bits and counted in its form; parity 0 timed warm."""
    h, w = 2, LONG_STRIP[1]
    rng = np.random.default_rng(7)
    x_i = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, (h, w)).astype(np.int32)).to(dev)
    x_f = torch.from_numpy((rng.standard_normal((h, w)) * 300).astype(np.float32)).to(dev)
    rows = {}
    for name, x in (("dwt53_fwd_h", x_i), ("dwt53_inv_h", x_i), ("dwt97_fwd_h", x_f),
                    ("dwt97_inv_h", x_f)):
        k, plain = kernels.KERNELS[name], getattr(tr, f"{name}_plain")
        for form, width in (("scratch", w), ("smem", tr.MAX_LINE)):
            def run(y, px, form=form, width=width, name=name):
                if form == tr.h_form(name, width, h, tr.sm_count(dev)):
                    getattr(tr, name)(y, h, width, px)
                else:
                    tr.launch_h(name, [y], h, width, px, form)
            equal = True
            for px in (0, 1):
                got, ref = x.clone(), x.clone()
                before = k.forms.get(form, 0)
                run(got, px)
                plain(ref, h, width, px)
                equal = equal and same_bits(got, ref) and k.forms[form] == before + 1
            scratch = x.clone()
            rows[f"{name} {form}"] = dict(width=width, equal=equal,
                                          ms=timer.warm(lambda run=run: run(scratch, 0)))
    emit({"phase": "check_long_lines", "shape": f"{h}x{w}", "forms": rows})
    if not all(r["equal"] for r in rows.values()):
        raise AssertionError(f"a horizontal half's form differs from its plain version: {rows}")


def form_choice(torch, tr, timer, same_bits, dev):
    """Both forms of each horizontal half on each LONG_GROUPS launch (n
    planes of h x w), parity 0, each equal to the plain version on the
    bits, timed in turns, warm, beside the form transform.h_form picks for
    that launch: the measurement behind its rule."""
    rng = np.random.default_rng(9)
    sms, out = tr.sm_count(dev), []
    for n, h, w in LONG_GROUPS:
        for name in ("dwt53_fwd_h", "dwt53_inv_h", "dwt97_fwd_h", "dwt97_inv_h"):
            if name.startswith("dwt53"):
                x = [torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, (h, w)).astype(np.int32))
                     .to(dev) for _ in range(n)]
            else:
                x = [torch.from_numpy((rng.standard_normal((h, w)) * 300).astype(np.float32))
                     .to(dev) for _ in range(n)]
            plain = getattr(tr, f"{name}_plain")
            refs = [t.clone() for t in x]
            for r in refs:
                plain(r, h, w, 0)
            equal = True
            for form in tr.H_FORMS:
                got = [t.clone() for t in x]
                tr.launch_h(name, got, h, w, 0, form)
                equal = equal and all(map(same_bits, got, refs))
            fns = [lambda form=form, name=name: tr.launch_h(name, x, h, w, 0, form)
                   for form in tr.H_FORMS]
            times = timer.turns(fns)
            out.append(dict(half=name, planes=n, rows=h, width=w, equal=equal,
                            lines_a_launch=tr.h_lines(x, h), sms=sms,
                            picked=tr.h_form(name, w, tr.h_lines(x, h), sms),
                            **{f: t["ms"] for f, t in zip(tr.H_FORMS, times)}))
            del x, refs
    emit({"phase": "check_form_choice", "launches": out})
    if not all(r["equal"] for r in out):
        raise AssertionError(f"a horizontal half's form differs from its plain version: {out}")


def cuda_ms(torch, fn, reps=5):
    """A plain version's time: mean device ms of fn over reps launches back
    to back, after a warm-up (plain versions are no yardstick of speed)."""
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


def chain_times(torch, fn, reps=REPS):
    """A chain of launches as a request stage runs it: from a synchronised
    start, the host's ms until fn returns (its enqueue), the wall ms until
    the card is done, and the card's ms between events around it (the
    medians of reps runs after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    host, wall, dev = [], [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    return {k: sorted(v)[len(v) // 2] for k, v in
            (("host_enqueue_ms", host), ("wall_ms", wall), ("device_ms", dev))}


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


def ptxas(stem):
    """What ``-Xptxas -v`` reported for csrc/<stem>.cu: each function it
    compiled, its registers and spills."""
    from grok_tpu_torch import kernels

    log = kernels.BUILD_DIR / f"{stem}.log"
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln] \
        if log.exists() else []


def level_figures(torch, tr, kernels, timer, name, occupancy, tile, plane, lv4k, run_levels):
    """The figures of a wavelet kernel that runs one launch a level (K-b,
    K-g, K-k, K-n, kernel ``name`` of csrc/<stem>.cu): its launch (threads,
    shared bytes and blocks resident an SM from the C entry ``occupancy``,
    the waves of each 4K level at ``tile`` (rows, columns) a block), each
    level ``lv4k`` of ``plane`` alone by the C entry, a 1024x1024 tile's
    five levels through ``run_levels`` (as the distributed paths run a
    tile) and whether they equal the plain version's on the CPU, and
    ptxas."""
    stem = kernels.KERNELS[name].source.rsplit(".", 1)[0]
    threads, smem, blocks = c_ints(kernels, f"{stem}.cu", occupancy)
    sms = torch.cuda.get_device_properties(plane.device).multi_processor_count
    out = torch.empty_like(plane)
    launch = tr.level_launcher(name, plane.device)
    fwd = name in ("dwt53_fwd_level", "dwt97_fwd_level")  # a forward's LL quadrant: an output

    def level_c(lv):
        return lambda: launch(plane, out if fwd else plane, out, *lv)
    tile1k = plane[:1024, :1024].contiguous()
    lv1k = [(1024 >> k, 1024 >> k, 0, 0) for k in range(5)]
    if not fwd:
        lv1k.reverse()
    got = run_levels(tile1k, lv1k).cpu()
    ref = run_levels(tile1k.cpu(), lv1k)
    return dict(
        launch=dict(threads_a_block=threads, shared_bytes_a_block=smem, blocks_per_sm=blocks,
                    waves_4k_levels=[-(-(-(-h // tile[0]) * -(-w // tile[1])) // (blocks * sms))
                                     for h, w, _, _ in lv4k]),
        levels_4k_ms={f"{lv[0]}x{lv[1]}": timer.warm(level_c(lv)) for lv in lv4k},
        tile_1024_ms=timer.warm(lambda: run_levels(tile1k, lv1k)),
        tile_1024_equal=torch.equal(got.view(torch.int32), ref.view(torch.int32)),
        ptxas=ptxas(stem))


def c_ints(kernels, source, entry, *args, outs=3):
    """The int outputs of a C entry of csrc/<source> that takes ``args``
    (ints) and then ``outs`` int pointers (an occupancy query)."""
    import ctypes

    fn = getattr(kernels.library(source), entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * outs
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(outs)]
    rc = fn(*args, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return [v.value for v in vals]


def kp_regimes(kernels, nbs, bh, bw):
    """K-p's passes of codeblocks with numbps ``nbs`` (bh x bw): how many
    sum as an exact int64 reduction and how many take the ordered float64
    chain (the kernel's own bound, its C entry ebcot_dist_exact)."""
    exact = kernels.library("ebcot_dist.cu").ebcot_dist_exact
    npos = -(-bh // 4) * 4 * bw
    nbs = np.asarray(nbs, dtype=np.int64)
    out = {"reduction": 0, "ordered_chain": 0}
    for p in range(int(nbs.max(initial=0))):
        passes = int((nbs - 1 == p).sum()) + 3 * int((nbs - 1 > p).sum())
        out["reduction" if exact(p, npos) else "ordered_chain"] += passes
    return out


def ke_figures(torch, hc, kernels, timer, batch, h32, w32, htab, mmax, ref):
    """K-e's figures beside its time on a batch: the C entry alone (its
    buffers allocated once: no memset, no synchronisation) in turns with
    the wrapper, its output held to ``ref`` (the wrapper's segments and
    lengths); the quads, MEL events and stuffed bytes of each stream (the
    kernel's stats output: MagSgn bytes 0xFF, VLC bytes of 7 bits after
    one above 0x8F); the launch (warps a block, shared bytes and blocks an
    SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor, codeblocks
    resident an SM, waves); ptxas registers and spills."""
    n, bh, bw = batch.shape
    dev = batch.device
    cap, aux = hc.segment_capacity(bh, bw, mmax)
    out = torch.empty((n, cap), dtype=torch.uint8, device=dev)
    scratch = torch.empty((n, aux), dtype=torch.uint8, device=dev)
    lengths = torch.empty(n, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = hc.ENC_WARPS
    kernel, stream = kernels.KERNELS["ht_cleanup_enc"], kernels.stream_ptr(dev)

    def c_entry(stats=None):
        kernel.call(batch.data_ptr(), h32.data_ptr(), w32.data_ptr(), htab.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), lengths.data_ptr(), None, n, bh, bw,
                    cap, aux, warps, stats, stream)
    entry, wrapper = timer.turns([c_entry, lambda: hc.ht_cleanup_enc(batch, h32, w32, htab,
                                                                      mmax)])
    entry_equal = torch.equal(out, ref[0]) and torch.equal(lengths.to(torch.int64), ref[1])
    stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    c_entry(stats=stats.data_ptr())
    mel, st_ms, st_vl = stats.sum(0).tolist()
    blocks, smem = hc.enc_occupancy(bw, warps)
    quads = int((((h32 + 1) // 2).to(torch.int64) * ((w32 + 1) // 2)).sum())
    return dict(
        c_entry_ms=entry["ms"], c_entry_ms_min=entry["min"], c_entry_ms_max=entry["max"],
        c_entry_equal=entry_equal, wrapper_in_turns_ms=wrapper["ms"], quads=quads,
        mel_events=mel, stuffed_bytes={"magsgn": st_ms, "vlc": st_vl},
        launch=dict(warps_a_block=warps, shared_bytes_a_block=smem, blocks_per_sm=blocks,
                    resident_per_sm=blocks * warps,
                    waves=-(-n // max(blocks * warps * sms, 1))),
        ptxas=ptxas("ht_enc"))


def kf_figures(torch, hc, kernels, timer, data, lens, h32, w32, htab, bh, bw, ref):
    """K-f's figures beside its time on a batch: the C entry alone (its
    buffers allocated once, no synchronisation) in turns with the wrapper,
    its output held to ``ref`` (the batch, no codeblock stopped); the
    launch (warps a block, shared bytes and blocks an SM from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, codeblocks resident an
    SM, waves); ptxas registers and spills."""
    n, L = data.shape
    dev = data.device
    out = torch.empty((n, bh, bw), dtype=torch.int32, device=dev)
    stopped = torch.empty(n, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernel, stream = kernels.KERNELS["ht_cleanup_dec"], kernels.stream_ptr(dev)
    args = (data.data_ptr(), lens.data_ptr(), h32.data_ptr(), w32.data_ptr(), htab.data_ptr())

    def c_entry():
        kernel.call(*args, out.data_ptr(), stopped.data_ptr(), n, L, bh, bw, stream)

    def wrapper():
        hc.ht_cleanup_dec(data, lens, h32, w32, htab, bh, bw)
    times = timer.turns([c_entry, wrapper])
    return dict(
        c_entry_ms=times[0]["ms"], c_entry_ms_min=times[0]["min"],
        c_entry_ms_max=times[0]["max"],
        c_entry_equal=torch.equal(out, ref) and not bool(stopped.any()),
        wrapper_in_turns_ms=times[1]["ms"],
        quads=int((((h32 + 1) // 2).to(torch.int64) * ((w32 + 1) // 2)).sum()),
        launch=kf_launch(hc, n, bw, sms), ptxas=ptxas("ht_dec"))


def kf_launch(hc, n, bw, sms):
    """A K-f launch of n codeblocks: warps and codeblocks a block, shared
    bytes and blocks resident an SM (cudaOccupancyMaxActiveBlocksPer
    Multiprocessor), codeblocks on the busiest SM with the blocks dealt in
    turn, and the waves that take."""
    blocks, smem = hc.dec_occupancy(bw)
    per_block = hc.DEC_GROUPS * hc.DEC_WARPS
    blocks_all = -(-n // per_block)
    per_sm = -(-blocks_all // sms)  # blocks on the busiest SM
    return dict(warps_a_block=hc.DEC_WARPS, codeblocks_a_block=per_block,
                shared_bytes_a_block=smem, blocks_per_sm=blocks,
                resident_per_sm=blocks * per_block, busiest_sm_codeblocks=per_sm * per_block,
                waves=-(-per_sm // max(blocks, 1)))


KE_WARPS = (1, 2, 4, 8, 16)


def ke_warps(torch, gt, hc, kernels, dev, smi) -> int:
    """``--ke-warps``: K-e's C entry in turns at each of KE_WARPS warps a
    block, on the first launch of compress(ht=True) at 256x256x3 (the size
    of the slice phases) and at W x H x NC (the 4K batch); each launch's
    segments and lengths held to the wrapper's on the path."""
    timer = KernelTimer(torch, dev)
    launch, calls = hc.ht_cleanup_enc, []

    def keep(*args, **kw):
        out = launch(*args, **kw)
        calls.append((args, out))
        return out

    firsts = []
    hc.ht_cleanup_enc = keep
    try:
        for h, w in ((256, 256), (H, W)):
            firsts.append(len(calls))
            gt.compress(gt.Image.from_array(natural_image(h, w, NC)),
                        gt.CompressParams(num_resolutions=6, ht=True))
    finally:
        hc.ht_cleanup_enc = launch
    kernel, stream = kernels.KERNELS["ht_cleanup_enc"], kernels.stream_ptr(dev)
    for image, first in zip(("256x256x3", f"{W}x{H}x{NC}"), firsts):
        (coeffs, hs, ws, tab, mmax), ref = calls[first][0][:5], calls[first][1]
        n, bh, bw = coeffs.shape
        cap, aux = hc.segment_capacity(bh, bw, mmax)
        bufs = {wp: (torch.empty((n, cap), dtype=torch.uint8, device=dev),
                     torch.empty((n, aux), dtype=torch.uint8, device=dev),
                     torch.empty(n, dtype=torch.int32, device=dev)) for wp in KE_WARPS}

        def entry(wp):
            out, scratch, lengths = bufs[wp]
            kernel.call(coeffs.data_ptr(), hs.data_ptr(), ws.data_ptr(), tab.data_ptr(),
                        out.data_ptr(), scratch.data_ptr(), lengths.data_ptr(), None, n, bh,
                        bw, cap, aux, wp, None, stream)
        times = timer.turns([lambda wp=wp: entry(wp) for wp in KE_WARPS])
        equal = all(torch.equal(o, ref[0]) and torch.equal(ln.to(torch.int64), ref[1])
                    for o, _, ln in bufs.values())
        emit({"phase": "ke_warps", "image": image, "codeblocks": n, "shape": f"{bh}x{bw}",
              "launches_in_encode": (firsts + [len(calls)])[firsts.index(first) + 1] - first,
              "equal": equal, **{f"warps_{wp}": t for wp, t in zip(KE_WARPS, times)}})
        if not equal:
            raise AssertionError(f"ke_warps {image}: a launch differs from the wrapper's")
    print(smi, flush=True)
    return 0


def ki_chain(ec, t_ms, lanes, valid):
    """K-i's chain figures beside a batch's time ``t_ms``: the decisions
    (K-c's valid records, ``valid`` per codeblock), the longest chain, the
    ns a decision of it; and, where the package has it (not the parent
    tree's), the launch plan of ``lanes``: codeblocks resident per SM,
    waves, longest first or not."""
    out = dict(decisions=int(valid.sum()), longest_chain=int(valid.max()),
               ns_per_decision_longest=t_ms * 1e6 / int(valid.max()))
    if hasattr(ec, "dec_launch_plan"):
        plan = ec.dec_launch_plan(lanes)
        out["plan"] = dict(
            warps_a_block=plan.layout.warps, warp_bytes=plan.layout.warp_bytes,
            blocks_per_sm=plan.blocks_per_sm,
            resident_per_sm=plan.blocks_per_sm * plan.layout.warps, waves=plan.waves,
            longest_first=plan.order is not None)
    return out


def tile_dec_batch(torch, gt, ec, arr, mesh):
    """The first K-i launch of DIST53's decode: the 4K image through
    compress_distributed (held to its pinned digest) and back through
    decompress_distributed (held to the image, exactly), with a hook on
    the wrapper that keeps the first call's arguments and result. Returns
    the arguments, the result, its extents, its bytes bound and each
    codeblock's decisions (K-c's valid records of the decoded
    coefficients)."""
    stream = gt.compress_distributed(gt.Image.from_array(arr), gt.CompressParams(**DIST53),
                                     mesh=mesh)
    if not digest_ok(stream, f"dist53 {H}x{W}x{NC}")[1]:
        raise AssertionError("dist53 stream is not grok_tpu's")
    calls = []
    launch = ec.ebcot_decode

    def first(*args):
        out = launch(*args)
        if not calls:
            calls.append((args, out))
        return out

    ec.ebcot_decode = first
    try:
        back = gt.decompress_distributed(stream, mesh=mesh)
    finally:
        ec.ebcot_decode = launch
    if not all(np.array_equal(c.data, arr[:, :, k]) for k, c in enumerate(back.components)):
        raise AssertionError("dist53 decode is not the image")
    (data, starts, lanes, seg, ctx, mq, bh, bw), out = calls[0]
    n = lanes.shape[1]
    pmax = int(lanes[0].max())
    sym_lanes = torch.stack([lanes[0], lanes[2], lanes[3], lanes[4],
                             lanes[5] & 0x3F]).contiguous()
    sym = ec.ebcot_symbols(out, sym_lanes, ctx, -(-pmax // 4) * 4)
    valid = (sym >= 0x80).reshape(n, -1).sum(1)
    samples = int((lanes[2].to(torch.int64) * lanes[3]).sum())
    return dict(args=[data, starts, lanes, seg, ctx, mq], out=out, bh=bh, bw=bw, valid=valid,
                bytes=int(lanes[6].to(torch.int64).sum()) + samples * 4 + n * (7 * 4 + 8),
                n=n, samples=samples)


def _device(torch):
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def tile_batch(arr):
    """The 4K tile batch of make_sharded_transform, int32 [8, 3, 1024, 960]."""
    ty, tx, th, tw = TILE_BATCH
    return np.stack([arr[r * th:(r + 1) * th, c * tw:(c + 1) * tw].transpose(2, 0, 1)
                     for r in range(ty) for c in range(tx)]).astype(np.int32)


def k6_phases(torch, mesh, dev, arr, x_strip, tiles8, lap):
    """slice_dist, e2e_dist, e2e_frames and slice_strip over ``mesh``;
    returns the main-path launches of K-w, K-u, K-v and the horizontal
    halves, and K-v's launches by form on the strip path."""
    import grok_tpu_torch as gt
    from grok_tpu_torch import kernels
    from grok_tpu_torch.codestream.compress import build_siz, build_tcp, encode_tile_to_blob
    from grok_tpu_torch.core.rect import Rect
    from grok_tpu_torch.ops import transform as tr
    from grok_tpu_torch.parallel import mesh as pm

    def same_bits(a, b):
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
        return torch.equal(a, b)

    _, _, th, tw = TILE_BATCH
    # ---- 8d. K6 over the mesh. slice_dist: 256x256x3 through the three
    # distributed entry points, against the port's own compress and
    # decompress on the card, at 64x64 tiles and the odd-parity 37x37
    gt.reset_launch_counts()
    small_img = natural_image(256, 256, 3)
    frames_small = [natural_image(256, 256, 3, seed=s) for s in (3, 4, 5)]
    for name, kw in DIST_CASES.items():
        t0 = time.perf_counter()
        one = gt.compress(gt.Image.from_array(small_img), gt.CompressParams(**kw))
        t1 = time.perf_counter()
        dist = gt.compress_distributed(gt.Image.from_array(small_img), gt.CompressParams(**kw),
                                       mesh=mesh)
        t2 = time.perf_counter()
        d_one = gt.decompress(one)
        d_dist = gt.decompress_distributed(one, mesh=mesh)
        t3 = time.perf_counter()
        dec_same = all(np.array_equal(a.data, b.data)
                       for a, b in zip(d_one.components, d_dist.components))
        frames_same = None
        if kw["tile_size"] == (64, 64):  # frames are single-tile: once per coding
            fkw = dict(kw, tile_size=None)
            outs = gt.compress_frames([gt.Image.from_array(a) for a in frames_small],
                                      gt.CompressParams(**fkw), mesh=mesh)
            frames_same = all(o == gt.compress(gt.Image.from_array(a), gt.CompressParams(**fkw))
                              for o, a in zip(outs, frames_small))
        emit({"phase": "slice_dist", "case": name, "params": kw, "image": "256x256x3",
              "identical": dist == one, "decode_equal": dec_same, "frames_identical": frames_same,
              "bytes": len(one), "compress_ms": (t1 - t0) * 1e3, "dist_ms": (t2 - t1) * 1e3,
              "decode_ms": (t3 - t2) * 1e3})
        if dist != one or not dec_same or frames_same is False:
            raise AssertionError(f"slice_dist {name}: a distributed stream or decode differs "
                                 "from the port's compress or decompress")
    sd_counts = gt.launch_counts()
    emit({"phase": "slice_dist_launches", "launches": sd_counts})

    lap("slice_dist")

    # e2e_dist: the 4K image at BASELINE config 4's tile size through
    # compress_distributed and decompress_distributed, three requests each,
    # lossless53 and lossy97; then make_sharded_transform on the 4K tile
    # batch (K-w's launches)
    gt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for tag, kw in (("dist53", DIST53), ("dist97", DIST97)):
        streams = []
        for i in range(3):
            stage = {}
            img = gt.Image.from_array(arr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gt.compress_distributed(img, gt.CompressParams(**kw), mesh=mesh, stage_ms=stage)
            torch.cuda.synchronize()
            e2e = (time.perf_counter() - t0) * 1e3
            sha, ref_ok = digest_ok(out, f"{tag} {H}x{W}x{NC}")
            emit({"phase": "e2e_dist", "case": tag, "op": "encode", "request": i, "e2e_ms": e2e,
                  "mp_per_s": W * H / 1e6 / (e2e / 1e3), "bytes": len(out), "sha256": sha,
                  "reference_digest": ref_ok, "stage_ms": stage})
            if not ref_ok:
                raise AssertionError(f"e2e_dist {tag} request {i}: not grok_tpu's stream")
            streams.append(out)
        for i, stream in enumerate(streams):
            stage = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = gt.decompress_distributed(stream, mesh=mesh, stage_ms=stage)
            torch.cuda.synchronize()
            e2e = (time.perf_counter() - t0) * 1e3
            planes_out = [c.data for c in back.components]
            if tag == "dist97":
                md5 = golden_md5(planes_out)
                ok, check = md5 == REF_MD5[f"{tag} {H}x{W}x{NC}"], {"decode_md5": md5}
            else:
                ok = all(np.array_equal(a, arr[:, :, k]) for k, a in enumerate(planes_out))
                check = {"exact": ok}
            emit({"phase": "e2e_dist", "case": tag, "op": "decode", "request": i, "e2e_ms": e2e,
                  "mp_per_s": W * H / 1e6 / (e2e / 1e3), **check, "stage_ms": stage})
            if not ok:
                raise AssertionError(f"e2e_dist {tag} decode {i}: not grok_tpu's decode")
        del streams
    t0 = time.perf_counter()
    packed8, bmax8, dist8 = gt.make_sharded_transform(mesh, 5)(tiles8)
    torch.cuda.synchronize()
    st_ms = (time.perf_counter() - t0) * 1e3
    rect8 = Rect(0, 0, tw, th)
    one8 = [torch.stack(tr.forward_transform(
        [torch.from_numpy(np.ascontiguousarray(t[c])).to(dev) for c in range(3)],
        [rect8] * 3, [5] * 3, [128] * 3, True)) for t in tiles8]
    st_ok = (torch.equal(packed8, torch.stack(one8))
             and float(dist8) == float(np.float32(
                 sum(int((p.to(torch.int64) ** 2).sum()) for p in one8))))
    e2e_dist_counts = gt.launch_counts()
    emit({"phase": "e2e_dist_sharded_transform", "batch": list(tiles8.shape),
          "equal_to_unsharded": st_ok, "dist": float(dist8), "ms": st_ms,
          "blk_max_max": int(bmax8.max())})
    emit({"phase": "e2e_dist_launches", "image": f"{W}x{H}x{NC}", "requests": 3,
          "launches": e2e_dist_counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not st_ok:
        raise AssertionError("make_sharded_transform differs from the unsharded transform")
    if any(e2e_dist_counts[k] <= 0 for k in DIST_KERNELS + K97_KERNELS):
        raise AssertionError(f"a kernel of the distributed path never launched: {e2e_dist_counts}")
    got = {"blk_stats": e2e_dist_counts["blk_stats"]}
    del packed8, one8

    lap("e2e_dist")

    # e2e_frames: compress_frames of four 4K frames (lossy97), frame 0 the
    # pinned 4K lossy97 stream, the others the port's compress of each
    gt.reset_launch_counts()
    frames = [arr] + [natural_image(H, W, NC, seed=s) for s in FRAME_SEEDS[1:]]
    batch_ms = []
    for rep in range(2):
        stage = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = gt.compress_frames([gt.Image.from_array(a) for a in frames],
                                  gt.CompressParams(**P97), mesh=mesh, stage_ms=stage)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "e2e_frames", "rep": rep, "frames": len(frames), "batch_ms": batch_ms[-1],
              "mp_per_s": len(frames) * W * H / 1e6 / (batch_ms[-1] / 1e3), "stage_ms": stage})
    sha0, ok0 = digest_ok(outs[0], f"97 {H}x{W}x{NC}")
    same = [o == gt.compress(gt.Image.from_array(a), gt.CompressParams(**P97))
            for o, a in zip(outs[1:], frames[1:])]
    emit({"phase": "e2e_frames_check", "frame0_sha256": sha0, "frame0_reference_digest": ok0,
          "others_equal_compress": same, "launches": gt.launch_counts()})
    if not ok0 or not all(same):
        raise AssertionError("e2e_frames: a frame's stream is not the one-shot stream")
    del frames, outs

    lap("e2e_frames")

    # slice_strip: the 4096x4096 plane over the mesh, 5 levels; 5/3 through
    # the bridge equal to K-b unsharded and back exactly, 9/7 equal to K-k
    # unsharded on the float32 bits; the bridged 5/3 coefficients of the
    # one-component image encoded by encode_tile_to_blob inside the port's
    # compress of that image
    gt.reset_launch_counts()
    pm.reset_halo_copies()
    strip = {}
    for irrev in (False, True):
        x = torch.from_numpy(x_strip).to(dev).to(torch.float32 if irrev else torch.int32)
        tag = "97" if irrev else "53"
        strip[tag], bridged = strip_round_trip(torch, mesh, x, STRIP_LEVELS, irrev, same_bits)
        if not irrev:
            coeffs53 = bridged
        del bridged
    one_img = gt.Image.from_array(x_strip + 128)
    one_img.finalize()
    p6 = gt.CompressParams(num_resolutions=STRIP_LEVELS + 1)
    t0 = time.perf_counter()
    blob = encode_tile_to_blob(build_siz(one_img, p6), build_tcp(one_img, p6), 0, None,
                               coeffs=[coeffs53])
    t1 = time.perf_counter()
    strip_stream = gt.compress(gt.Image.from_array(x_strip + 128), p6)
    strip_counts = gt.launch_counts()
    strip_forms = kernels.form_counts()
    emit({"phase": "slice_strip", "plane": f"{STRIP}x{STRIP}", "levels": STRIP_LEVELS,
          "mesh": [str(d) for d in mesh.devices], "virtual": mesh.virtual, **strip,
          "halo_copies": pm.halo_copies(), "blob_bytes": len(blob),
          "blob_in_compress_stream": blob in strip_stream, "encode_ms": (t1 - t0) * 1e3,
          "launches": strip_counts, "forms": strip_forms})
    if not (round_trips_hold(strip) and blob in strip_stream):
        raise AssertionError(f"slice_strip: {strip}, blob in stream {blob in strip_stream}")
    if any(strip_counts[k] <= 0 for k in STRIP_KERNELS):
        raise AssertionError(f"a kernel of the strip path never launched: {strip_counts}")
    per_pass = STRIP_LEVELS * len(set(mesh.devices))  # a launch a level a card
    halves = ("dwt53_fwd_h", "dwt53_inv_h", "dwt97_fwd_h", "dwt97_inv_h")
    if any(strip_counts[k] != per_pass for k in halves):
        raise AssertionError(f"slice_strip: the horizontal halves launched {strip_counts} "
                             f"times, not {per_pass} each")
    got.update({k: strip_counts[k] for k in STRIP_KERNELS})
    del coeffs53, blob, strip_stream

    long_strip(torch, mesh, dev, same_bits)

    lap("slice_strip")
    return got, strip_forms


def strip_round_trip(torch, mesh, x, levels, irrev, same_bits):
    """The strip wavelet of plane ``x`` over ``mesh``, 9/7 or 5/3: the host
    ms (synchronised) of the forward, the bridge and the inverse; whether
    the bridged forward equals K-k or K-b unsharded and the inverse the
    unsharded K-n or K-g inverse of that, on the bits; the inverse's largest
    error against x. Returns those and the bridged coefficients."""
    import grok_tpu_torch as gt
    from grok_tpu_torch.ops import transform as tr
    from grok_tpu_torch.parallel import mesh as pm

    h, w = x.shape
    _, inv = gt.make_sharded_strip_dwt(mesh, levels, irreversible=irrev)
    shards = pm.split_rows(x, mesh, x.dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards = pm.sharded_dwt97_forward(shards, levels) if irrev else \
        pm.sharded_dwt53_forward(shards, levels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bridged = pm.strip_to_mallat(pm.join_rows(shards), len(mesh), levels)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    back = pm.join_rows(inv(shards))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ref = x.clone()
    for lvl in range(levels):
        (tr.dwt97_fwd_level if irrev else tr.dwt53_fwd_level)(ref, h >> lvl, w >> lvl, 0, 0)
    fwd_same = same_bits(bridged, ref)
    for lvl in range(levels, 0, -1):
        (tr.dwt97_inv_level if irrev else tr.dwt53_inv_level)(
            ref, h >> (lvl - 1), w >> (lvl - 1), 0, 0)
    return dict(forward_ms=(t1 - t0) * 1e3, bridge_ms=(t2 - t1) * 1e3,
                inverse_ms=(t3 - t2) * 1e3, equal_unsharded=fwd_same,
                inverse_equal_unsharded=same_bits(back, ref),
                inverse_max_abs_err=float((back.double() - x.double()).abs().max())), bridged


def round_trips_hold(res) -> bool:
    """strip_round_trip's results hold: equal to the unsharded levels both
    ways, the 5/3 inverse exact and the 9/7 one within the reference's own
    bound (tests/test_parallel.py's 1e-3)."""
    return (all(r["equal_unsharded"] and r["inverse_equal_unsharded"] for r in res.values())
            and res["53"]["inverse_max_abs_err"] == 0 and res["97"]["inverse_max_abs_err"] < 1e-3)


def long_strip(torch, mesh, dev, same_bits):
    """slice_strip_long: the LONG_STRIP plane over ``mesh``, LONG_LEVELS
    levels, 9/7 and 5/3 (strip_round_trip): level 0's lines past MAX_LINE
    take the horizontal halves' "scratch" form, the coarser ones the form
    transform.h_form picks for their launch; each half must launch in the
    forms h_form gives, as many times as the levels and cards ask."""
    from grok_tpu_torch import kernels
    from grok_tpu_torch.ops import transform as tr

    before = kernels.form_counts()
    x_long = torch.from_numpy(natural_image(*LONG_STRIP, 1) - 128).to(dev)
    res = {}
    for irrev in (True, False):
        x = x_long.to(torch.float32 if irrev else torch.int32)
        res["97" if irrev else "53"], _ = strip_round_trip(torch, mesh, x, LONG_LEVELS, irrev,
                                                           same_bits)
    after = kernels.form_counts()
    long_forms = {k: {f: c - before.get(k, {}).get(f, 0) for f, c in v.items()}
                  for k, v in after.items() if k.startswith("dwt")}
    cards = {d: sum(e == d for e in mesh.devices) for d in mesh.devices}
    want = {}
    for name in STRIP_KERNELS[4:]:
        want[name] = {}
        for lvl in range(LONG_LEVELS):
            h, w = (LONG_STRIP[0] // len(mesh)) >> lvl, LONG_STRIP[1] >> lvl
            for d, n in cards.items():
                shards = [None] * n
                f = tr.h_form(name, w, tr.h_lines(shards, h), tr.sm_count(d))
                want[name][f] = want[name].get(f, 0) + -(-n // tr.H_MAX_PLANES)
    emit({"phase": "slice_strip_long", "plane": "x".join(map(str, LONG_STRIP)),
          "levels": LONG_LEVELS, **res, "forms": long_forms, "forms_wanted": want})
    got_forms = {k: {f: c for f, c in long_forms.get(k, {}).items() if c} for k in want}
    if not (round_trips_hold(res) and got_forms == want):
        raise AssertionError(f"slice_strip_long: {res}, forms {long_forms}, wanted {want}")


def cards_main(torch, gt, mesh, dev, smi, kind, lap, walls) -> int:
    """``--cards``: the K6 phases alone, over a mesh of every card (two or
    more) and then over a virtual mesh of as many shards on the first card,
    in one run, so the two compare on the same machine."""
    if not mesh.virtual and len(mesh) >= 2:
        arr = natural_image(H, W, NC)
        x_strip = natural_image(STRIP, STRIP, 1) - 128
        tiles8 = tile_batch(arr)
        for m in (mesh, gt.make_mesh(len(mesh), device=dev)):
            emit({"phase": "cards_mesh", "devices": [str(d) for d in m.devices],
                  "virtual": m.virtual})
            got, forms = k6_phases(torch, m, dev, arr, x_strip, tiles8, lap)
            emit({"phase": "cards_launches", "virtual": m.virtual, "launches": got,
                  "forms": forms})
        emit({"phase": "walls", "seconds": walls, "total": sum(walls.values())})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    print("chip_smoke --cards: needs two or more CUDA cards", file=sys.stderr)
    return 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import grok_tpu_torch as gt
    from grok_tpu_torch import kernels
    from grok_tpu_torch.codestream.compress import build_siz, build_tcp
    from grok_tpu_torch.ops import transform as tr
    from grok_tpu_torch.t1 import ebcot_cuda as ec
    from grok_tpu_torch.t1 import ht_cuda as hc
    from grok_tpu_torch.t1.ebcot import lane_numbps
    from grok_tpu_torch.t2 import rate_control as rc
    from grok_tpu_torch.core.rect import Rect
    from grok_tpu_torch.parallel import mesh as pm
    from grok_tpu_torch.parallel import ops as k6
    from grok_tpu_torch.tile.tile_processor import TileProcessor, _repair_pass_rates

    dev = _device(torch)
    walls, t_prev = {}, [time.perf_counter()]

    def lap(name):  # the wall seconds since the previous lap, under name
        t = time.perf_counter()
        walls[name] = t - t_prev[0]
        t_prev[0] = t

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # the mesh of the K6 phases: every card when there are two or more,
    # else four shards on the one card (a virtual mesh: its halo copies and
    # kernels run inside one card)
    n_cards = torch.cuda.device_count()
    mesh = gt.make_mesh() if n_cards >= 2 else gt.make_mesh(4, device=dev)
    emit({"phase": "mesh", "devices": [str(d) for d in mesh.devices], "virtual": mesh.virtual})

    lap("device")

    # ---- 2. build
    build_s = kernels.build_all()
    regs = {}
    for k in kernels.KERNELS.values():
        log = kernels.BUILD_DIR / (k.source.rsplit(".", 1)[0] + ".log")
        if log.exists():
            regs[k.source] = [ln.strip() for ln in log.read_text().splitlines()
                              if "registers" in ln]
    emit({"phase": "build", "seconds": round(build_s, 3), "ptxas": regs})

    lap("build")

    if "--cards" in sys.argv[1:]:
        return cards_main(torch, gt, mesh, dev, smi, kind, lap, walls)
    if "--ke-warps" in sys.argv[1:]:
        return ke_warps(torch, gt, hc, kernels, dev, smi)

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
    tp._apply_band_quant()
    planes = [torch.from_numpy(np.ascontiguousarray(arr[:, :, c])).to(dev) for c in range(NC)]
    dcs = [128] * NC
    stats = {}
    timer = KernelTimer(torch, dev)

    # K-a on the whole image
    got = tr.dc_rct_fwd(planes, dcs, True)
    ref = tr.dc_rct_fwd_plain(planes, dcs, True)
    err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
    stats["dc_rct_fwd"] = dict(
        max_abs_err=err, **timer.row(lambda: tr.dc_rct_fwd(planes, dcs, True),
                                     bytes_=6 * 4 * W * H),
        plain_ms=cuda_ms(torch, lambda: tr.dc_rct_fwd_plain(planes, dcs, True)),
        bytes=6 * 4 * W * H, ops=8 * W * H, shape=f"3 x {H}x{W} int32")

    # K-b as forward_transform calls it: a component's levels finest first,
    # one launch each, into a new plane (dwt53_fwd_levels); the in-place
    # one-level entry (a launch and a copy a level) checked too
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
    fwd53_lv = [levels[5 * c:5 * c + 5] for c in range(NC)]

    def fwd53(ps):
        return [tr.dwt53_fwd_levels(p, lv) for p, lv in zip(ps, fwd53_lv)]
    kern = fwd53(got)
    plain = [p.clone() for p in got]
    dwt_all(tr.dwt53_fwd_level_plain, plain)
    in_place = [p.clone() for p in got]
    dwt_all(tr.dwt53_fwd_level, in_place)
    err = max(int((a - b).abs().max()) for a, b in zip(kern + in_place, plain + plain))
    packed_ref = [p.clone() for p in plain]
    lvl_bytes = sum(8 * h * w for (h, w, _, _) in levels)
    kb_fig = dict(in_place_entry_equal=all(torch.equal(a, b) for a, b in zip(in_place, plain)),
                  **level_figures(torch, tr, kernels, timer, "dwt53_fwd_level",
                                  "dwt53_fwd_occupancy", (60, 64), got[0], fwd53_lv[0],
                                  tr.dwt53_fwd_levels))
    rects53 = [g.rect for g in tp.geoms]

    def forward53_chain():  # the 5/3 encode's transform stage: K-a, K-b
        tr.forward_transform(planes, rects53, [5] * NC, dcs, True)
    kb_fig["transform_stage"] = chain_times(torch, forward53_chain)
    scratch = [p.clone() for p in got]
    stats["dwt53_fwd_level"] = dict(
        max_abs_err=err, **timer.row(lambda: fwd53(got), cold=True, bytes_=lvl_bytes),
        plain_ms=cuda_ms(torch, lambda: dwt_all(tr.dwt53_fwd_level_plain, scratch)),
        bytes=lvl_bytes, ops=sum(9 * h * w for (h, w, _, _) in levels),
        shape="5 levels x 3 comps from 2160x3840 int32 (ms per image, dwt53_fwd_levels: "
              "15 launches)", **kb_fig)
    del kern, plain, in_place, scratch
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
    records = sym.numel()  # [n, pmaxc, 3, s_pad] one byte each
    t_c = timer.row(lambda: ec.ebcot_symbols(batch, lanes, tabs["ctx"], pmaxc),
                    bytes_=n * bh * bw * 4 + records)
    nb32 = lanes[0].contiguous()
    st32 = lanes[4].contiguous()
    packed = ec.mq_pack(sym, nb32, st32, tabs["mq"], bh, bw, pmax)
    s_pad = sym.shape[3]
    s_spp, s_mrp, s_cup, _ = ec.slot_counts(-(-bh // 4), bw)
    nbh = numbps.cpu().numpy()
    read_d = int(sum(max(int(b) - 1, 0) * (s_spp + s_mrp) + int(b) * s_cup for b in nbh))
    written_d = int(packed[1].sum()) + n  # segment bytes and each lane's carry byte
    bytes_d = read_d + written_d + n * 8 + packed[2].numel() * 8
    t_d = timer.row(lambda: ec.mq_pack(sym, nb32, st32, tabs["mq"], bh, bw, pmax),
                    bytes_=bytes_d)

    rng = np.random.default_rng(7)
    orients = plan.orients.cpu().numpy()
    pick = np.concatenate([rng.choice(np.flatnonzero(orients == o),
                                      size=min(SAMPLE_PER_ORIENT, int((orients == o).sum())),
                                      replace=False)
                           for o in range(4)])
    idx = torch.from_numpy(np.sort(pick)).to(dev)
    s_batch = batch[idx].contiguous()
    s_lanes = lanes[:, idx].contiguous()
    s_pmax = int(s_lanes[0].max())
    s_pmaxc = -(-s_pmax // 4) * 4
    s_sym = ec.ebcot_symbols(s_batch, s_lanes, tabs["ctx"], s_pmaxc)
    sample_ms_c = timer.warm(lambda: ec.ebcot_symbols(s_batch, s_lanes, tabs["ctx"], s_pmaxc))
    plain_ms_c, p_sym = cpu_ms(lambda: ec.ebcot_symbols_plain(
        s_batch.cpu(), s_lanes.cpu(), tabs["ctx"].cpu(), s_pmaxc))
    err_c = int((s_sym.cpu().to(torch.int32) - p_sym.to(torch.int32)).abs().max())
    k_out = ec.mq_pack(s_sym, s_lanes[0].contiguous(), s_lanes[4].contiguous(),
                       tabs["mq"], bh, bw, s_pmax)
    sample_ms_d = timer.warm(lambda: ec.mq_pack(s_sym, s_lanes[0].contiguous(),
                                                s_lanes[4].contiguous(), tabs["mq"],
                                                bh, bw, s_pmax))
    plain_ms_d, p_out = cpu_ms(lambda: ec.mq_pack_plain(
        p_sym, s_lanes[0].cpu(), s_lanes[4].cpu(), tabs["mq"].cpu(), bh, bw, s_pmax))
    err_d = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(k_out, p_out))
    # the records the coder codes: what sizes K-d's serial chain
    valid = torch.cat([(sym[i:i + 512] >= 0x80).reshape(-1, pmaxc * 3 * s_pad).sum(1)
                       for i in range(0, n, 512)])
    sample = (f"{len(pick)} codeblocks ("
              + ", ".join(f"{(orients[pick] == o).sum()} orient {o}" for o in range(4))
              + "), plain on cpu")
    # operations: at least one integer operation per record written (K-c)
    # or read (K-d); any form of the scan or the coder does more
    stats["ebcot_symbols"] = dict(
        max_abs_err=err_c, **t_c, plain_ms=plain_ms_c,
        bytes=n * bh * bw * 4 + records, ops=records,
        shape=f"{n} codeblocks {bh}x{bw}, pmaxc {pmaxc}, records {records} B",
        plain_shape=sample, sample_ms=sample_ms_c)
    stats["mq_pack"] = dict(
        max_abs_err=err_d, **t_d, plain_ms=plain_ms_d, bytes=bytes_d, ops=read_d,
        shape=f"{n} codeblocks, records of coded planes {read_d} B, segments {written_d} B",
        plain_shape=sample, sample_ms=sample_ms_d, valid_records=int(valid.sum()),
        max_valid_records_one_codeblock=int(valid.max()),
        sample_max_valid_records=int(valid[idx].max()))

    # K-p and K-q on the sample: the kernels on the card, the plain versions
    # on the CPU, from the sample's records and (repaired) pass rates
    s_nb = s_lanes[0].contiguous()
    k_dist = ec.ebcot_pass_dist(s_sym, s_batch, s_nb, s_pmax)
    plain_ms_p, p_dist = cpu_ms(lambda: ec.pass_dist_from_records(
        s_sym.cpu(), s_batch.cpu(), s_nb.cpu(), s_pmax))
    s_rates = k_out[2].cpu().numpy().astype(np.int64)
    s_npass = ((s_nb.to(torch.int64) * 3 - 2).clamp(min=0)).cpu().numpy()
    _repair_pass_rates(s_rates, s_npass)
    s_w2 = tp._band_weights(plan.refs)[np.sort(pick)]
    s_dists = k_dist.cpu().numpy() * s_w2[:, None]
    hull_in = [torch.from_numpy(a) for a in (s_rates, s_dists, s_npass.astype(np.int32))]
    k_slopes = rc.hull_slopes(*(t.to(dev) for t in hull_in))
    plain_ms_q, p_slopes = cpu_ms(lambda: rc.hull_slopes(*hull_in))
    sample_checks_pq = dict(
        ebcot_pass_dist=dict(equal=bool(torch.equal(k_dist.cpu(), p_dist)),
                             plain_cpu_ms=plain_ms_p, passes=int(s_npass.sum()),
                             regimes=kp_regimes(kernels, s_nb.cpu().numpy(), *s_batch.shape[1:])),
        hull_slopes=dict(equal=bool(torch.equal(k_slopes.cpu(), p_slopes)),
                         plain_cpu_ms=plain_ms_q))
    del k_dist, k_slopes

    # K-i: the whole 4K batch's segments back to the coefficients K-c read,
    # timed on the card; the sample against the plain version on the CPU,
    # once whole and once cut after a seeded pass at that pass's rate
    buf, seg_len, rates = packed
    npasses = (numbps * 3 - 2).clamp(min=0)
    dec_lanes, dec_data, dec_starts = dec_inputs(torch, plan, numbps, npasses, seg_len, buf)
    no_segs = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    dec = ec.ebcot_decode(dec_data, dec_starts, dec_lanes, no_segs, tabs["ctx"], tabs["mq"],
                          bh, bw)
    dec_bytes = int(seg_len.sum())
    samples_i = int((plan.heights * plan.widths).sum())
    bytes_i = dec_bytes + samples_i * 4 + n * (7 * 4 + 8)
    t_i = timer.row(lambda: ec.ebcot_decode(dec_data, dec_starts, dec_lanes, no_segs,
                                            tabs["ctx"], tabs["mq"], bh, bw), bytes_=bytes_i)
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
        if label == "cut":
            # every other cut codeblock decoded with a seeded ROI shift in
            # style bits 8-15: K-i's scaled-domain writeout on truncated data
            s_lanes[5, ::2] |= torch.from_numpy(rng.integers(1, 7, (len(s_np) + 1) // 2)
                                                .astype(np.int32) << 8).to(dev)
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
    chain_4k = ki_chain(ec, t_i["ms"], dec_lanes, valid)
    del sym, packed, s_sym, buf, dec_data
    # K-i on the codeblocks of one tile of dist53: the batch of each of the
    # tiled cells' 12 launches, as the path launches it
    tb = tile_dec_batch(torch, gt, ec, arr, mesh)
    if not torch.equal(ec.ebcot_decode(*tb["args"], tb["bh"], tb["bw"]), tb["out"]):
        raise AssertionError("ebcot_decode of the dist53 tile batch differs from the path's")
    t_tile = timer.row(lambda: ec.ebcot_decode(*tb["args"], tb["bh"], tb["bw"]),
                       bytes_=tb["bytes"])
    tile_row = dict(
        **t_tile, bytes=tb["bytes"], bound_ms=tb["bytes"] / HBM_BYTES_PER_S * 1e3,
        shape=f"{tb['n']} codeblocks {tb['bh']}x{tb['bw']}, {tb['samples']} samples "
              "(DIST53's first tile decode)",
        **ki_chain(ec, t_tile["ms"], tb["args"][2], tb["valid"]))
    del tb
    stats["ebcot_decode"] = dict(
        max_abs_err=err_i, **t_i, plain_ms=i_checks["whole"]["plain_ms"], bytes=bytes_i,
        ops=int(valid.sum()),
        shape=f"{n} codeblocks {bh}x{bw}, {samples_i} samples, segments {dec_bytes} B, "
              f"{int(valid.sum())} decisions (at most {int(valid.max())} in one codeblock)",
        plain_shape=sample, sample_checks=i_checks, **chain_4k, ptxas=ptxas("ebcot_dec"),
        tile_dist53=tile_row)

    # K-e / K-f: full 4K batch on the card, the same sample against the
    # plain versions on the CPU
    h32 = plan.heights.to(torch.int32).contiguous()
    w32 = plan.widths.to(torch.int32).contiguous()
    htab = hc.ht_tables(dev)
    mmax = max((2 * int(batch.abs().max()) - 1).bit_length(), 1)
    hbuf, hlen = hc.ht_cleanup_enc(batch, h32, w32, htab, mmax)
    samples = int((h32.to(torch.int64) * w32).sum())  # inside the codeblocks
    seg_bytes = int(hlen.sum())
    # K-e reads the samples and writes every byte of the segment rows (the
    # zeros past each segment too) and the int32 lengths
    bytes_e = samples * 4 + hbuf.numel() + n * 4
    t_e = timer.row(lambda: hc.ht_cleanup_enc(batch, h32, w32, htab, mmax), bytes_=bytes_e)
    ke = ke_figures(torch, hc, kernels, timer, batch, h32, w32, htab, mmax, (hbuf, hlen))
    # with the block energy of rate control: the same segments, and the
    # energies of the plain version (on the card)
    e_buf, e_len, energy = hc.ht_cleanup_enc(batch, h32, w32, htab, mmax, want_energy=True)
    ms_e_energy = timer.warm(lambda: hc.ht_cleanup_enc(batch, h32, w32, htab, mmax,
                                                       want_energy=True))
    energy_ok = (torch.equal(e_buf, hbuf) and torch.equal(e_len, hlen)
                 and torch.equal(energy, hc.block_energy_plain(batch, h32, w32)))
    del e_buf, e_len, energy
    hdata = hbuf[:, :int(hlen.max())].contiguous()
    hlen32 = hlen.to(torch.int32)
    dec, dec_stopped = hc.ht_cleanup_dec(hdata, hlen32, h32, w32, htab, bh, bw)
    # the bytes K-f must move: the segments up to their lengths, the samples
    # inside the codeblocks and a flag a codeblock (the rows' zeros outside
    # them, which the kernel writes too, are read by nothing on the path)
    bytes_f = seg_bytes + samples * 4 + n
    t_f = timer.row(lambda: hc.ht_cleanup_dec(hdata, hlen32, h32, w32, htab, bh, bw),
                    bytes_=bytes_f)
    if bool(dec_stopped.any()) or not torch.equal(dec, batch):
        raise AssertionError("ht_cleanup_dec of the 4K batch is not the batch")
    del dec, dec_stopped
    kf = kf_figures(torch, hc, kernels, timer, hdata, hlen32, h32, w32, htab, bh, bw, batch)
    s_h, s_w = h32[idx].contiguous(), w32[idx].contiguous()
    k_enc = hc.ht_cleanup_enc(s_batch, s_h, s_w, htab, mmax)
    plain_ms_e, p_enc = cpu_ms(lambda: hc.ht_cleanup_enc_plain(
        s_batch.cpu(), s_h.cpu(), s_w.cpu(), k_enc[0].shape[1]))
    err_e = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(k_enc, p_enc))
    k_energy = hc.ht_cleanup_enc(s_batch, s_h, s_w, htab, mmax, want_energy=True)[2]
    energy_ok = energy_ok and torch.equal(
        k_energy.cpu(), hc.block_energy_plain(s_batch.cpu(), s_h.cpu(), s_w.cpu()))
    if not energy_ok:
        err_e = max(err_e, 1)  # an energy off in any bit counts as an error
    s_data = k_enc[0][:, :max(int(k_enc[1].max()), 2)].contiguous()
    s_len32 = k_enc[1].to(torch.int32)
    k_dec = hc.ht_cleanup_dec(s_data, s_len32, s_h, s_w, htab, bh, bw)
    plain_ms_f, p_dec = cpu_ms(lambda: hc.ht_cleanup_dec_plain(
        s_data.cpu(), s_len32.cpu(), s_h.cpu(), s_w.cpu(), bh, bw))
    err_f = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(k_dec, p_dec))
    # the sample cut at seeded lengths, and with seeded bytes flipped: the
    # decode stops where the plain version's does, keeping what it wrote
    rng_f = np.random.default_rng(13)
    s_lens = s_len32.cpu().numpy()
    cut_len = np.where(s_lens > 2, rng_f.integers(2, np.maximum(s_lens, 2) + 1), s_lens)
    flipped = s_data.cpu().numpy().copy()
    for r, ln in enumerate(s_lens):
        for _ in range(3 if ln else 0):
            flipped[r, rng_f.integers(0, ln)] ^= rng_f.integers(1, 256, dtype=np.uint8)
    f_checks = {}
    for label, f_data, f_len in (("cut", s_data.cpu(), torch.from_numpy(cut_len)),
                                 ("flipped", torch.from_numpy(flipped), s_len32.cpu())):
        f_len = f_len.to(torch.int32)
        k_out, k_stop = hc.ht_cleanup_dec(f_data.to(dev), f_len.to(dev), s_h, s_w, htab, bh, bw)
        p_out, p_stop = hc.ht_cleanup_dec_plain(f_data, f_len, s_h.cpu(), s_w.cpu(), bh, bw)
        f_checks[label] = dict(
            max_abs_err=int((k_out.cpu().to(torch.int64) - p_out).abs().max())
            + int(not torch.equal(k_stop.cpu(), p_stop)),
            stopped=int(p_stop.sum()), bytes=int(f_len.sum()))
        err_f = max(err_f, f_checks[label]["max_abs_err"])
    if not kf["c_entry_equal"]:
        err_f = max(err_f, 1)
    if not ke["c_entry_equal"]:
        err_e = max(err_e, 1)
    # K-e at magnitudes from 2^24 to INT32_MIN's 2^31: segments, lengths
    # and energies against the plain version on the CPU
    w_c, w_h, w_w = (torch.from_numpy(a) for a in wide_blocks(32, bh, bw))
    w_mmax = max((2 * hc.largest_magnitude(w_c) - 1).bit_length(), 1)
    w_k = hc.ht_cleanup_enc(w_c.to(dev), w_h.to(dev), w_w.to(dev), htab, w_mmax,
                            want_energy=True)
    w_p = hc.ht_cleanup_enc_plain(w_c, w_h, w_w, w_k[0].shape[1])
    wide_ok = (torch.equal(w_k[0].cpu(), w_p[0]) and torch.equal(w_k[1].cpu(), w_p[1])
               and torch.equal(w_k[2].cpu(), hc.block_energy_plain(w_c, w_h, w_w)))
    ke["wide_check"] = dict(equal=wide_ok, codeblocks=32, mmax=w_mmax,
                            magnitudes="2^24 .. 2^31 - 1 and INT32_MIN",
                            segment_bytes=int(w_p[1].sum()))
    if not wide_ok:
        err_e = max(err_e, 1)
    del w_k, w_p
    # the bytes the function must move: the samples, the segments up to
    # their lengths and the lengths (the zeros past a segment are read by
    # nothing on the path)
    seg_bound = (samples * 4 + seg_bytes + n * 4) / HBM_BYTES_PER_S * 1e3
    stats["ht_cleanup_enc"] = dict(
        max_abs_err=err_e, **t_e, plain_ms=plain_ms_e,
        bytes=bytes_e, ops=samples, bound_ms_segments=seg_bound,
        x_bound_segments=t_e["ms"] / seg_bound,
        shape=f"{n} codeblocks {bh}x{bw}, {samples} samples, segments {seg_bytes} B of "
              f"rows of {hbuf.shape[1]} B, MagSgn fields <= {mmax} bits", plain_shape=sample,
        ms_with_energy=ms_e_energy, energy_equal=energy_ok, **ke)
    # beside it, the bound on what the kernel writes: every sample of the
    # output rows, read with the segments, the heights, widths and lengths
    rows_bound = (seg_bytes + n * bh * bw * 4 + n * 13) / HBM_BYTES_PER_S * 1e3
    stats["ht_cleanup_dec"] = dict(
        max_abs_err=err_f, **t_f, plain_ms=plain_ms_f,
        bytes=bytes_f, ops=samples, bound_ms_rows=rows_bound,
        x_bound_rows=t_f["ms"] / rows_bound,
        shape=f"{n} codeblocks {bh}x{bw} (rows written whole), {samples} samples, "
              f"segments {seg_bytes} B", plain_shape=sample, sample_checks=f_checks, **kf)
    del hbuf, hdata, batch

    # K-g / K-h on the whole image, from the packed planes back to samples.
    # K-g as inverse_transform calls it: a component's levels coarsest
    # first, one launch each, into a new plane (dwt53_inv_levels); the
    # in-place one-level entry (a launch and a copy a level) checked too
    inv_lv = [list(reversed(levels[5 * c:5 * c + 5])) for c in range(NC)]

    def idwt_all(fn, ps):
        for p, lv in zip(ps, inv_lv):
            for (h, w, py, px) in lv:
                fn(p, h, w, py, px)

    def inv53(ps):
        return [tr.dwt53_inv_levels(p, lv) for p, lv in zip(ps, inv_lv)]
    kern = inv53(coeffs)
    plain = [p.clone() for p in coeffs]
    idwt_all(tr.dwt53_inv_level_plain, plain)
    in_place = [p.clone() for p in coeffs]
    idwt_all(tr.dwt53_inv_level, in_place)
    err = max(int((a - b).abs().max()) for a, b in zip(kern + in_place, plain + plain))
    kg_fig = dict(in_place_entry_equal=all(torch.equal(a, b) for a, b in zip(in_place, plain)),
                  **level_figures(torch, tr, kernels, timer, "dwt53_inv_level",
                                  "dwt53_inv_occupancy", (60, 64), coeffs[0], inv_lv[0],
                                  tr.dwt53_inv_levels))

    def inverse53_chain():  # the 5/3 decode's inverse stage: K-g, K-h
        tr.inverse_transform(coeffs, rects53, [5] * NC, [8] * NC, [False] * NC, True)
    kg_fig["inverse_stage"] = chain_times(torch, inverse53_chain)
    scratch = [p.clone() for p in coeffs]
    stats["dwt53_inv_level"] = dict(
        max_abs_err=err, **timer.row(lambda: inv53(coeffs), cold=True, bytes_=lvl_bytes),
        plain_ms=cuda_ms(torch, lambda: idwt_all(tr.dwt53_inv_level_plain, scratch)),
        bytes=lvl_bytes, ops=sum(9 * h * w for (h, w, _, _) in levels),
        shape="5 levels x 3 comps to 2160x3840 int32 (ms per image, dwt53_inv_levels: "
              "15 launches)", **kg_fig)
    rng8 = [(0, 255)] * NC
    k_out = tr.rct_inv_dc_clip([p.clone() for p in kern], dcs, rng8, True)
    p_out = tr.rct_inv_dc_clip_plain([p.clone() for p in kern], dcs, rng8, True)
    err = max(int((a - b).abs().max()) for a, b in zip(k_out, p_out))
    if any(not torch.equal(k_out[c].cpu(), torch.from_numpy(np.ascontiguousarray(arr[:, :, c])))
           for c in range(NC)):
        raise AssertionError("inverse chain of the 4K coefficients is not the image")
    stats["rct_inv_dc_clip"] = dict(
        max_abs_err=err, **timer.row(lambda: tr.rct_inv_dc_clip(kern, dcs, rng8, True),
                                     bytes_=6 * 4 * W * H),
        plain_ms=cuda_ms(torch, lambda: tr.rct_inv_dc_clip_plain(kern, dcs, rng8, True)),
        bytes=6 * 4 * W * H, ops=10 * W * H, shape=f"3 x {H}x{W} int32")
    del kern, plain, in_place, k_out, p_out, scratch

    # K-j ... K-o on the whole image: the 9/7 + ICT chain, each kernel on
    # the previous one's output, against its plain version on the card
    # (compared on the float32 bits)
    def same_bits(a, b):
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
        return torch.equal(a, b)

    def err_of(xs, ys):
        if all(same_bits(x, y) for x, y in zip(xs, ys)):
            return 0.0
        return max(float((x.double() - y.double()).abs().nan_to_num(1e30).max())
                   for x, y in zip(xs, ys)) or 1e-30  # differing bits count as an error

    tp97 = TileProcessor(siz, build_tcp(image, gt.CompressParams(**P97)), 0, dev)
    tp97._apply_band_quant()
    bands = tp97.band_tables()
    npx = W * H
    f_in = tr.dc_ict_fwd(planes, dcs, True)
    stats["dc_ict_fwd"] = dict(
        max_abs_err=err_of(f_in, tr.dc_ict_fwd_plain(planes, dcs, True)),
        **timer.row(lambda: tr.dc_ict_fwd(planes, dcs, True), bytes_=6 * 4 * npx),
        plain_ms=cuda_ms(torch, lambda: tr.dc_ict_fwd_plain(planes, dcs, True)),
        bytes=6 * 4 * npx, ops=15 * npx, op_rate=FP32_OPS_PER_S,
        shape=f"3 x {H}x{W} int32 -> float32")
    # K-k as forward_transform calls it: a component's levels finest first,
    # one launch each, into a new plane (dwt97_fwd_levels); the in-place
    # one-level entry (a launch and a copy a level) checked too
    fwd_lv = [levels[5 * c:5 * c + 5] for c in range(NC)]

    def fwd97(ps):
        return [tr.dwt97_fwd_levels(p, lv) for p, lv in zip(ps, fwd_lv)]
    kern = fwd97(f_in)
    plain = [p.clone() for p in f_in]
    dwt_all(tr.dwt97_fwd_level_plain, plain)
    in_place = [p.clone() for p in f_in]
    dwt_all(tr.dwt97_fwd_level, in_place)
    kk_fig = dict(in_place_entry_equal=err_of(in_place, plain) == 0, **level_figures(
        torch, tr, kernels, timer, "dwt97_fwd_level", "dwt97_fwd_occupancy", (56, 64), f_in[0],
        fwd_lv[0], tr.dwt97_fwd_levels))
    rects97 = [g.rect for g in tp97.geoms]

    def forward97_chain():  # the 9/7 encode's transform stage: K-j, K-k, K-l
        tr.forward_transform(planes, rects97, [5] * NC, dcs, True, True, bands)
    kk_fig["transform_stage"] = chain_times(torch, forward97_chain)
    scratch = [p.clone() for p in f_in]
    lift_bytes = sum(8 * h * w for (h, w, _, _) in levels)
    lift_ops = sum(26 * h * w for (h, w, _, _) in levels)  # 4 steps of 3 + a scaling, 2 axes
    stats["dwt97_fwd_level"] = dict(
        max_abs_err=max(err_of(kern, plain), err_of(in_place, plain)),
        **timer.row(lambda: fwd97(f_in), cold=True, bytes_=lift_bytes),
        plain_ms=cuda_ms(torch, lambda: dwt_all(tr.dwt97_fwd_level_plain, scratch)),
        bytes=lift_bytes, ops=lift_ops, op_rate=FP32_OPS_PER_S,
        shape="5 levels x 3 comps from 2160x3840 float32 (ms per image, dwt97_fwd_levels: "
              "15 launches)", **kk_fig)
    del in_place
    # K-l and K-m as the chains call them: one call a tile over its three
    # planes, one launch; timed warm and cold, and their host enqueue
    q_k = tr.quant_deadzone(kern, bands)
    q_p = [tr.quant_deadzone_plain(p, b) for p, b in zip(kern, bands)]
    odd_checks = quant_odd_checks(torch, gt, tr, kernels, dev)
    odd_ok = all(c["equal"] for c in odd_checks.values())
    stats["quant_deadzone"] = dict(
        max_abs_err=max(err_of(q_k, q_p), 0.0 if odd_ok else 1e-30),
        **timer.row(lambda: tr.quant_deadzone(kern, bands), cold=True, bytes_=8 * 3 * npx),
        plain_ms=cuda_ms(torch, lambda: [tr.quant_deadzone_plain(p, b)
                                         for p, b in zip(kern, bands)]),
        bytes=8 * 3 * npx, ops=3 * 3 * npx, op_rate=FP32_OPS_PER_S,
        shape=f"3 x {H}x{W} float32 -> int32, {len(bands[0])} bands a component, "
              f"one launch a tile", call=chain_times(torch, lambda: tr.quant_deadzone(kern, bands)),
        odd_checks=odd_checks)

    # K-p and K-q on the whole 4K lossy97 batch (the codeblocks of these
    # quantized planes): K-p against its plain version on the card, K-q
    # against its plain loop on the CPU, from K-d's repaired pass rates and
    # the weighted distortions, as the tile processor hands them over
    plan97 = tp97.gather_plan()
    b97 = tp97.gather(q_k, plan97)
    n97, bh97, bw97 = b97.shape
    nb97 = lane_numbps(b97.abs(), plan97.heights, plan97.widths)
    pmax97 = int(nb97.max())
    lanes97 = torch.stack([nb97, plan97.heights, plan97.widths, plan97.orients,
                           plan97.styles]).to(torch.int32).contiguous()
    sym97 = ec.ebcot_symbols(b97, lanes97, tabs["ctx"], -(-pmax97 // 4) * 4)
    nb97_32 = lanes97[0].contiguous()
    dist97 = ec.ebcot_pass_dist(sym97, b97, nb97_32, pmax97)
    p_dist97 = ec.pass_dist_from_records(sym97, b97, nb97_32, pmax97)
    plain_ms_p = cuda_ms(torch, lambda: ec.pass_dist_from_records(sym97, b97, nb97_32, pmax97),
                         reps=1)
    err_p = 0.0 if torch.equal(dist97, p_dist97) else (
        float((dist97 - p_dist97).abs().max()) or 1e-30)
    if not sample_checks_pq["ebcot_pass_dist"]["equal"]:
        err_p = max(err_p, 1e-30)
    ns97 = -(-bh97 // 4)
    s_spp97, s_mrp97, _, _ = ec.slot_counts(ns97, bw97)
    npos97 = ns97 * bw97 * 4
    nbh97 = nb97.cpu().numpy()
    # the records K-p must read: the sign slots of SPP and CUP, every MRP slot
    read_p = int(sum(max(int(b) - 1, 0) * (s_spp97 // 2 + s_mrp97) + int(b) * npos97
                     for b in nbh97))
    in_blk97 = int((plan97.heights * plan97.widths).sum())
    valid_p = 0  # the decreases K-p forms and adds
    for i in range(0, n97, 512):
        ch = sym97[i:i + 512]
        valid_p += int((ch[:, :, 0, 1:s_spp97:2] >= 0x80).sum()
                       + (ch[:, :, 1, :s_mrp97] >= 0x80).sum()
                       + (ch[:, :, 2, :ns97 * bw97 * 11].reshape(ch.shape[0], ch.shape[1], -1,
                                                                 11)[..., 4::2] >= 0x80).sum())
    p_passes = dist97.shape[1]
    bytes_p = read_p + in_blk97 * 4 + n97 * 4 + n97 * p_passes * 8
    # the record rows K-p reads whole (SPP 8, MRP 4, CUP 11 slots a column of a stripe)
    rows_p = int(sum(max(int(b) - 1, 0) * (s_spp97 + s_mrp97) + int(b) * ns97 * bw97 * 11
                     for b in nbh97))
    threads_p, smem_p, blocks_p = c_ints(kernels, "ebcot_dist.cu", "ebcot_dist_occupancy",
                                         bh97, bw97, p_passes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kp_fig = dict(
        passes=kp_regimes(kernels, nbh97, bh97, bw97),
        bytes_rows_read=rows_p + in_blk97 * 4 + n97 * 4 + n97 * p_passes * 8,
        launch=dict(threads_a_block=threads_p, shared_bytes_a_block=smem_p,
                    blocks_per_sm=blocks_p, waves=-(-n97 // max(blocks_p * sms, 1))),
        ptxas=ptxas("ebcot_dist"))
    stats["ebcot_pass_dist"] = dict(
        max_abs_err=err_p,
        **timer.row(lambda: ec.ebcot_pass_dist(sym97, b97, nb97_32, pmax97), cold=True,
                    bytes_=bytes_p),
        plain_ms=plain_ms_p, bytes=bytes_p, ops=5 * valid_p,
        op_rate=FP64_OPS_PER_S,
        shape=f"{n97} codeblocks {bh97}x{bw97} (4K lossy97), {p_passes} passes, "
              f"{read_p} B of records read, {valid_p} decreases",
        plain_shape="the same batch, plain on the card",
        sample_check=sample_checks_pq["ebcot_pass_dist"], **kp_fig)
    r97 = ec.mq_pack(sym97, nb97_32, lanes97[4].contiguous(), tabs["mq"], bh97, bw97,
                     pmax97)[2].cpu().numpy().astype(np.int64)
    np97 = np.maximum(nbh97.astype(np.int64) * 3 - 2, 0)
    _repair_pass_rates(r97, np97)
    d97 = dist97.cpu().numpy() * tp97._band_weights(plan97.refs)[:, None]
    del sym97, p_dist97, dist97
    hull97 = [torch.from_numpy(a) for a in (r97, d97, np97.astype(np.int32))]
    hull97_dev = [t.to(dev) for t in hull97]
    k_sl97 = rc.hull_slopes(*hull97_dev)
    plain_ms_q, p_sl97 = cpu_ms(lambda: rc.hull_slopes(*hull97))
    err_q = 0.0 if torch.equal(k_sl97.cpu(), p_sl97) else (
        float((k_sl97.cpu() - p_sl97).abs().max()) or 1e-30)
    if not sample_checks_pq["hull_slopes"]["equal"]:
        err_q = max(err_q, 1e-30)
    bytes_q = n97 * p_passes * 8 + int(np97.sum()) * 16 + n97 * 4
    stats["hull_slopes"] = dict(
        max_abs_err=err_q, **timer.row(lambda: rc.hull_slopes(*hull97_dev), bytes_=bytes_q),
        plain_ms=plain_ms_q, bytes=bytes_q, ops=10 * int(np97.sum()),
        op_rate=FP64_OPS_PER_S,
        shape=f"{n97} codeblocks (4K lossy97), {p_passes} passes, {int(np97.sum())} coded",
        plain_shape="the same batch, plain on cpu",
        sample_check=sample_checks_pq["hull_slopes"])
    del b97, hull97_dev, k_sl97
    d_k = tr.dequant_midbin(q_k, bands)
    d_p = [tr.dequant_midbin_plain(q, b) for q, b in zip(q_k, bands)]
    stats["dequant_midbin"] = dict(
        max_abs_err=max(err_of(d_k, d_p), 0.0 if odd_ok else 1e-30),
        **timer.row(lambda: tr.dequant_midbin(q_k, bands), cold=True, bytes_=8 * 3 * npx),
        plain_ms=cuda_ms(torch, lambda: [tr.dequant_midbin_plain(q, b)
                                         for q, b in zip(q_k, bands)]),
        bytes=8 * 3 * npx, ops=3 * 3 * npx, op_rate=FP32_OPS_PER_S,
        shape=f"3 x {H}x{W} int32 -> float32, {len(bands[0])} bands a component, "
              f"one launch a tile", call=chain_times(torch, lambda: tr.dequant_midbin(q_k, bands)),
        odd_checks=odd_checks)
    # K-n as inverse_transform calls it: a component's levels coarsest first,
    # one launch each, into a new plane (dwt97_inv_levels); the in-place
    # one-level entry (a launch and a copy a level) checked too
    def inv97(ps):
        return [tr.dwt97_inv_levels(p, lv) for p, lv in zip(ps, inv_lv)]
    kern = inv97(d_k)
    plain = [p.clone() for p in d_k]
    idwt_all(tr.dwt97_inv_level_plain, plain)
    in_place = [p.clone() for p in d_k]
    idwt_all(tr.dwt97_inv_level, in_place)
    kn_fig = dict(in_place_entry_equal=err_of(in_place, plain) == 0, **level_figures(
        torch, tr, kernels, timer, "dwt97_inv_level", "dwt97_inv_occupancy", (56, 64), d_k[0],
        inv_lv[0], tr.dwt97_inv_levels))
    # the decode's inverse stage on these planes: dequantization, K-n, K-o
    def inverse_chain():
        tr.inverse_transform(q_k, rects97, [5] * NC, [8] * NC, [False] * NC, True, True, bands)
    kn_fig["inverse_stage"] = chain_times(torch, inverse_chain)
    stats["dwt97_inv_level"] = dict(
        max_abs_err=max(err_of(kern, plain), err_of(in_place, plain)),
        **timer.row(lambda: inv97(d_k), cold=True, bytes_=lift_bytes),
        plain_ms=cuda_ms(torch, lambda: idwt_all(tr.dwt97_inv_level_plain, in_place)),
        bytes=lift_bytes, ops=lift_ops, op_rate=FP32_OPS_PER_S,
        shape="5 levels x 3 comps to 2160x3840 float32 (ms per image, dwt97_inv_levels: "
              "15 launches)", **kn_fig)
    del in_place
    o_k = tr.ict_inv_dc_round_clip(kern, dcs, rng8, True)
    o_p = tr.ict_inv_dc_round_clip_plain(kern, dcs, rng8, True)
    worst = max(int((o.cpu() - torch.from_numpy(np.ascontiguousarray(arr[:, :, c]))).abs().max())
                for c, o in enumerate(o_k))
    stats["ict_inv_dc_round_clip"] = dict(
        max_abs_err=err_of(o_k, o_p),
        **timer.row(lambda: tr.ict_inv_dc_round_clip(kern, dcs, rng8, True),
                    bytes_=6 * 4 * npx),
        plain_ms=cuda_ms(torch, lambda: tr.ict_inv_dc_round_clip_plain(kern, dcs, rng8, True)),
        bytes=6 * 4 * npx, ops=14 * npx, op_rate=FP32_OPS_PER_S,
        shape=f"3 x {H}x{W} float32 -> int32", chain_max_err_vs_input=worst)
    del f_in, kern, plain, scratch, q_k, q_p, d_k, d_p, o_k, o_p

    # K-r and K-s on the whole image: the Part-2 MCT with M3, then its
    # inverse with the stream's offsets, against their plain versions on
    # the card (the float32 bits); K-t on the first component's packed 5/3
    # plane, up and back down
    m3 = np.asarray(M3, dtype=np.float32)
    m3_inv = np.linalg.inv(np.asarray(M3, dtype=np.float64)).astype(np.float32)
    r_k = tr.dc_mct_fwd(planes, dcs, m3)
    m3_t = torch.from_numpy(m3).to(dev)
    flat_t = torch.stack([p - 128 for p in planes]).reshape(NC, -1).float()
    mct_odd = mct_checks(torch, tr, kernels, dev, planes)
    mct_ok = all(c["ok"] for c in mct_odd.values())
    threads_r, regs_r, blocks_r = c_ints(kernels, "mct_custom.cu", "dc_mct_fwd_occupancy", NC)
    stats["dc_mct_fwd"] = dict(
        max_abs_err=max(err_of(r_k, tr.dc_mct_fwd_plain(planes, dcs, m3)),
                        0.0 if mct_ok else 1e-30),
        **timer.row(lambda: tr.dc_mct_fwd(planes, dcs, m3), cold=True, bytes_=6 * 4 * npx),
        plain_ms=cuda_ms(torch, lambda: tr.dc_mct_fwd_plain(planes, dcs, m3), reps=1),
        bytes=6 * 4 * npx, ops=(2 * NC * NC + NC) * npx, op_rate=FP32_OPS_PER_S,
        launch=dict(threads_a_block=threads_r, registers=regs_r, blocks_per_sm=blocks_r),
        call=chain_times(torch, lambda: tr.dc_mct_fwd(planes, dcs, m3)), checks=mct_odd,
        ptxas=ptxas("mct_custom"),
        torch_matmul_ms=timer.warm(lambda: torch.matmul(m3_t, flat_t)),
        torch_matmul_note="torch.matmul of the matrix and the DC-shifted planes stacked as "
                          "float32: not the same function (it rounds differently, with no "
                          "fused chain in k order), so no library_ms",
        shape=f"{NC} x {H}x{W} int32 -> float32, {NC}x{NC} matrix")
    del m3_t, flat_t
    offs = [128.0] * NC
    s_k = tr.mct_inv_round_clip(r_k, m3_inv, offs, rng8)
    worst = max(int((o.cpu() - torch.from_numpy(np.ascontiguousarray(arr[:, :, c]))).abs().max())
                for c, o in enumerate(s_k))
    stats["mct_inv_round_clip"] = dict(
        max_abs_err=max(err_of(s_k, tr.mct_inv_round_clip_plain(r_k, m3_inv, offs, rng8)),
                        0.0 if mct_ok else 1e-30),
        **timer.row(lambda: tr.mct_inv_round_clip(r_k, m3_inv, offs, rng8), cold=True,
                    bytes_=6 * 4 * npx),
        call=chain_times(torch, lambda: tr.mct_inv_round_clip(r_k, m3_inv, offs, rng8)),
        plain_ms=cuda_ms(torch, lambda: tr.mct_inv_round_clip_plain(r_k, m3_inv, offs, rng8),
                         reps=1),
        bytes=6 * 4 * npx, ops=(2 * NC * NC + 2 * NC) * npx, op_rate=FP32_OPS_PER_S,
        shape=f"{NC} x {H}x{W} float32 -> int32, {NC}x{NC} matrix",
        chain_max_err_vs_input=worst)
    if worst > 1:
        raise AssertionError(f"the Part-2 MCT and its inverse are {worst} off the image")
    del r_k, s_k
    roi_in = coeffs[0].clone()
    up_k, up_p = tr.roi_up(roi_in.clone(), 4), tr.roi_up_plain(roi_in.clone(), 4)
    down_k, down_p = tr.roi_down(up_k.clone(), 4), tr.roi_down_plain(up_k.clone(), 4)
    if not torch.equal(down_k, roi_in):
        raise AssertionError("roi_down of roi_up is not the plane")
    roi_scratch = roi_in.clone()
    # the up shift is one PyTorch call, bitwise_left_shift_, timed in turns
    # with the kernel on the same plane; the down shift (a shift only where
    # the magnitude reaches 1 << s, the sign kept) is none; both warm and cold
    for name, k_out, p_out, fn, pfn, lib in (
            ("roi_up", up_k, up_p, tr.roi_up, tr.roi_up_plain,
             lambda: roi_scratch.bitwise_left_shift_(4)),
            ("roi_down", down_k, down_p, tr.roi_down, tr.roi_down_plain, None)):
        stats[name] = dict(
            max_abs_err=int((k_out - p_out).abs().max()),
            **timer.row(lambda: fn(roi_scratch, 4), lib, cold=True, bytes_=8 * npx),
            plain_ms=cuda_ms(torch, lambda: pfn(roi_scratch, 4)),
            bytes=8 * npx, ops=3 * npx,
            shape=f"{H}x{W} int32 packed 5/3 plane, shift 4, in place")
    del roi_in, up_k, up_p, down_k, down_p, roi_scratch

    # K6 on the card: K-u, K-v and the horizontal halves on the level-0
    # sub-block of shard 1 of the 4096x4096 strip (its halo the neighbour's
    # row), K-w on one shard's slice of the 4K tile batch's packed
    # coefficients (the shape the path launches it at); each against its
    # plain version on the card, exactly (floats on their bits)
    x_strip = natural_image(STRIP, STRIP, 1) - 128
    sh_i = pm.split_rows(x_strip, mesh)
    sh_f = pm.split_rows(x_strip, mesh, torch.float32)
    k_sub = 1 % len(mesh)
    sub_h, sub_w = sh_i[k_sub].shape
    nxt = sh_i[(k_sub + 1) % len(mesh)][0].clone()
    nxt_f = sh_f[(k_sub + 1) % len(mesh)][0].clone()
    sub_px = sub_h * sub_w

    def k6_check(name, fn, plain, x, args, bytes_, ops, op_rate=INT32_OPS_PER_S, lib=None,
                 cold=False, shape=""):
        """``x``: a plane, or a list of planes that ``fn`` takes at once;
        ``lib``, if any, maps the kernel's scratch to its library call."""
        many = isinstance(x, list)
        copy = (lambda: [t.clone() for t in x]) if many else x.clone
        got, ref = copy(), copy()
        before = dict(kernels.KERNELS[name].forms)
        fn(got, *args)
        forms = {f: c - before.get(f, 0) for f, c in kernels.KERNELS[name].forms.items()
                 if c != before.get(f, 0)}
        for r in ref if many else [ref]:
            plain(r, *args)
        err = 0 if all(map(same_bits, *((got, ref) if many else ([got], [ref])))) else 1
        scratch = copy()
        stats[name] = dict(
            max_abs_err=err, **({"forms": forms} if forms else {}),
            **timer.row(lambda: fn(scratch, *args), lib and (lambda: lib(scratch)), cold,
                        bytes_),
            plain_ms=cuda_ms(torch, lambda: [plain(t, *args) for t in scratch] if many
                             else plain(scratch, *args)),
            bytes=bytes_, ops=ops, op_rate=op_rate, shape=shape)

    where = f"level-0 sub-block {sub_h}x{sub_w} of shard {k_sub} of the {STRIP}x{STRIP} strip"
    k6_check("strip53_step", k6.strip53_step, k6.strip53_step_plain, sh_i[k_sub],
             (sub_h, sub_w, nxt, False, False), 6 * sub_px, 3 * sub_px // 2,
             shape=f"int32 predict with a halo, {where}")
    for update, inv in ((False, True), (True, False), (True, True)):  # the other steps
        a, b = sh_i[k_sub].clone(), sh_i[k_sub].clone()
        k6.strip53_step(a, sub_h, sub_w, nxt, update, inv)
        k6.strip53_step_plain(b, sub_h, sub_w, nxt, update, inv)
        stats["strip53_step"]["max_abs_err"] |= int(not torch.equal(a, b))
    k6_check("strip97_step", k6.strip97_step, k6.strip97_step_plain, sh_f[k_sub],
             (sub_h, sub_w, nxt_f, False, k6.STEPS_97[0][1], False), 6 * sub_px,
             3 * sub_px // 2, op_rate=FP32_OPS_PER_S,
             shape=f"float32 ALPHA predict with a halo, {where}")
    for update, coef in k6.STEPS_97[1:]:
        for inv in (False, True):
            a, b = sh_f[k_sub].clone(), sh_f[k_sub].clone()
            k6.strip97_step(a, sub_h, sub_w, None, update, coef, inv)
            k6.strip97_step_plain(b, sub_h, sub_w, None, update, coef, inv)
            stats["strip97_step"]["max_abs_err"] |= int(not same_bits(a, b))
    # K-v warm and cold, in turns with index_select of the row permutation
    # (out of place) on the same sub-block
    perm = torch.cat([torch.arange(0, sub_h, 2), torch.arange(1, sub_h, 2)]).to(dev)
    unperm = torch.argsort(perm)
    for fn, plain, rows in ((k6.strip_pack_v, k6.strip_pack_v_plain, perm),
                            (k6.strip_unpack_v, k6.strip_unpack_v_plain, unperm)):
        k6_check(fn.__name__, fn, plain, sh_i[k_sub], (sub_h, sub_w), 8 * sub_px, 0,
                 lib=lambda x, rows=rows: x.index_select(0, rows), cold=True,
                 shape=f"int32 (5/3), {where}; library: index_select of the row permutation")
        a, b = sh_f[k_sub].clone(), sh_f[k_sub].clone()  # the 9/7 scaling
        fn(a, sub_h, sub_w)
        plain(b, sub_h, sub_w)
        stats[fn.__name__]["max_abs_err"] |= int(not same_bits(a, b))
    if hasattr(k6, "launch_pack"):  # a checkout from before K-v's forms has one form
        pack_forms(torch, timer, k6, sh_i[k_sub], sh_f[k_sub], rows_of={False: perm,
                                                                   True: unperm})
    # the horizontal halves on the level-0 sub-blocks of the card's shards in
    # one launch (slice_strip's launch: its launches and this time describe
    # the same work), then on shard k_sub's alone; their "smem" launch at
    # this sub-block
    for name, shards, ops, rate in (("dwt53_fwd_h", sh_i, 4, INT32_OPS_PER_S),
                                    ("dwt53_inv_h", sh_i, 4, INT32_OPS_PER_S),
                                    ("dwt97_fwd_h", sh_f, 13, FP32_OPS_PER_S),
                                    ("dwt97_inv_h", sh_f, 13, FP32_OPS_PER_S)):
        fn, plain = getattr(tr, name), getattr(tr, f"{name}_plain")
        card = [s for s in shards if s.device == shards[k_sub].device]
        k6_check(name, fn, plain, card, (sub_h, sub_w, 0), 8 * sub_px * len(card),
                 ops * sub_px * len(card), rate, cold=True,
                 shape=f"parity 0, the level-0 sub-blocks {sub_h}x{sub_w} of the card's "
                       f"{len(card)} shards of the {STRIP}x{STRIP} strip in one launch")
        group = stats.pop(name)
        k6_check(name, fn, plain, shards[k_sub], (sub_h, sub_w, 0), 8 * sub_px, ops * sub_px,
                 rate, cold=True, shape=f"parity 0, {where}")
        one = stats[name]
        one["bound_ms"] = max(one["bytes"] / HBM_BYTES_PER_S, one["ops"] / rate) * 1e3
        stats[name] = dict(group, one_plane={k: one[k] for k in (
            "ms", "ms_min", "ms_max", "cold_ms", "cold_ms_min", "cold_ms_max", "bytes",
            "bound_ms", "max_abs_err")})
        stats[name]["max_abs_err"] |= one["max_abs_err"]
        src = kernels.KERNELS[name].source
        threads, rows, smem, blocks = c_ints(kernels, src, f"{name}_occupancy", sub_h, sub_w,
                                             outs=4)
        stats[name].update(launch=dict(threads_a_block=threads, rows_a_block=rows,
                                       shared_bytes_a_block=smem, blocks_per_sm=blocks,
                                       blocks=len(card) * -(-sub_h // rows)),
                           ptxas=ptxas(src.rsplit(".", 1)[0]))
    long_lines(torch, tr, kernels, timer, same_bits, dev)
    form_choice(torch, tr, timer, same_bits, dev)
    del sh_i, sh_f
    # K-w at the shape make_sharded_transform launches it: one shard's slice
    # of the 4K tile batch's packed coefficients
    tiles8 = tile_batch(arr)
    packed8, _, _ = gt.make_sharded_transform(mesh, 5)(tiles8)
    shard8 = packed8[:len(tiles8) // len(mesh)].contiguous()
    del packed8
    bm_k, sum_k = k6.blk_stats(shard8)
    bm_p, sum_p = k6.blk_stats_plain(shard8)
    bytes_w = 4 * shard8.numel() + 4 * bm_k.numel() + 8
    stats["blk_stats"] = dict(
        max_abs_err=int((bm_k - bm_p).abs().max()) + (0 if sum_k.item() == sum_p.item() else 1),
        **timer.row(lambda: k6.blk_stats(shard8), bytes_=bytes_w),
        plain_ms=cuda_ms(torch, lambda: k6.blk_stats_plain(shard8)),
        bytes=bytes_w, ops=2 * shard8.numel(), op_rate=FP64_OPS_PER_S,
        shape=f"int32 {list(shard8.shape)} (one shard of the 4K tile batch, 5 levels)")
    del shard8, bm_k, bm_p

    del timer
    for name, s in stats.items():
        bytes_ms = s["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = s["ops"] / s.pop("op_rate", INT32_OPS_PER_S) * 1e3
        s["bound_ms"] = max(bytes_ms, ops_ms)
        s["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        s.update(bound_shares(s, bytes_ms))
        emit({"phase": "check", "kernel": name, "tolerance": 0, **s})
        if s["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from its plain version")

    lap("kernel_check")
    if "--check" in sys.argv[1:]:
        emit({"phase": "walls", "seconds": walls, "total": sum(walls.values())})
        print(smi, flush=True)
        return 0

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

    t0 = time.perf_counter()
    l_gpu = gt.compress(gt.Image.from_array(small), gt.CompressParams(**P97))
    t1 = time.perf_counter()
    ld_gpu = gt.decompress(l_gpu)
    t2 = time.perf_counter()
    l_cpu = gt.compress(gt.Image.from_array(small), gt.CompressParams(**P97), device="cpu")
    ld_cpu = gt.decompress(l_gpu, device="cpu")
    t3 = time.perf_counter()
    sha, ref_ok = digest_ok(l_gpu, "97 256x256x3")
    md5 = golden_md5([c.data for c in ld_gpu.components])
    dec_same = all(np.array_equal(a.data, b.data)
                   for a, b in zip(ld_gpu.components, ld_cpu.components))
    emit({"phase": "slice_97", "image": "256x256x3", "params": P97, "bytes": len(l_gpu),
          "identical": l_gpu == l_cpu, "sha256": sha, "reference_digest": ref_ok,
          "decode_equal": dec_same, "decode_md5": md5,
          "decode_reference_digest": md5 == REF_MD5["97 256x256x3"],
          "max_abs_err_vs_input": max(int(np.abs(c.data - small[:, :, k]).max())
                                      for k, c in enumerate(ld_gpu.components)),
          "gpu_enc_ms": (t1 - t0) * 1e3, "gpu_dec_ms": (t2 - t1) * 1e3,
          "plain_cpu_ms": (t3 - t2) * 1e3})
    if l_gpu != l_cpu or not ref_ok or not dec_same or md5 != REF_MD5["97 256x256x3"]:
        raise AssertionError("256x256 9/7 card stream or decode differs from the plain path "
                             "or grok_tpu's")

    # layers and PCRD at 256x256x3: grok_tpu's streams and decodes
    gt.reset_launch_counts()
    for name, kw in RC_CASES.items():
        stage = {}
        t0 = time.perf_counter()
        out = gt.compress(gt.Image.from_array(small), gt.CompressParams(**kw), stage_ms=stage)
        t1 = time.perf_counter()
        sha, ref_ok = digest_ok(out, f"{name} 256x256x3")
        md5s = [golden_md5([c.data for c in gt.decompress(
            out, gt.DecompressParams(max_layers=k)).components]) for k in (0, 1)]
        t2 = time.perf_counter()
        dec_ok = md5s == [REF_MD5[f"{name} 256x256x3 L{k}"] for k in (0, 1)]
        emit({"phase": "slice_rc", "case": name, "params": kw, "image": "256x256x3",
              "bytes": len(out), "sha256": sha, "reference_digest": ref_ok,
              "decode_md5_max_layers_0_1": md5s, "decode_reference_digests": dec_ok,
              "gpu_enc_ms": (t1 - t0) * 1e3, "gpu_dec_ms": (t2 - t1) * 1e3, "stage_ms": stage})
        if not (ref_ok and dec_ok):
            raise AssertionError(f"slice_rc {name}: the stream or a decode is not grok_tpu's")
    rc_counts = gt.launch_counts()
    emit({"phase": "slice_rc_launches", "launches": rc_counts})
    if any(rc_counts[k] <= 0 for k in RC_KERNELS + ("ht_cleanup_enc",)):
        raise AssertionError(f"a kernel of the rate-control path never launched: {rc_counts}")

    lap("slices")

    # HT at WIDE_BITS bits, 64x64x3, 5/3 and 9/7: coefficients from 2^24 up,
    # which the port once refused; the card's streams against the plain
    # path's and grok_tpu's, the decodes against the plain path's (and the
    # input, 5/3)
    wide = wide_image(64, 64, 3, WIDE_BITS)
    largest = hc.largest_magnitude
    for name, kw in WIDE_HT_CASES.items():
        seen = []
        hc.largest_magnitude = lambda c: seen.append(largest(c)) or seen[-1]  # noqa: E731
        try:
            gt.reset_launch_counts()
            t0 = time.perf_counter()
            w_gpu = gt.compress(gt.Image.from_array(wide, prec=WIDE_BITS),
                                gt.CompressParams(**kw))
            t1 = time.perf_counter()
            wd_gpu = gt.decompress(w_gpu)
            t2 = time.perf_counter()
            w_counts = gt.launch_counts()
        finally:
            hc.largest_magnitude = largest
        w_cpu = gt.compress(gt.Image.from_array(wide, prec=WIDE_BITS), gt.CompressParams(**kw),
                            device="cpu")
        wd_cpu = gt.decompress(w_gpu, device="cpu")
        sha, ref_ok = digest_ok(w_gpu, f"ht {name} 64x64x3")
        dec_same = all(np.array_equal(a.data, b.data) and (
            kw.get("irreversible") or np.array_equal(a.data, wide[:, :, c]))
            for c, (a, b) in enumerate(zip(wd_gpu.components, wd_cpu.components)))
        missing = [k for k in WIDE_HT_KERNELS[name] if w_counts[k] <= 0]
        emit({"phase": "slice_ht_wide", "case": name, "params": kw, "bits": WIDE_BITS,
              "image": "64x64x3", "largest_magnitude": max(seen), "bytes": len(w_gpu),
              "identical": w_gpu == w_cpu, "sha256": sha, "reference_digest": ref_ok,
              "decode_equal": dec_same, "gpu_enc_ms": (t1 - t0) * 1e3,
              "gpu_dec_ms": (t2 - t1) * 1e3, "not_launched": missing})
        if w_gpu != w_cpu or not ref_ok or not dec_same or missing or max(seen) < 1 << 24:
            raise AssertionError(f"slice_ht_wide {name}: the card's stream or decode differs "
                                 f"from the plain path or grok_tpu's, or the path missed "
                                 f"{missing} or 2^24")

    lap("slice_ht_wide")

    # the Part-2 MCT and component ROI at 256x256: the card's streams and
    # decodes (max_layers 0 and 1) against grok_tpu's digests; then a
    # PLAIN_CUT crop of each image through the card and the plain path
    gt.reset_launch_counts()
    ch, cw = PLAIN_CUT
    for name, (nc, kw) in MCT_ROI_CASES.items():
        img_arr = natural_image(256, 256, nc)
        key = f"{name} 256x256x{nc}"
        t0 = time.perf_counter()
        out = gt.compress(gt.Image.from_array(img_arr), gt.CompressParams(**kw))
        t1 = time.perf_counter()
        sha, ref_ok = digest_ok(out, key)
        md5s = [golden_md5([c.data for c in gt.decompress(
            out, gt.DecompressParams(max_layers=k)).components]) for k in (0, 1)]
        t2 = time.perf_counter()
        dec_ok = md5s == [REF_MD5[f"{key} L{k}"] for k in (0, 1)]
        crop = gt.Image.from_array(np.ascontiguousarray(img_arr[:ch, :cw]))
        c_gpu = gt.compress(crop, gt.CompressParams(**kw))
        c_cpu = gt.compress(crop, gt.CompressParams(**kw), device="cpu")
        crop_dec = all(np.array_equal(a.data, b.data) for k in (0, 1) for a, b in zip(
            gt.decompress(c_gpu, gt.DecompressParams(max_layers=k)).components,
            gt.decompress(c_gpu, gt.DecompressParams(max_layers=k), device="cpu").components))
        t3 = time.perf_counter()
        emit({"phase": "slice_mct_roi", "case": name, "params": kw, "image": f"256x256x{nc}",
              "bytes": len(out), "sha256": sha, "reference_digest": ref_ok,
              "decode_md5_max_layers_0_1": md5s, "decode_reference_digests": dec_ok,
              "crop": f"{ch}x{cw}x{nc}", "crop_identical": c_gpu == c_cpu,
              "crop_decode_equal": crop_dec, "gpu_enc_ms": (t1 - t0) * 1e3,
              "gpu_dec_ms": (t2 - t1) * 1e3, "crop_ms": (t3 - t2) * 1e3})
        if not (ref_ok and dec_ok and c_gpu == c_cpu and crop_dec):
            raise AssertionError(f"slice_mct_roi {name}: a stream or a decode is not "
                                 "grok_tpu's, or the card differs from the plain path")
    mr_counts = gt.launch_counts()
    emit({"phase": "slice_mct_roi_launches", "launches": mr_counts})
    if any(mr_counts[k] <= 0 for k in MCT_ROI_KERNELS):
        raise AssertionError(f"a kernel of the MCT and ROI slice never launched: {mr_counts}")

    lap("slice_mct_roi")

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

    lap("e2e")

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

    lap("e2e_dec")

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

    lap("e2e_ht")

    # ---- 8. lossy 9/7 + ICT at full size, three encodes and three decodes
    gt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    streams = []
    for i in range(3):
        stage = {}
        img = gt.Image.from_array(arr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gt.compress(img, gt.CompressParams(**P97), stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        sha, ref_ok = digest_ok(out, f"97 {H}x{W}x{NC}")
        emit({"phase": "e2e_97", "op": "encode", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "bytes": len(out), "sha256": sha,
              "reference_digest": ref_ok, "stage_ms": stage})
        if not ref_ok:
            raise AssertionError(f"9/7 request {i}: the stream is not grok_tpu's ({len(out)} B)")
        streams.append(out)
    for i, stream in enumerate(streams):
        stage = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = gt.decompress(stream, stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        md5 = golden_md5([c.data for c in back.components])
        emit({"phase": "e2e_97", "op": "decode", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "decode_md5": md5,
              "reference_digest": md5 == REF_MD5[f"97 {H}x{W}x{NC}"],
              "max_abs_err_vs_input": max(int(np.abs(c.data - arr[:, :, k]).max())
                                          for k, c in enumerate(back.components)),
              "stage_ms": stage})
        if md5 != REF_MD5[f"97 {H}x{W}x{NC}"]:
            raise AssertionError(f"9/7 decode {i}: not grok_tpu's decode")
    l_counts = gt.launch_counts()
    emit({"phase": "e2e_97_launches", "image": f"{W}x{H}x{NC} lossy97 (no rate target)",
          "requests": 3, "launches": l_counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if any(l_counts[k] <= 0 for k in K97_KERNELS):
        raise AssertionError(f"a kernel of the 9/7 path never launched: {l_counts}")
    for k in K97_KERNELS:
        if k not in counts or counts[k] == 0:
            counts[k] = l_counts[k]
    del streams

    lap("e2e_97")

    # ---- 8b. bench.py's lossy97_1bpp at full size: 9/7 + ICT with PCRD to
    # a rate of 8:1, three encodes and three decodes
    gt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    streams = []
    for i in range(3):
        stage = {}
        img = gt.Image.from_array(arr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gt.compress(img, gt.CompressParams(**P1BPP), stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        sha, ref_ok = digest_ok(out, f"1bpp {H}x{W}x{NC}")
        emit({"phase": "e2e_1bpp", "op": "encode", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "bytes": len(out),
              "bits_per_pixel": 8 * len(out) / (W * H), "sha256": sha,
              "reference_digest": ref_ok, "stage_ms": stage})
        if not ref_ok:
            raise AssertionError(f"1bpp request {i}: the stream is not grok_tpu's ({len(out)} B)")
        streams.append(out)
    for i, stream in enumerate(streams):
        stage = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = gt.decompress(stream, stage_ms=stage)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) * 1e3
        md5 = golden_md5([c.data for c in back.components])
        emit({"phase": "e2e_1bpp", "op": "decode", "request": i, "e2e_ms": e2e,
              "mp_per_s": W * H / 1e6 / (e2e / 1e3), "decode_md5": md5,
              "reference_digest": md5 == REF_MD5[f"1bpp {H}x{W}x{NC}"],
              "max_abs_err_vs_input": max(int(np.abs(c.data - arr[:, :, k]).max())
                                          for k, c in enumerate(back.components)),
              "stage_ms": stage})
        if md5 != REF_MD5[f"1bpp {H}x{W}x{NC}"]:
            raise AssertionError(f"1bpp decode {i}: not grok_tpu's decode")
    b_counts = gt.launch_counts()
    emit({"phase": "e2e_1bpp_launches", "image": f"{W}x{H}x{NC} lossy97_1bpp", "requests": 3,
          "launches": b_counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if any(b_counts[k] <= 0 for k in K1BPP_KERNELS):
        raise AssertionError(f"a kernel of the 1bpp path never launched: {b_counts}")
    for k in RC_KERNELS:
        counts[k] = b_counts[k]
    del streams

    lap("e2e_1bpp")

    # ---- 8c. the Part-2 MCT (PMCT, 9/7 Part-1) and component ROI (PROI,
    # 5/3 Part-1 and HT) at full size: three encodes and three decodes each
    def e2e_phase(phase, kw, ref_key, kernel_names):
        gt.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        streams = []
        for i in range(3):
            stage = {}
            img = gt.Image.from_array(arr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gt.compress(img, gt.CompressParams(**kw), stage_ms=stage)
            torch.cuda.synchronize()
            e2e = (time.perf_counter() - t0) * 1e3
            sha, ref_ok = digest_ok(out, ref_key)
            emit({"phase": phase, "op": "encode", "request": i, "e2e_ms": e2e,
                  "mp_per_s": W * H / 1e6 / (e2e / 1e3), "bytes": len(out), "sha256": sha,
                  "reference_digest": ref_ok, "stage_ms": stage})
            if not ref_ok:
                raise AssertionError(f"{phase} request {i}: the stream is not grok_tpu's")
            streams.append(out)
        for i, stream in enumerate(streams):
            stage = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = gt.decompress(stream, stage_ms=stage)
            torch.cuda.synchronize()
            e2e = (time.perf_counter() - t0) * 1e3
            planes_out = [c.data for c in back.components]
            if ref_key in REF_MD5:
                md5 = golden_md5(planes_out)
                ok, check = md5 == REF_MD5[ref_key], {"decode_md5": md5}
            else:
                ok = all(np.array_equal(a, arr[:, :, k]) for k, a in enumerate(planes_out))
                check = {"exact": ok}
            emit({"phase": phase, "op": "decode", "request": i, "e2e_ms": e2e,
                  "mp_per_s": W * H / 1e6 / (e2e / 1e3), **check, "stage_ms": stage})
            if not ok:
                raise AssertionError(f"{phase} decode {i}: not grok_tpu's decode")
        got = gt.launch_counts()
        emit({"phase": f"{phase}_launches", "image": f"{W}x{H}x{NC}", "params": kw,
              "requests": 3, "launches": got,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if any(got[k] <= 0 for k in kernel_names):
            raise AssertionError(f"a kernel of the {phase} path never launched: {got}")
        return got

    m_counts = e2e_phase("e2e_mct", PMCT, f"mct {H}x{W}x{NC}", MCT_KERNELS)
    counts["dc_mct_fwd"] = m_counts["dc_mct_fwd"]
    counts["mct_inv_round_clip"] = m_counts["mct_inv_round_clip"]
    lap("e2e_mct")
    counts["roi_up"] = e2e_phase("e2e_roi", PROI, f"roi {H}x{W}x{NC}", ROI_KERNELS)["roi_up"]
    lap("e2e_roi")
    counts["roi_down"] = e2e_phase("e2e_roi_ht", PROI_HT, f"roi_ht {H}x{W}x{NC}",
                                   ROI_HT_KERNELS)["roi_down"]
    lap("e2e_roi_ht")

    k6_counts, forms = k6_phases(torch, mesh, dev, arr, x_strip, tiles8, lap)
    counts.update(k6_counts)

    # ---- 9. truncated streams: the card's planes equal the plain path's
    cuts = cut_streams(gt)
    gt.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = [[c.data for c in gt.decompress(data).components] for _, data in cuts]
    t1 = time.perf_counter()
    same = [all(np.array_equal(a, b.data)
                for a, b in zip(got, gt.decompress(data, device="cpu").components))
            for got, (_, data) in zip(on_card, cuts)]
    emit({"phase": "truncated", "cuts": [k for k, _ in cuts], "equal": same,
          "gpu_ms": (t1 - t0) * 1e3, "launches": gt.launch_counts()})
    if not all(same):
        raise AssertionError("a truncated stream decodes differently on the card")

    lap("truncated")

    # ---- 10. the corpus: every stream identical to grok_tpu's decode or
    # refused by name
    from pathlib import Path

    corpus = Path(__file__).resolve().parent / "tests" / "corpus"
    manifest = {e["name"]: e for e in json.loads((corpus / "manifest.json").read_text())}
    tally = {"identical": [], "refused": {}, "differ": [], "unpinned": []}
    t0 = time.perf_counter()
    for name in sorted(n for n in manifest if n.endswith(".j2k")):
        data = (corpus / "streams" / name).read_bytes()
        try:
            img = gt.decompress(data, gt.DecompressParams(**manifest[name].get("decode", {})))
        except gt.UnsupportedFeatureError as e:
            tally["refused"][name] = str(e)
            continue
        md5 = golden_md5([c.data for c in img.components])
        key = ("identical" if md5 == CORPUS_REF_MD5.get(name)
               else "differ" if name in CORPUS_REF_MD5 else "unpinned")
        tally[key].append(name)
    emit({"phase": "corpus", "streams": sum(map(len, tally.values())),
          "identical": len(tally["identical"]), "refused": len(tally["refused"]),
          "differ": tally["differ"], "unpinned": tally["unpinned"],
          "refused_by": tally["refused"], "seconds": time.perf_counter() - t0})
    missing = sorted(set(CORPUS_REF_MD5) - set(tally["identical"]))
    if tally["differ"] or tally["unpinned"] or missing:
        raise AssertionError(f"corpus: differ {tally['differ']}, unpinned {tally['unpinned']}, "
                             f"pinned but not decoded {missing}")

    lap("corpus")
    emit({"phase": "walls", "seconds": walls, "total": sum(walls.values())})
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": f"grok_tpu_torch/csrc/{k.source}",
         "replaces": k.replaces, "launches": counts[k.name],
         **({"forms": forms[k.name]} if k.name in forms else {}),
         **{key: stats[k.name][key] for key in ("bound_ms_segments", "x_bound_segments",
                                                "bound_ms_rows", "x_bound_rows")
            if key in stats[k.name]},
         "max_abs_err": stats[k.name]["max_abs_err"], "ms": stats[k.name]["ms"],
         "l2": stats[k.name]["l2"], "plain_ms": stats[k.name]["plain_ms"],
         "bound_ms": stats[k.name]["bound_ms"], "bound_by": stats[k.name]["bound_by"],
         "library_ms": stats[k.name]["library_ms"]}
        for k in kernels.KERNELS.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
