"""The port against grok_tpu on tests/corpus/streams, on the CPU (the
kernels' plain versions): every stream a grok_tpu user could hand it.

The in-slice streams in FAST decode with the manifest's decode parameters
to planes sample-identical to grok_tpu.decompress's. The plain Part-1
decoder steps all codeblocks of a batch in lockstep at about 0.2 ms a
decision, so only streams the plain path finishes in a few seconds are
here, and the five RGN streams (20-45 s each: ROI shifts add bit-planes),
the only corpus streams of the ROI path. The other in-slice streams (74) are left out; chip_smoke.py's corpus
phase decodes every stream on the card against grok_tpu's digests
(CORPUS_REF_MD5). They are:
  allstyles, big_offset, bypass, bypass_ht_mix_gray, cblk_1024x4,
  cblk_128x32, cblk_16x64_tiles, cblk_4x1024, cmyk8, cmyk8_tiles,
  coc_qcc_redundant, comment_marker, comment_tiles_layers, cprl,
  cprl_tiny_tiles, crg_gray, crg_rgb_tiles, gray10_tiles, gray12,
  gray12_tiles_layers, gray14_bypass, gray16, gray16_tiles, gray6,
  guard3, guard4_gray12, layers, layers10, layers10_l7, layers6,
  layers6_l3, layers8_gray, levels2, lossless_gray, lossless_odd,
  lossless_rgb, lossy97, lossy97_gray, lossy97_psnr, lossy97_tiles,
  mode_all_0x3f, mode_all_tiles16, mode_bypass_reset, mode_pterm,
  mode_pterm_segsym, mode_reset_termall, mode_segsym, mode_vsc, offset,
  offset_tiles, pcrl, pcrl_tiles_layers, psnr4_l2, psnr_layers, pterm,
  res2_offset, res7, res8_big, reset, rlcp, rlcp_bypass_layers,
  rlcp_layers_l1, rlcp_offset_tiles, rpcl_tiles, segsym, single_res,
  sub420_16, sub420_8, termall, tiles, tp_divider_C, tp_divider_R, vsc,
  ycc_off.

The streams in REFUSED raise UnsupportedFeatureError naming the feature
that is outside the ported slices. Every .j2k of the corpus is in one of
the three sets."""

import json
from pathlib import Path

import numpy as np
import pytest

import grok_tpu as gk
import grok_tpu_torch as gt

CORPUS = Path(__file__).resolve().parent / "corpus"
MANIFEST = {e["name"]: e for e in json.loads((CORPUS / "manifest.json").read_text())}
FAST = [
    "cblk16.j2k",
    "cblk_4x4.j2k",
    "coc_qcc_redundant_ht.j2k",
    "col_200x1.j2k",
    "gray12_ht.j2k",
    "gray2.j2k",
    "gray4.j2k",
    "ht.j2k",
    "ht_cblk32x128.j2k",
    "ht_gray.j2k",
    "ht_gray16.j2k",
    "ht_psnr.j2k",
    "layers8_l5.j2k",
    "lossy97_gray16.j2k",
    "lossy97_ht.j2k",
    "lossy97_rates.j2k",
    "lossy97_tiles_l1.j2k",
    "roi_both_comps.j2k",
    "roi_c0_u4.j2k",
    "roi_c1_u6_tiles.j2k",
    "roi_gray16.j2k",
    "roi_lossy.j2k",
    "row_1x200.j2k",
    "sub420_16_ht.j2k",
    "tiny_5x3.j2k",
    "tp_divider_R_ht.j2k",
]
LEFT_OUT = [
    'allstyles.j2k', 'big_offset.j2k', 'bypass.j2k', 'bypass_ht_mix_gray.j2k',
    'cblk_1024x4.j2k', 'cblk_128x32.j2k', 'cblk_16x64_tiles.j2k', 'cblk_4x1024.j2k',
    'cmyk8.j2k', 'cmyk8_tiles.j2k', 'coc_qcc_redundant.j2k', 'comment_marker.j2k',
    'comment_tiles_layers.j2k', 'cprl.j2k', 'cprl_tiny_tiles.j2k', 'crg_gray.j2k',
    'crg_rgb_tiles.j2k', 'gray10_tiles.j2k', 'gray12.j2k', 'gray12_tiles_layers.j2k',
    'gray14_bypass.j2k', 'gray16.j2k', 'gray16_tiles.j2k', 'gray6.j2k', 'guard3.j2k',
    'guard4_gray12.j2k', 'layers.j2k', 'layers10.j2k', 'layers10_l7.j2k', 'layers6.j2k',
    'layers6_l3.j2k', 'layers8_gray.j2k', 'levels2.j2k', 'lossless_gray.j2k',
    'lossless_odd.j2k', 'lossless_rgb.j2k', 'lossy97.j2k', 'lossy97_gray.j2k',
    'lossy97_psnr.j2k', 'lossy97_tiles.j2k', 'mode_all_0x3f.j2k',
    'mode_all_tiles16.j2k', 'mode_bypass_reset.j2k', 'mode_pterm.j2k',
    'mode_pterm_segsym.j2k', 'mode_reset_termall.j2k', 'mode_segsym.j2k',
    'mode_vsc.j2k', 'offset.j2k', 'offset_tiles.j2k', 'pcrl.j2k',
    'pcrl_tiles_layers.j2k', 'psnr4_l2.j2k', 'psnr_layers.j2k', 'pterm.j2k',
    'res2_offset.j2k', 'res7.j2k', 'res8_big.j2k', 'reset.j2k', 'rlcp.j2k',
    'rlcp_bypass_layers.j2k', 'rlcp_layers_l1.j2k', 'rlcp_offset_tiles.j2k',
    'rpcl_tiles.j2k', 'segsym.j2k', 'single_res.j2k', 'sub420_16.j2k', 'sub420_8.j2k',
    'termall.j2k', 'tiles.j2k', 'tp_divider_C.j2k', 'tp_divider_R.j2k', 'vsc.j2k',
    'ycc_off.j2k',
]
REFUSED = {  # stream: the feature its refusal names
    "cprl_aligned_tiles.j2k": "precinct sizes",
    "cprl_ht_prec.j2k": "precinct sizes",
    "gray16_bypass_layers.j2k": "precinct sizes",
    "gray16_bypass_layers_l1.j2k": "precinct sizes",
    "ht_layers_tiles.j2k": "PLT",
    "ht_rpcl_prec.j2k": "precinct sizes",
    "ht_sop_eph.j2k": "SOP/EPH",
    "lossy97_reduce2.j2k": "reduce",
    "lossy_reduce1_layers.j2k": "reduce",
    "pcrl_gray16_sop.j2k": "SOP/EPH",
    "plt_cprl_reduce1.j2k": "reduce",
    "plt_pcrl_layers_l2.j2k": "precinct sizes",
    "plt_rpcl_layers.j2k": "precinct sizes",
    "plt_rpcl_layers_l1.j2k": "precinct sizes",
    "poc_ht.j2k": "POC",
    "poc_tilepart_accumulate.j2k": "POC",
    "poc_two_seg.j2k": "POC",
    "ppm_main.j2k": "PPM",
    "ppm_tiles.j2k": "PPM",
    "ppm_tiles_tpdiv.j2k": "PPM",
    "prec_per_res.j2k": "precinct sizes",
    "precincts.j2k": "precinct sizes",
    "res7_reduce3.j2k": "reduce",
    "res8_reduce5.j2k": "reduce",
    "sop_eph.j2k": "SOP/EPH",
    "sop_eph_ht.j2k": "SOP/EPH",
    "tlm_ht_rpcl.j2k": "PLT",
    "tlm_plt.j2k": "PLT",
    "tlm_plt_tiles.j2k": "PLT",
}


def _decode_params(mod, name):
    return mod.DecompressParams(**MANIFEST[name].get("decode", {}))


@pytest.mark.parametrize("name", FAST)
def test_stream_decodes_like_the_reference(name):
    data = (CORPUS / "streams" / name).read_bytes()
    want = gk.decompress(data, _decode_params(gk, name))
    got = gt.decompress(data, _decode_params(gt, name), device="cpu")
    assert len(got.components) == len(want.components)
    for a, b in zip(got.components, want.components):
        np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_stream_outside_the_slices_is_refused_by_name(name):
    data = (CORPUS / "streams" / name).read_bytes()
    with pytest.raises(gt.UnsupportedFeatureError, match=REFUSED[name]):
        gt.decompress(data, _decode_params(gt, name), device="cpu")


def test_every_corpus_stream_is_classified():
    streams = {n for n in MANIFEST if n.endswith(".j2k")}
    assert set(FAST) | set(LEFT_OUT) | set(REFUSED) == streams
    assert len(FAST) + len(LEFT_OUT) + len(REFUSED) == len(streams) == 129
