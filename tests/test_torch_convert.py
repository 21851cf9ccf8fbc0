"""grok_tpu_torch.convert: grok_tpu's coding tables and parameters carried
into the port's tensors and dataclasses, held against the port's own
built-in copies."""

import dataclasses

import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.codestream.quantizer import band_norm as ref_band_norm
from grok_tpu.ops import dwt, mct
from grok_tpu.t1 import ebcot_np, ht, mq_np
from grok_tpu_torch import convert
from grok_tpu_torch.ops import transform as tr
from grok_tpu_torch.t1 import ht as port_ht
from grok_tpu_torch.t1.ebcot_cuda import device_tables
from grok_tpu_torch.t1.ht_cuda import ht_tables
from grok_tpu.codestream.compress import build_siz as ref_build_siz
from grok_tpu.codestream.compress import build_tcp as ref_build_tcp
from grok_tpu.tile.tile_processor import TileProcessor as RefTileProcessor
from grok_tpu_torch.codestream.compress import build_siz as port_build_siz
from grok_tpu_torch.codestream.compress import build_tcp as port_build_tcp
from grok_tpu_torch.tile.tile_processor import TileProcessor


def _reference_tables() -> dict:
    return {
        "_ZC_LUT": ebcot_np._ZC_LUT, "_SC_CTX": ebcot_np._SC_CTX, "_SC_XOR": ebcot_np._SC_XOR,
        "QE": mq_np.QE, "NMPS": mq_np.NMPS, "NLPS": mq_np.NLPS, "SWITCH": mq_np.SWITCH,
        **{k: np.array([[ref_band_norm(irrev, o, lv)
                         for lv in range(1, convert.NORM_LEVELS + 1)] for o in range(4)])
           for k, irrev in (("band_norms", False), ("band_norms97", True))},
        "LIFT97": np.float32([dwt.ALPHA, dwt.BETA, dwt.GAMMA, dwt.DELTA, dwt.K, 1.0 / dwt.K]),
        "ICT_FWD": mct._ICT_FWD.astype(np.float32),
        "ICT_INV": mct._ICT_INV.astype(np.float32),
        "ICT_INV64": mct._ICT_INV,
        # the linearised inverse RCT of grok_tpu's _mct_weights
        "RCT_INV_LINEAR": np.array([[1.0, -0.25, 0.75], [1.0, -0.25, -0.25],
                                    [1.0, 0.75, -0.25]]),
        **{k: getattr(ht, k) for k in convert.HT_TABLES},
    }


def test_reference_tables_equal_builtin_copies():
    ref = convert.tables_from_numpy(_reference_tables(), device="cpu")
    own = convert.builtin_tables(device="cpu")
    assert set(ref) == set(own) == {"ctx", "mq", "band_norms", "band_norms97", "lift97",
                                    "ict_fwd", "ict_inv", "ht", "ict_inv64",
                                    "rct_inv_linear", "mct_w97", "mct_w53"}
    assert torch.equal(ref["ctx"], own["ctx"]) and ref["ctx"].dtype == torch.int32
    assert torch.equal(ref["mq"], own["mq"]) and tuple(ref["mq"].shape) == (4, 47)
    # the norms come from the same float64 recurrences: equal to the last bit
    assert torch.equal(ref["band_norms"], own["band_norms"])
    assert torch.equal(ref["band_norms97"], own["band_norms97"])


def test_reference_97_tables_equal_builtin_copies():
    """The 9/7 lifting constants and the ICT matrices, rounded to float32 as
    grok_tpu's host path uses them, equal the port's, and are what its
    plain versions compute with."""
    ref = convert.tables_from_numpy(_reference_tables(), device="cpu")
    own = convert.builtin_tables(device="cpu")
    for k in ("lift97", "ict_fwd", "ict_inv"):
        assert own[k].dtype == torch.float32 and torch.equal(ref[k], own[k]), k
    assert own["lift97"].tolist() == list(tr.LIFT97)
    assert own["ict_fwd"].tolist() == [list(r) for r in tr.ICT_FWD]
    assert own["ict_inv"].tolist() == [list(r) for r in tr.ICT_INV]
    # and they are what the kernels are given
    dev = device_tables(torch.device("cpu"))
    assert torch.equal(dev["ctx"], own["ctx"]) and torch.equal(dev["mq"], own["mq"])


@pytest.mark.parametrize("irreversible,mct_on,nc", [
    (True, True, 3), (False, True, 3), (True, True, 4), (False, None, 4), (True, 0, 3),
    (False, None, 1), (True, None, 2)])
def test_mct_weights_equal_reference(irreversible, mct_on, nc):
    """Rate control's MCT weights: the float64 inverse matrices equal
    grok_tpu's to the last bit, their column norms are what its
    _mct_weights gives for the same image and parameters, and the port's
    tile processor uses them."""
    ref = convert.tables_from_numpy(_reference_tables(), device="cpu")
    own = convert.builtin_tables(device="cpu")
    for k in ("ict_inv64", "rct_inv_linear", "mct_w97", "mct_w53"):
        assert own[k].dtype == torch.float64 and torch.equal(ref[k], own[k]), k
    arr = np.zeros((8, 8, nc), dtype=np.int32)
    kw = dict(irreversible=irreversible, mct=mct_on, num_resolutions=2)
    img = gk.Image.from_array(arr)
    img.finalize()
    want = RefTileProcessor(ref_build_siz(img, gk.CompressParams(**kw)),
                            ref_build_tcp(img, gk.CompressParams(**kw)), 0)._mct_weights()
    pimg = gt.Image.from_array(arr)
    pimg.finalize()
    pp = gt.CompressParams(**kw)
    got = TileProcessor(port_build_siz(pimg, pp), port_build_tcp(pimg, pp), 0, "cpu",
                        pp)._mct_weights()
    assert got == want
    if nc >= 3 and mct_on != 0:
        assert got[:3] == own["mct_w97" if irreversible else "mct_w53"].tolist()


def test_reference_ht_tables_equal_builtin_copies():
    """The HT coder's tables, in the kernels' layout and as the scalar coder
    holds them, equal grok_tpu.t1.ht's."""
    ref = convert.tables_from_numpy(_reference_tables(), device="cpu")["ht"]
    own = convert.builtin_tables(device="cpu")["ht"]
    assert ref.dtype == torch.int32 and torch.equal(ref, own)
    assert torch.equal(own, ht_tables(torch.device("cpu")))
    for k in convert.HT_TABLES:
        assert getattr(port_ht, k) == getattr(ht, k), k


@pytest.mark.parametrize("key,cut", [("ENC_TBL", 1), ("_U_SUF", 32), ("MEL_EXP", 12)])
def test_ht_tables_of_the_wrong_shape_raise(key, cut):
    d = _reference_tables()
    d[key] = d[key][:cut]
    with pytest.raises(ValueError):
        convert.tables_from_numpy(d)


def test_tables_of_the_wrong_shape_raise():
    d = _reference_tables()
    d["QE"] = d["QE"][:46]
    with pytest.raises(ValueError):
        convert.tables_from_numpy(d)
    for key, cut in (("band_norms", np.s_[:, :5]), ("band_norms97", np.s_[:2]),
                     ("LIFT97", np.s_[:5]), ("ICT_INV", np.s_[:2]),
                     ("ICT_INV64", np.s_[:, :2]), ("RCT_INV_LINEAR", np.s_[:1])):
        d = _reference_tables()
        d[key] = d[key][cut]
        with pytest.raises(ValueError):
            convert.tables_from_numpy(d)


@pytest.mark.parametrize("kw", [
    {},
    dict(num_resolutions=3, cblk_width=32, cblk_height=16, cblk_style=0x3F,
         progression=gk.ProgressionOrder.CPRL, tile_size=(64, 32), tile_offset=(1, 2),
         image_offset=(3, 4), comment="x", guard_bits=1, mct=0),
])
def test_params_carry_over(kw):
    ref = gk.CompressParams(**kw)
    got = convert.params_from_dict(dataclasses.asdict(ref))
    assert isinstance(got, gt.CompressParams)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert isinstance(got.progression, gt.ProgressionOrder)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]


def test_default_params_agree_with_reference():
    assert dataclasses.asdict(gt.CompressParams()) == dataclasses.asdict(gk.CompressParams())


def test_unknown_param_field_raises():
    with pytest.raises(gt.ParameterError):
        convert.params_from_dict({"num_resolutions": 3, "no_such_field": 1})
