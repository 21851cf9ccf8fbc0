"""Carry-over of the codec's "weights": its coding tables and configuration.

A codec has no trained weights; what must agree between grok_tpu and the
port is its tables (EBCOT zero/sign-coding contexts and the MQ state
machine, which the Part-1 encoder and decoder kernels both load; the 5/3
and 9/7 band synthesis norms; the 9/7 lifting constants and the ICT
matrices as float32; the float64 inverse ICT and linearised inverse RCT
whose column norms weigh rate control's distortions; the HT coder's
CxtVLC, MEL and u-code tables) and its parameters. These helpers
take the reference's values as plain numpy arrays and dicts, so the port
never imports the reference to use them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .codestream.quantizer import band_norm
from .core.errors import ParameterError
from .core.params import CompressParams, ProgressionChange, ProgressionOrder, QuantStyle
from .ops import transform
from .t1 import ht
from .t1.ebcot import SC_CTX, SC_XOR, ZC_LUT, ctx_table
from .t1.ht_cuda import pack_ht_tables
from .t1.mq import NLPS, NMPS, QE, SWITCH, mq_table
from .t2.rate_control import ICT_INV64, RCT_INV_LINEAR, mct_column_weights

HT_TABLES = ("MEL_EXP", "ENC_TBL", "DEC_TBL", "_U_PRE", "_U_PRE_LEN", "_U_SUF", "_U_SUF_LEN")

NORM_LEVELS = 33


def tables_from_numpy(d: dict, device=None) -> dict[str, torch.Tensor]:
    """The port's table tensors on ``device`` from numpy arrays named as in
    grok_tpu: _ZC_LUT [4, 45], _SC_CTX [9], _SC_XOR [9] (t1/ebcot_np.py),
    QE, NMPS, NLPS, SWITCH [47] (t1/mq_np.py), band_norms and band_norms97
    [4, 33], the 5/3 and 9/7 synthesis norm of each (orient, level 1..33)
    (codestream/quantizer.py), LIFT97 [6] (ops/dwt.py ALPHA, BETA, GAMMA,
    DELTA, K and 1/K), ICT_FWD and ICT_INV [3, 3] (ops/mct.py _ICT_FWD,
    _ICT_INV), the last three as float32, ICT_INV64 and RCT_INV_LINEAR
    [3, 3] float64 (mct._ICT_INV and tile_processor._mct_weights' linearised
    inverse RCT), which also give "mct_w97" and "mct_w53" [3], the MCT
    weights of rate control (their column norms), and the HT tables of
    t1/ht.py (HT_TABLES: MEL_EXP [13], ENC_TBL [2, 2048], DEC_TBL
    [2][8][128] entries or None, the u-code tables [33]), which give "ht"
    in the HT kernels' layout (t1/ht_cuda.pack_ht_tables)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k]).astype(np.int64))
         for k in ("_ZC_LUT", "_SC_CTX", "_SC_XOR", "QE", "NMPS", "NLPS", "SWITCH")}
    if t["_ZC_LUT"].shape != (4, 45) or any(t[k].shape != (47,)
                                            for k in ("QE", "NMPS", "NLPS", "SWITCH")):
        raise ValueError("table shapes differ from the reference's")
    out = {
        "ctx": ctx_table(t["_ZC_LUT"], t["_SC_CTX"], t["_SC_XOR"]).to(device),
        "mq": mq_table(t["QE"], t["NMPS"], t["NLPS"], t["SWITCH"]).to(device),
        "ht": pack_ht_tables(*(d[k] for k in HT_TABLES)).to(device),
    }
    for key, dtype, shape in (("band_norms", np.float64, (4, NORM_LEVELS)),
                              ("band_norms97", np.float64, (4, NORM_LEVELS)),
                              ("LIFT97", np.float32, (6,)), ("ICT_FWD", np.float32, (3, 3)),
                              ("ICT_INV", np.float32, (3, 3)),
                              ("ICT_INV64", np.float64, (3, 3)),
                              ("RCT_INV_LINEAR", np.float64, (3, 3))):
        a = np.asarray(d[key], dtype=dtype)
        if a.shape != shape:
            raise ValueError(f"{key} must be {list(shape)}")
        out[key.lower()] = torch.from_numpy(a.copy()).to(device)
    for key, m in (("mct_w97", "ICT_INV64"), ("mct_w53", "RCT_INV_LINEAR")):
        w = mct_column_weights(np.asarray(d[m], dtype=np.float64))
        out[key] = torch.tensor(w, dtype=torch.float64, device=device)
    return out


def builtin_tables(device=None) -> dict[str, torch.Tensor]:
    """The port's own copies, in the layout of ``tables_from_numpy``."""
    return tables_from_numpy({
        "_ZC_LUT": ZC_LUT.numpy(), "_SC_CTX": SC_CTX.numpy(), "_SC_XOR": SC_XOR.numpy(),
        "QE": QE.numpy(), "NMPS": NMPS.numpy(), "NLPS": NLPS.numpy(),
        "SWITCH": SWITCH.numpy(),
        **{k: np.array([[band_norm(o, lv, irrev) for lv in range(1, NORM_LEVELS + 1)]
                        for o in range(4)], dtype=np.float64)
           for k, irrev in (("band_norms", False), ("band_norms97", True))},
        "LIFT97": np.array(transform.LIFT97, dtype=np.float32),
        "ICT_FWD": np.array(transform.ICT_FWD, dtype=np.float32),
        "ICT_INV": np.array(transform.ICT_INV, dtype=np.float32),
        "ICT_INV64": ICT_INV64, "RCT_INV_LINEAR": RCT_INV_LINEAR,
        **{k: getattr(ht, k) for k in HT_TABLES},
    }, device)


def mct_arrays_from_numpy(dec_matrix, offsets) -> tuple[torch.Tensor, list[float]]:
    """A Part-2 MCT as the inverse transform takes it (ops/transform.py
    inverse_transform ``custom`` and ``offsets``) from the reference's parsed
    arrays (its Tcp ``mct_dec_matrix`` [N, N] and ``mct_offsets`` [N]): the
    decoding matrix rounded to float32, as its host path applies it, and the
    offsets as floats."""
    m = np.asarray(dec_matrix, dtype=np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1] or len(offsets) != m.shape[0]:
        raise ValueError("a Part-2 MCT needs an N x N matrix and N offsets")
    return torch.from_numpy(m.astype(np.float32)), [float(o) for o in offsets]


def params_from_dict(d: dict) -> CompressParams:
    """CompressParams from a plain dict of its fields (e.g.
    ``dataclasses.asdict`` of grok_tpu's CompressParams)."""
    names = {f.name for f in dataclasses.fields(CompressParams)}
    unknown = set(d) - names
    if unknown:
        raise ParameterError(f"unknown CompressParams fields: {sorted(unknown)}")
    kw = dict(d)
    if "progression" in kw:
        kw["progression"] = ProgressionOrder(int(kw["progression"]))
    if kw.get("quant_style") is not None:
        kw["quant_style"] = QuantStyle(int(kw["quant_style"]))
    if kw.get("progression_changes"):
        kw["progression_changes"] = [
            pc if isinstance(pc, ProgressionChange)
            else ProgressionChange(**{**pc, "order": ProgressionOrder(int(pc["order"]))})
            for pc in kw["progression_changes"]]
    for k in ("tile_size", "tile_offset", "image_offset"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    return CompressParams(**kw)
