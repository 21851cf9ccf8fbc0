"""grok_tpu_torch stands alone: it imports neither JAX nor grok_tpu."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "grok_tpu_torch"

_PROBE = """
import json, sys
import numpy as np
import grok_tpu_torch as gt
img = gt.Image.from_array(np.arange(96, dtype=np.int32).reshape(8, 4, 3) % 256, prec=8)
out = gt.compress(img, gt.CompressParams(num_resolutions=2), device="cpu")
ht = gt.compress(img, gt.CompressParams(num_resolutions=2, ht=True), device="cpu")
same = all(np.array_equal(c.data, img.components[i].data)
           for s in (ht, out)
           for i, c in enumerate(gt.decompress(s, device="cpu").components))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "grok_tpu" or m.startswith("grok_tpu."))
print(json.dumps({"bytes": len(out), "ends": out[-2:].hex(), "bad": bad, "roundtrip": same}))
"""


def test_compress_loads_no_jax_and_no_grok_tpu():
    """compress and decompress (Part-1 and HT), in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["bytes"] > 0 and res["ends"] == "ffd9" and res["roundtrip"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_sources_import_no_jax_and_no_grok_tpu():
    sources = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 20
    forbidden = re.compile(r"^(jax|jaxlib|grok_tpu\b(?!_torch))")
    offenders = {str(p.relative_to(ROOT)): bad for p in sources
                 if (bad := [m for m in _imports(p) if forbidden.match(m)])}
    assert offenders == {}
    text = re.compile(r"^\s*(import|from)\s+(jax|grok_tpu\b(?!_torch))", re.M)
    assert [str(p) for p in sources if text.search(p.read_text())] == []
