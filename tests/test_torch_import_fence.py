"""The port never imports JAX or the JAX package: a fresh interpreter
imports every ``repro_torch`` module (and ``chip_smoke``), then no ``jax``
and no ``repro`` / ``repro.*`` module may be loaded.  ``repro_torch``
itself starts with "repro", so names are matched exactly or by the
``repro.`` prefix."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "repro" or m.startswith("repro.")
)
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for module in ("repro_torch.core.session", "repro_torch.kernels._cuda",
                   "repro_torch.kernels.flash_attention.flash_attention",
                   "repro_torch.kernels.decode_attention.decode_attention",
                   "repro_torch.kernels.bootstrap.bootstrap",
                   "repro_torch.kernels.ssd.ssd", "repro_torch.models.ssm",
                   "repro_torch.kernels.bertscore.bertscore",
                   "repro_torch.kernels.bertscore.ops",
                   "repro_torch.kernels.bertscore.ref",
                   "repro_torch.kernels.bootstrap.ops",
                   "repro_torch.metrics.semantic", "repro_torch.metrics.registry",
                   "repro_torch.stats.special", "repro_torch.stats.bootstrap",
                   "repro_torch.stats.significance", "repro_torch.stats.effect",
                   "repro_torch.stats.select", "repro_torch.storage.deltalite",
                   "repro_torch.core.cache", "repro_torch.core.service",
                   "repro_torch.core.compare", "repro_torch.core.suite"):
        assert module in out["imported"]


def test_port_sources_do_not_name_jax_or_repro_modules():
    """A second fence over the text: no import of jax or of a repro.*
    module anywhere in the port or in chip_smoke.py."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod != "jax" and not mod.startswith(("jax.", "repro.")) \
                    and mod != "repro", f"{f}: {s}"
