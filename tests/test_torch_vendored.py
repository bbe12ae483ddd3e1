"""The port imports nothing of the JAX package, and its copies do not drift.

``exonerate_tpu_torch`` keeps its own copy of the host layer it shares
with ``exonerate_tpu`` (sequences, matrices, models, seeding, oracles,
native C++ engines, output formats), under the same relative paths.  The
first test walks the syntax tree of every module of the port, of
``chip_smoke.py`` and of the band-scan cases that script shares with the
tests, and finds no import of ``jax``, of ``exonerate_tpu`` or of the
repository's ``tools`` (whose ``vpu16.py`` the port's ``tools/vpu16.py``
replaces).  The
second holds each copy's text equal to its JAX-package module's text
after the package-name rewrite, both read as files, never imported.  The
port's own counterparts of modules that reach JAX there are the
exceptions.
"""
import ast
import glob
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "exonerate_tpu_torch")
JAX_PKG = os.path.join(ROOT, "exonerate_tpu")

# the port's own counterparts of modules that reach JAX in the JAX
# package (engines, the merged GAM, Analysis and CLI, parallel/), its
# own package docstring, and observe.py, which adds the port's spans and
# counters under torch.profiler
COUNTERPARTS = {"__init__.py", "observe.py", "engine/wavefront.py",
                "engine/sdp_device.py", "engine/sdp_hybrid.py",
                "engine/optimal.py",
                "engine/sdp_rows.py", "hub/gam.py", "hub/analysis.py",
                "cli/exonerate.py", "cli/server.py", "db/device_index.py",
                "parallel/multihost.py", "parallel/sharded_pair.py",
                "parallel/ungapped_scan.py"}


def _port_files(exts):
    out = []
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(exts):
                out.append(os.path.relpath(os.path.join(root, f), PORT))
    return sorted(out)


COPIES = [rel for rel in _port_files((".py", ".cpp"))
          if rel not in COUNTERPARTS
          and os.path.exists(os.path.join(JAX_PKG, rel))]


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    paths = [os.path.join(PORT, rel) for rel in _port_files((".py",))]
    paths += [os.path.join(ROOT, "chip_smoke.py"),
              os.path.join(ROOT, "tests", "torch_sdp_cases.py"),
              os.path.join(ROOT, "tests", "torch_split_cases.py")]
    paths += sorted(glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))
    bad = []
    for path in paths:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "exonerate_tpu", "tools"):
                bad.append((os.path.relpath(path, ROOT), name))
    assert not bad, bad
    assert len(paths) > 60
    assert os.path.join(PORT, "tools", "vpu16.py") in paths


def test_copy_list_covers_the_host_layer():
    for rel in ("alphabet.py", "seqio.py", "submat.py", "translate.py",
                "splice.py", "native.py", "_nativebuild.py",
                "sdplib.cpp", "seedlib.cpp", "align/gff.py", "align/ryo.py",
                "model/phase.py", "model/registry.py", "seeds/seeder.py",
                "engine/sdp.py", "engine/sdp_native.py", "engine/reference.py",
                "hub/bsdp.py", "hub/client.py", "cli/args.py",
                "db/__init__.py", "db/dataset.py", "db/index.py",
                "db/rangetree.py", "codonsubmat.py",
                "model/edit_distance.py", "cli/fastautils.py",
                "cli/ipcress.py"):
        assert rel in COPIES, rel


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_jax_module_after_the_package_rename(rel):
    with open(os.path.join(JAX_PKG, rel)) as fh:
        want = re.sub(r"\bexonerate_tpu\b", "exonerate_tpu_torch", fh.read())
    with open(os.path.join(PORT, rel)) as fh:
        assert fh.read() == want, f"{rel} drifted from exonerate_tpu/{rel}"
