"""The port's exonerate-server and its device index, on the CPU.

``exonerate_tpu_torch.db`` (the dataset, the word index and the RangeTree,
copies of the JAX package's modules) and ``db.device_index.DeviceIndex``
(the postings sharded over a list of devices, a torch gather) behind
``exonerate_tpu_torch.cli.server``, held to the JAX package's server and
index and to the C reference's, on in-repo data only: a database of calm
(record 1 of ``tests/golden/data/all4.fa``) and ``genome.fa``.

- the port's DeviceIndex over [cpu] and over [cpu] * 8 (the JAX test's
  8-device mesh) equals ``Index.lookup_word`` and the JAX DeviceIndex;
- an index built by either package loads in the other, with the same
  lookups;
- the port's server replies, host index and device index, equal the JAX
  server's byte for byte (linecount framing, geneseed two-tier);
- the port's client CLI through the port's server prints the local
  run's vulgar lines, and so do the C client through the port's server
  and the port's client through the C server (skipped only where the
  C binaries are absent);
- ``python -m exonerate_tpu_torch.cli.server --deviceindex yes`` runs in
  a process where jax and the JAX package cannot be imported.
"""
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import exonerate_tpu_torch
from exonerate_tpu_torch.cli.exonerate import main as port_cli
from exonerate_tpu_torch.cli.server import ExonerateServer
from exonerate_tpu_torch.db.dataset import dataset_build
from exonerate_tpu_torch.db.device_index import DeviceIndex
from exonerate_tpu_torch.db.index import Index, index_build
from exonerate_tpu_torch.seqio import iter_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
REF_BIN = os.path.join(ROOT, "build", "ref", "bin")
CPU = torch.device("cpu")
ARGS = ["--bestn", "1", "--showvulgar", "yes", "--showalignment", "no"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(port, timeout=30):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"port {port} never opened")


def _session(port, commands):
    """Each command's reply, framed as the server sends it: a multi-line
    reply's ``linecount:`` header and its lines, a one-line reply
    bare."""
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    f = s.makefile("rb")
    out = []
    try:
        for cmd in commands:
            s.sendall((cmd + "\n").encode())
            first = f.readline().decode()
            reply = [first]
            if first.startswith("linecount:"):
                reply += [f.readline().decode()
                          for _ in range(int(first.split()[1]) - 1)]
            out.append("".join(reply))
    finally:
        s.close()
    return out


def _vulgar(text):
    return sorted(ln for ln in text.splitlines() if ln.startswith("vulgar:"))


def _calm():
    return next(iter(iter_fasta(os.path.join(DATA, "all4.fa"))))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """db.fa (calm and genome.fa), and its .esd / .esi built by the
    port's db."""
    tmp = tmp_path_factory.mktemp("db")
    calm = _calm()
    with open(os.path.join(DATA, "genome.fa")) as fh:
        genome = fh.read()
    fa = tmp / "db.fa"
    fa.write_text(f">{calm.id}\n{calm.data.tobytes().decode()}\n" + genome)
    q = tmp / "calm.fa"
    q.write_text(f">{calm.id}\n{calm.data.tobytes().decode()}\n")
    esd, esi = str(tmp / "db.esd.npz"), str(tmp / "db.esi.npz")
    dataset_build([str(fa)], esd)
    index_build(esd, esi, wordlen=12)
    return {"dir": tmp, "fa": str(fa), "query": str(q), "esd": esd,
            "esi": esi, "calm": calm.data.tobytes().decode()}


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")


def _words(index, n=64, seed=2):
    rng = np.random.default_rng(seed)
    words = rng.choice(index.word_table, size=min(n, len(index.word_table)),
                       replace=False).astype(np.int64)
    return np.concatenate([words, np.array([0, 10 ** 17], np.int64)])


def _host_lookup(index, words):
    exp_w, exp_s, exp_p = [], [], []
    for k, w in enumerate(words):
        s, p = index.lookup_word(int(w))
        exp_w += [k] * len(s)
        exp_s += s.tolist()
        exp_p += p.tolist()
    return exp_w, exp_s, exp_p


@pytest.mark.parametrize("n_dev", [1, 8])
def test_device_index_equals_host_and_jax(db, n_dev):
    import jax
    from jax.sharding import Mesh
    from exonerate_tpu.db.device_index import DeviceIndex as JaxIndex
    from exonerate_tpu.db.index import Index as JIndex
    index = Index(db["esi"])
    words = _words(index)
    dix = DeviceIndex(index, [CPU] * n_dev)
    assert len(dix.shards) == n_dev
    assert sum(hi - lo for lo, hi, _s, _p in dix.shards) == \
        len(index.post_seq)
    word_of, seqs, poss = dix.lookup_words(words)
    assert seqs.dtype == np.int32 and poss.dtype == np.int64
    assert (word_of.tolist(), seqs.tolist(), poss.tolist()) == \
        _host_lookup(index, words)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("dp",))
    jw, js, jp = JaxIndex(JIndex(db["esi"]), mesh, "dp").lookup_words(words)
    np.testing.assert_array_equal(word_of, jw)
    np.testing.assert_array_equal(seqs, js)
    np.testing.assert_array_equal(poss, jp)
    # misses only: nothing gathered
    w, s, p = dix.lookup_words(np.array([0, 10 ** 17], np.int64))
    assert len(w) == len(s) == len(p) == 0


def test_index_built_by_either_package_loads_in_the_other(db, tmp_path):
    from exonerate_tpu.db import dataset as jdataset, index as jindex
    jesd, jesi = str(tmp_path / "j.esd.npz"), str(tmp_path / "j.esi.npz")
    jdataset.dataset_build([db["fa"]], jesd)
    jindex.index_build(jesd, jesi, wordlen=12)
    port_of_jax = Index(jesi)
    jax_of_port = jindex.Index(db["esi"])
    words = _words(port_of_jax, 200, seed=3)
    want = _host_lookup(Index(db["esi"]), words)
    assert _host_lookup(port_of_jax, words) == want
    assert _host_lookup(jax_of_port, words) == want
    for a, b in ((port_of_jax.dataset, jax_of_port.dataset),):
        assert list(a.ids) == list(b.ids)
        assert [a.get_sequence(k).data.tobytes() for k in range(len(a))] \
            == [b.get_sequence(k).data.tobytes() for k in range(len(b))]


def _commands(calm):
    rng = np.random.default_rng(5)
    q = list(calm[100:900])
    for _ in range(60):
        q[rng.integers(0, len(q))] = "ACGT"[rng.integers(0, 4)]
    return ["version", "dbinfo", "help", "lookup gfix", "get info 0",
            "get subseq 1 10 20", "set query " + calm[:400], "get hsps",
            "set param geneseedthreshold 120", "set param geneseedrepeat 1",
            "set param maxqueryspan 200", "set param maxtargetspan 200",
            "set query " + "".join(q), "get hsps", "nonsense"]


def _serve(server):
    port = _free_port()
    server.port = port
    server.start_background()
    _wait_port(port)
    return port


def test_get_hsps_replies_equal_the_jax_server(db):
    from exonerate_tpu.cli.server import ExonerateServer as JaxServer
    from exonerate_tpu.db.index import Index as JIndex
    cmds = _commands(db["calm"])
    jindex = JIndex(db["esi"])
    servers = {"jax": JaxServer(jindex.dataset, jindex, 0)}
    for name, kw in (("host", {}),
                     ("device", {"use_device_index": True,
                                 "devices": [CPU] * 8})):
        index = Index(db["esi"])
        servers[name] = ExonerateServer(index.dataset, index, 0, **kw)
    replies = {}
    try:
        for name, srv in servers.items():
            replies[name] = _session(_serve(srv), cmds)
    finally:
        for srv in servers.values():
            srv.shutdown()
    assert replies["host"] == replies["jax"]
    assert replies["device"] == replies["jax"]
    assert servers["device"].device_index.lookups >= 2
    hsps = [r for c, r in zip(cmds, replies["jax"]) if c == "get hsps"]
    assert all(r.startswith("linecount:") or r.startswith("hspset:")
               for r in hsps)
    assert all("hspset: 1 " in r for r in hsps), hsps


def test_port_client_through_port_server_equals_local(db, cpu_device):
    index = Index(db["esi"])
    srv = ExonerateServer(index.dataset, index, 0, use_device_index=True,
                          devices=[CPU])
    try:
        port = _serve(srv)
        for model in ([], ["-m", "est2genome"]):
            remote, local = io.StringIO(), io.StringIO()
            assert port_cli(ARGS + model + [db["query"],
                                            f"localhost:{port}"],
                            out=remote) == 0
            assert port_cli(ARGS + model + [db["query"], db["fa"]],
                            out=local) == 0
            assert _vulgar(remote.getvalue()) == _vulgar(local.getvalue())
            assert any(" 10875" in ln for ln in _vulgar(remote.getvalue()))
    finally:
        srv.shutdown()


def _need_ref_bins():
    for b in ("exonerate", "exonerate-server", "fasta2esd", "esd2esi"):
        if not os.access(os.path.join(REF_BIN, b), os.X_OK):
            pytest.skip(f"the C reference's {b} is absent from build/ref/bin")


def test_c_client_through_port_server(db, cpu_device):
    _need_ref_bins()
    index = Index(db["esi"])
    srv = ExonerateServer(index.dataset, index, 0)
    try:
        port = _serve(srv)
        r = subprocess.run([os.path.join(REF_BIN, "exonerate")] + ARGS
                           + [db["query"], f"localhost:{port}"],
                           capture_output=True, text=True, timeout=300)
    finally:
        srv.shutdown()
    assert r.returncode == 0, r.stderr[-500:]
    local = io.StringIO()
    assert port_cli(ARGS + [db["query"], db["fa"]], out=local) == 0
    assert _vulgar(r.stdout) == _vulgar(local.getvalue())
    assert any(" 10875" in ln for ln in _vulgar(r.stdout))


def test_port_client_through_c_server(db, cpu_device, tmp_path):
    _need_ref_bins()
    esd, esi = str(tmp_path / "c.esd"), str(tmp_path / "c.esi")
    subprocess.run([os.path.join(REF_BIN, "fasta2esd"), db["fa"], esd],
                   check=True, capture_output=True, timeout=300)
    subprocess.run([os.path.join(REF_BIN, "esd2esi"), esd, esi],
                   check=True, capture_output=True, timeout=300)
    port = _free_port()
    proc = subprocess.Popen([os.path.join(REF_BIN, "exonerate-server"), esi,
                             "--port", str(port)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        _wait_port(port)
        remote = io.StringIO()
        assert port_cli(ARGS + [db["query"], f"localhost:{port}"],
                        out=remote) == 0
    finally:
        proc.kill()
        proc.wait()
    local = io.StringIO()
    assert port_cli(ARGS + [db["query"], db["fa"]], out=local) == 0
    assert _vulgar(remote.getvalue()) == _vulgar(local.getvalue())
    assert any(" 10875" in ln for ln in _vulgar(remote.getvalue()))


def test_server_module_runs_without_jax(db):
    """``python -m exonerate_tpu_torch.cli.server`` with jax and the JAX
    package blocked serves the JAX server's replies, its device index on
    one CPU device."""
    from exonerate_tpu.cli.server import ExonerateServer as JaxServer
    from exonerate_tpu.db.index import Index as JIndex
    port = _free_port()
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['exonerate_tpu'] = None\n"
            f"sys.argv = ['exonerate-server', '--input', {db['esi']!r}, "
            f"'--port', '{port}', '--deviceindex', 'yes']\n"
            "runpy.run_module('exonerate_tpu_torch.cli.server', "
            "run_name='__main__')\n")
    env = dict(os.environ, EXONERATE_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    cmds = _commands(db["calm"])
    try:
        _wait_port(port, timeout=120)
        got = _session(port, cmds)
    finally:
        proc.kill()
        _out, err = proc.communicate(timeout=60)
    assert "Error" not in err, err[-2000:]
    jindex = JIndex(db["esi"])
    jsrv = JaxServer(jindex.dataset, jindex, 0)
    try:
        want = _session(_serve(jsrv), cmds)
    finally:
        jsrv.shutdown()
    assert got == want
