"""Client side of the exonerate server mode
(ref: Analysis_Client_*, src/hub/analysis.c:398-1101).

The query is sent to the server, HSP seeds come back over the line
protocol, target residues are fetched on demand, and the comparisons feed
the normal GAM pipeline.
"""
from __future__ import annotations

import re
import socket
import time

from ..alphabet import Alphabet, AlphabetType
from ..seqio import Sequence
from ..seeds.hsp import HSP, Comparison, HspParam, HspSet

SERVER_RE = re.compile(r"^([\w.\-]+):(\d+)$")


def is_server_path(path: str) -> bool:
    return bool(SERVER_RE.match(path))


class AnalysisClient:
    """(ref: Analysis_Client, analysis.c:398-470)."""

    def __init__(self, hostport: str, retries: int = 10):
        m = SERVER_RE.match(hostport)
        host, port = m.group(1), int(m.group(2))
        last = None
        for _ in range(retries):
            try:
                self.sock = socket.create_connection((host, port),
                                                     timeout=30)
                break
            except OSError as e:
                last = e
                time.sleep(1)
        else:
            raise ConnectionError(
                f"could not connect to server [{hostport}]: {last}")
        self.rfile = self.sock.makefile("rb")

    def _read_reply(self, command: str) -> list[str]:
        """Read one framed reply: a single line, or — when the first
        line is a `linecount: N` header (ref: SocketConnection_read,
        src/general/socket.c:109-146; N counts the header itself) —
        the N-1 lines that follow.  No timeouts, no peeking."""
        first = self.rfile.readline().decode().rstrip("\n")
        if first.startswith("linecount:"):
            n = int(first.split()[1])
            lines = [self.rfile.readline().decode().rstrip("\n")
                     for _ in range(n - 1)]
        else:
            lines = [first]
        for line in lines:
            if line.startswith("error:"):
                raise RuntimeError(
                    f"server error for [{command}]: {line}")
        return lines

    def send(self, command: str) -> str:
        self.sock.sendall((command + "\n").encode())
        return self._read_reply(command)[0]

    def send_multi(self, command: str) -> list[str]:
        """Commands whose reply may span lines (get hsps)."""
        self.sock.sendall((command + "\n").encode())
        return self._read_reply(command)

    def dbinfo(self):
        parts = self.send("dbinfo").split()
        return {"type": parts[1], "num_seqs": int(parts[3]),
                "max_seq_len": int(parts[4]),
                "total_seq_len": int(parts[5])}

    def set_param(self, name: str, value) -> None:
        self.send(f"set param {name} {value}")

    def set_query(self, seq: Sequence) -> None:
        self.send("set query " + seq.data.tobytes().decode())

    def revcomp_target(self) -> None:
        self.send("revcomp target")

    def get_seq_info(self, num: int):
        parts = self.send(f"get info {num}").split(None, 4)
        return {"len": int(parts[1]), "checksum": int(parts[2]),
                "id": parts[3],
                "def": parts[4] if len(parts) > 4 else None}

    def get_seq(self, num: int) -> str:
        return self.send(f"get seq {num}").split(None, 1)[1]

    def get_subseq(self, num: int, start: int, length: int) -> str:
        """(ref: extmem page fetch, analysis.c:745-780 "get subseq")."""
        return self.send(
            f"get subseq {num} {start} {length}").split(None, 1)[1]

    def get_hsps(self) -> dict[int, list[tuple[int, int, int]]]:
        """(ref: Analysis_Client_get_hsp_sets, analysis.c:860-930)."""
        out: dict[int, list[tuple[int, int, int]]] = {}
        for line in self.send_multi("get hsps"):
            parts = line.split()
            if not parts or parts[0] != "hspset:":
                continue
            if parts[1] == "empty":
                continue
            tid = int(parts[1])
            trip = parts[2:]
            hsps = [(int(trip[k]), int(trip[k + 1]), int(trip[k + 2]))
                    for k in range(0, len(trip) - 2, 3)]
            out[tid] = hsps
        return out

    def close(self):
        try:
            self.sock.sendall(b"exit\n")
        except OSError:
            pass
        self.sock.close()


def run_client_analysis(analysis, hostport: str):
    """Drive the server-backed comparison loop
    (ref: Analysis_Server_run, analysis.c:1063-1101)."""
    client = AnalysisClient(hostport)
    if getattr(analysis.aas, "custom_server", None):
        # (ref: --customserver, analysis.c:55-58): send a raw custom
        # command to the server before anything else
        client.send(analysis.aas.custom_server)
    info = client.dbinfo()
    target_type = (AlphabetType.DNA if info["type"].startswith("dna")
                   else AlphabetType.PROTEIN)
    ha = analysis.hsp_args
    for name, value in [
            ("seedrepeat", ha.seed_repeat),
            ("dnahspthreshold", ha.dna_hsp_threshold),
            ("proteinhspthreshold", ha.protein_hsp_threshold),
            ("codonhspthreshold", ha.codon_hsp_threshold),
            ("dnawordlimit", ha.dna_word_limit),
            ("proteinwordlimit", ha.protein_word_limit),
            ("codonwordlimit", ha.codon_word_limit),
            ("geneseedthreshold", ha.geneseed_threshold),
            ("geneseedrepeat", ha.geneseed_repeat)]:
        client.set_param(name, value)
    params = analysis.comparison_params()
    kind, param = next(iter(params.items()))
    target_cache: dict[int, Sequence] = {}

    def fetch_target(tid: int) -> Sequence:
        """EXTMEM target: windows fetched over the wire through a page
        cache, never the full chromosome (ref: Sequence_create_extmem
        over an Analysis_Client SparseCache, analysis.c:795-814)."""
        if tid not in target_cache:
            from ..extmem import PageCache
            info = client.get_seq_info(tid)
            from ..alphabet import from_str

            def loader(start, length, _tid=tid):
                return from_str(client.get_subseq(_tid, start, length))

            cache = PageCache(info["len"], loader)
            target_cache[tid] = Sequence.create_lazy(
                info["id"], info["def"], info["len"], cache.read,
                Alphabet(target_type), "+")
        return target_cache[tid]

    revcomp_query = (analysis.aas.use_revcomp
                     and analysis.query_type == AlphabetType.DNA)
    for query in analysis.query_db:
        query = analysis._load_seq(query, analysis.query_type)
        for qv in analysis._expand_strands(query, revcomp_query):
            client.set_query(qv)
            for tid, triples in sorted(client.get_hsps().items()):
                target = fetch_target(tid)
                hs = HspSet(qv, target, param)
                for qpos, tpos, length in triples:
                    h = HSP(qpos, tpos, length, 0)
                    hs._init_score(h)
                    hs.hsps.append(h)
                hs.finalise()
                comp = Comparison(qv, target,
                                  **{kind: hs})
                if comp.has_hsps:
                    analysis._report_comparison(comp)
    client.close()
