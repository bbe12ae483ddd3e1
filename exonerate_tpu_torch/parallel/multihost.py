"""Multi-process sharding (``--multihost query|target``).

Counterpart of ``exonerate_tpu/parallel/multihost.py``, over
``torch.distributed`` in place of JAX's multi-process runtime.  The
reference scales across a cluster by chunking databases with
--querychunkid/--querychunktotal/--targetchunkid/--targetchunktotal and
concatenating per-job outputs externally (ref: doc/man/man1/exonerate.1
:177-204, src/database/fastadb.h:72-73, src/program/exonerate.c:62-73).
This module makes that recipe first-class: every process runs the same
command with --multihost query|target, takes the chunk of its rank on
that axis, runs the analysis locally on its own device, and the results
merge with one byte all-gather:

- per-query bestn stores merge with GAM's exact admit/evict/tie rules,
  submission order extended chunk-major (chunks partition the stream in
  order, so (chunk, local order) IS the single-process submission order);
- non-bestn output concatenates chunk-major (the reference's external
  concat, done for the user).

Rank 0 prints the merged report; every rank prints the header and the
footer.  With --multihost query and bestn, or any --multihost target run,
the output is byte-identical to the same single-process command.

The process group is the caller's when one is initialised; otherwise,
with ``WORLD_SIZE`` > 1 (torchrun's variables), one is initialised from
``env://``; otherwise the run is one process.  The all-gather runs on the
gloo backend (the payload is pickled host bytes, and gloo lets two ranks
share one card, which NCCL refuses).  Each rank's device is
``cuda:{LOCAL_RANK % device_count}`` unless $EXONERATE_TPU_TORCH_DEVICE
names one.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import torch

# a chunk's local submission orders stay below this; global order =
# chunk_id * _ORDER_STRIDE + local_order keeps chunk-major tie-breaking
_ORDER_STRIDE = 1 << 40


@dataclass
class ChunkReport:
    chunk_id: int                     # 1-based, as the chunk flags use
    stream_text: str                  # non-bestn output, stream order
    bestn: dict                       # qid -> list[(score, text, order)]


def gather_chunk_report(analysis, buf) -> ChunkReport:
    """Extract one host's results after analysis.process() ran with
    gam.defer_report set (bestn replay suppressed)."""
    bestn = {qid: [(s.score, s.text, s.order) for s in store]
             for qid, store in analysis.gam.bestn_store.items()}
    return ChunkReport(chunk_id=0, stream_text=buf.getvalue(),
                       bestn=bestn)


def merge_chunk_reports(reports: list[ChunkReport], best_n: int) -> str:
    """Merge chunk outputs into the single-host report text.

    bestn merge replays GAM.report()'s exact semantics (ref: GAM_report,
    gam.c:550-556; admit/evict ref: gam.c:267-326): per query in
    id-sorted order, entries sorted (score desc, submission order asc),
    kept while fewer than best_n strictly better exist, ranks 1..N
    spliced over the %_EXONERATE_BESTN_RANK_% placeholder."""
    reports = sorted(reports, key=lambda r: r.chunk_id)
    parts = [r.stream_text for r in reports]
    if best_n:
        store: dict = {}
        for r in reports:
            for qid, entries in r.bestn.items():
                dst = store.setdefault(qid, [])
                for score, text, order in entries:
                    dst.append((score,
                                r.chunk_id * _ORDER_STRIDE + order,
                                text))
        for qid in sorted(store):
            entries = sorted(store[qid], key=lambda e: (-e[0], e[1]))
            scores = [e[0] for e in entries]
            kept = [e for e in entries
                    if sum(1 for sc in scores if sc > e[0]) < best_n]
            for rank, (_s, _o, text) in enumerate(kept, 1):
                parts.append(text.replace("%_EXONERATE_BESTN_RANK_%",
                                          str(rank)))
    return "".join(parts)


def _dist():
    """``torch.distributed`` when this process is one rank of several,
    else None; and whether this call initialised its group (from
    torchrun's variables)."""
    import torch.distributed as dist
    if not dist.is_available():
        return None, False
    owned = False
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None, False
        dist.init_process_group("gloo", init_method="env://")
        owned = True
    return (dist if dist.get_world_size() > 1 else None), owned


def _gloo_group(dist):
    """The default group when it runs on gloo, else a gloo group of every
    rank (created once)."""
    global _GLOO
    if dist.get_backend() == "gloo":
        return None
    if _GLOO is None:
        _GLOO = dist.new_group(backend="gloo")
    return _GLOO


_GLOO = None


def _allgather_bytes(data: bytes, dist=None) -> list[bytes]:
    """All-gather one byte blob per process of ``dist``'s default group
    (identity when None): the lengths first, then the blobs padded to the
    longest, as uint8 tensors on the CPU."""
    if dist is None:
        return [data]
    group = _gloo_group(dist)
    P = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64),
                    group=group)
    lens = [int(x) for x in lens]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = [torch.empty_like(buf) for _ in range(P)]
    dist.all_gather(got, buf, group=group)
    return [g[:n].numpy().tobytes() for g, n in zip(got, lens)]


def rank_device() -> torch.device:
    """This rank's device: $EXONERATE_TPU_TORCH_DEVICE when set, else
    ``cuda:{LOCAL_RANK % device_count}``."""
    from .. import DEVICE_ENV, device
    if os.environ.get(DEVICE_ENV):
        return device()
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return device(f"cuda:{local % n}" if n else "cuda")


def run_multihost(v: dict, axis: str, out) -> None:
    """Drive one process's share of a multi-process run and print the
    merged report on rank 0.  ``v`` is the parsed CLI value dict."""
    import io

    from ..cli.exonerate import make_analysis

    if axis not in ("query", "target"):
        raise SystemExit(f"exonerate: --multihost {axis}: expected none, "
                         "query or target")
    dist, owned = _dist()
    P = dist.get_world_size() if dist is not None else 1
    p = dist.get_rank() if dist is not None else 0
    if v[f"{axis}chunktotal"]:
        raise SystemExit(
            f"--multihost {axis} assigns --{axis}chunkid/total itself; "
            "drop the explicit chunk flags")
    v = dict(v)
    v[f"{axis}chunkid"] = p + 1
    v[f"{axis}chunktotal"] = P
    buf = io.StringIO()
    analysis = make_analysis(v, out=buf, device=rank_device())
    analysis.gam.defer_report = True
    analysis.process()
    report = gather_chunk_report(analysis, buf)
    report.chunk_id = p + 1
    blobs = _allgather_bytes(pickle.dumps(report), dist)
    if owned:
        # a group left to the interpreter's exit aborts the process
        dist.destroy_process_group()
    if p == 0:
        reports = [pickle.loads(b) for b in blobs]
        out.write(merge_chunk_reports(reports, analysis.gam.gas.best_n))
