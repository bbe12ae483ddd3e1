"""Heuristic gapped alignment: seeded region DP.

The TPU-native counterpart of the reference's SDP pipeline
(ref: src/sdp/sdp.{h,c}, scheduler.{h,c}): instead of a pointer-sparse
cell wavefront, HSP seeds are clustered into gene-locus regions (HSPs
reachable within intron/join range — the same geometry the reference's
geneseed filter uses, ref: gam.c:1044-1105) and each cluster region runs
the dense wavefront engine with suboptimal enumeration.  For genome-scale
targets this bounds work to the loci the seeds support, which is the role
the sparse Scheduler plays in the reference; dense tiles trade the
pointer-chasing for VPU-wide vector work.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..engine.region import Region
from ..seeds.hsp import Comparison, HspSet


@dataclass
class Cluster:
    query_lo: int
    query_hi: int
    target_lo: int
    target_hi: int
    score: int

    def merge(self, other: "Cluster"):
        self.query_lo = min(self.query_lo, other.query_lo)
        self.query_hi = max(self.query_hi, other.query_hi)
        self.target_lo = min(self.target_lo, other.target_lo)
        self.target_hi = max(self.target_hi, other.target_hi)
        self.score = max(self.score, other.score)


def cluster_hsps(comparison: Comparison, max_target_join: int,
                 max_query_join: int) -> list[Cluster]:
    """Group HSPs whose extents are within joining range on both axes
    (the reference's RangeTree candidate-pair geometry,
    ref: hpair.c:510-653, reduced to interval clustering)."""
    items: list[Cluster] = []
    for hs in comparison.hspsets():
        for h in hs.hsps:
            items.append(Cluster(h.query_start, h.query_end(hs.qadv),
                                 h.target_start, h.target_end(hs.tadv),
                                 h.score))
    if not items:
        return []
    items.sort(key=lambda c: c.target_lo)
    merged: list[Cluster] = [items[0]]
    for c in items[1:]:
        last = merged[-1]
        if (c.target_lo - last.target_hi <= max_target_join
                and (c.query_lo - last.query_hi <= max_query_join
                     or c.query_lo <= last.query_hi)):
            last.merge(c)
        else:
            merged.append(c)
    return merged


def cluster_regions(comparison: Comparison, clusters: list[Cluster],
                    target_margin: int, query_margin: int
                    ) -> list[Region]:
    qlen = len(comparison.query)
    tlen = len(comparison.target)
    out = []
    for c in clusters:
        q_lo = max(0, c.query_lo - query_margin)
        q_hi = min(qlen, c.query_hi + query_margin)
        t_lo = max(0, c.target_lo - target_margin)
        t_hi = min(tlen, c.target_hi + target_margin)
        out.append(Region(q_lo, t_lo, q_hi - q_lo, t_hi - t_lo))
    return out
