"""DP region rectangle (ref: src/c4/region.h:122-155)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Region:
    query_start: int
    target_start: int
    query_length: int
    target_length: int

    @property
    def query_end(self) -> int:
        return self.query_start + self.query_length

    @property
    def target_end(self) -> int:
        return self.target_start + self.target_length

    def is_valid(self) -> bool:
        return (self.query_start >= 0 and self.target_start >= 0
                and self.query_length >= 0 and self.target_length >= 0)

    def contains(self, other: "Region") -> bool:
        return (self.query_start <= other.query_start
                and self.target_start <= other.target_start
                and self.query_end >= other.query_end
                and self.target_end >= other.target_end)
