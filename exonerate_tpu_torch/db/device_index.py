"""The `.esi` postings on the device, sharded over a list of devices.

Counterpart of ``exonerate_tpu/db/device_index.py``, which shards the
postings over a JAX mesh axis and turns `get hsps`'s word lookups into a
``shard_map`` gather merged by a ``psum`` (``:48-92``).  Here the mesh
axis is a list of devices, as kernel K5 takes its cards
(``cuda_wavefront.find_batched(devices=...)``): shard k holds postings
[k * L, (k + 1) * L) of ``index.post_seq`` (int32) and ``post_pos``
(int64), L = ceil(n / len(devices)).  A lookup is torch ops, no kernel of
its own (the JAX version is ``jnp``, not Pallas): each shard gathers the
postings it owns for the requested ``[start, start + count)`` ranges at
their global output offsets in one vectorised gather (the starts
repeated over each word's count plus an arange within the word, masked
to the shard), and the disjoint results merge by a sum on the first
device, the ``psum``.  The word table stays on the host, as the JAX
version keeps its search on the host.  The caller names the devices;
``default_devices`` gives every card PyTorch sees, or one CPU device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import device as port_device
from .index import Index


def default_devices(dev: Optional[torch.device] = None) -> list:
    """Every card PyTorch sees when ``dev`` (default: the port's device)
    is a card, as the JAX server puts every attached device on its mesh;
    else ``[dev]``."""
    dev = dev if dev is not None else port_device()
    if dev.type == "cuda":
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [dev]


class DeviceIndex:
    """Postings sharded over ``devices``; the word table on the host."""

    def __init__(self, index: Index, devices: Optional[list] = None):
        self.index = index
        self.lookups = 0       # lookups that gathered postings
        self.devices = list(devices) if devices else default_devices()
        n_post = len(index.post_seq)
        shard_len = -(-n_post // len(self.devices))
        seq = np.ascontiguousarray(index.post_seq, np.int32)
        pos = np.ascontiguousarray(index.post_pos, np.int64)
        self.shards = []        # (lo, hi, post_seq[lo:hi], post_pos[lo:hi])
        for k, dev in enumerate(self.devices):
            lo = min(k * shard_len, n_post)
            hi = min(lo + shard_len, n_post)
            self.shards.append((lo, hi,
                                torch.from_numpy(seq[lo:hi]).to(dev),
                                torch.from_numpy(pos[lo:hi]).to(dev)))

    def _shard_gather(self, k: int, starts: np.ndarray, counts: np.ndarray,
                      offs: np.ndarray, total: int):
        """Shard k's postings for the ranges at their output offsets, 0
        where another shard owns the posting: (seq (total,) int32, pos
        (total,) int64) on its device."""
        lo, hi, seq, pos = self.shards[k]
        dev = seq.device
        if hi == lo:
            return (torch.zeros(total, dtype=torch.int32, device=dev),
                    torch.zeros(total, dtype=torch.int64, device=dev))
        counts_t = torch.from_numpy(counts).to(dev)
        # global posting index of each output slot: its word's start plus
        # the slot's place within the word
        base = torch.from_numpy(starts - offs).to(dev)
        src = (torch.repeat_interleave(base, counts_t, output_size=total)
               + torch.arange(total, dtype=torch.int64, device=dev))
        mine = (src >= lo) & (src < hi)
        local = (src - lo).clamp(0, hi - lo - 1)
        return (torch.where(mine, seq[local], 0),
                torch.where(mine, pos[local], 0))

    def lookup_words(self, packed_words: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All postings for the given packed words, concatenated in word
        order, bitwise equal to chaining Index.lookup_word on the host.
        Returns (word_of_posting, seq_ids, positions)."""
        idx = self.index
        ix = np.searchsorted(idx.word_table, packed_words)
        ix = np.clip(ix, 0, max(len(idx.word_table) - 1, 0))
        hit = (len(idx.word_table) > 0) \
            & (idx.word_table[ix] == packed_words)
        starts = np.where(hit, idx.word_starts[ix], 0).astype(np.int64)
        counts = np.where(hit, idx.word_counts[ix], 0).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]]
                              ).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.int64))
        self.lookups += 1
        parts = [self._shard_gather(k, starts, counts, offs, total)
                 for k in range(len(self.shards))]
        # disjoint ownership: the sum on the first device is the merge
        home = self.devices[0]
        seqs = sum(s.to(home) for s, _ in parts)
        poss = sum(p.to(home) for _, p in parts)
        word_of = np.repeat(np.arange(len(packed_words)), counts)
        return word_of, seqs.cpu().numpy(), poss.cpu().numpy()
