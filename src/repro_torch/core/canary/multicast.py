"""Shard-encoded multicast groups (§4.2).

A switch must multicast broadcast-phase packets to the exact set of ports the
reduce-phase packets came from. Pre-installing one multicast group per port
subset needs ``2^p`` entries; the paper instead splits the ``p``-bit children
bitmap into ``s`` shards of ``p/s`` bits, prefixes each shard with its index,
and installs ``s * 2^(p/s)`` rules — e.g. 64 ports / 4 shards = 256 Ki rules.

This module implements that encoding/decoding exactly, and is unit/property
tested for round-trip correctness; the simulator uses the decoded port lists
for its broadcast fan-out.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def ports_to_bitmap(ports: Sequence[int], num_ports: int) -> int:
    bm = 0
    for p in ports:
        if not 0 <= p < num_ports:
            raise ValueError(f"port {p} out of range 0..{num_ports - 1}")
        bm |= 1 << p
    return bm


def bitmap_to_ports(bitmap: int) -> List[int]:
    out, p = [], 0
    while bitmap:
        if bitmap & 1:
            out.append(p)
        bitmap >>= 1
        p += 1
    return out


def shard_bitmap(bitmap: int, num_ports: int, shards: int) -> List[Tuple[int, int]]:
    """Split a children bitmap into ``shards`` (index, bits) entries (§4.2).

    Entry ``(i, bits)`` covers ports ``[i*w, (i+1)*w)`` with ``w = p/s``.
    Zero shards are skipped (no packet needs to be sent for them).
    """
    if num_ports % shards != 0:
        raise ValueError("num_ports must be divisible by shards")
    w = num_ports // shards
    mask = (1 << w) - 1
    out = []
    for i in range(shards):
        bits = (bitmap >> (i * w)) & mask
        if bits:
            out.append((i, bits))
    return out


def shard_to_ports(shard_index: int, bits: int, num_ports: int,
                   shards: int) -> List[int]:
    """Decode one shard entry back to absolute port numbers."""
    w = num_ports // shards
    return [shard_index * w + p for p in bitmap_to_ports(bits)]


def build_rule_table(num_ports: int, shards: int) -> Dict[Tuple[int, int], List[int]]:
    """Materialize the full (shard index, shard bits) -> ports rule table.

    Size is ``s * 2^(p/s)`` entries as derived in §4.2 — practical only for
    the small/medium port counts used in tests; production switches install
    these rules via the control plane.
    """
    w = num_ports // shards
    table: Dict[Tuple[int, int], List[int]] = {}
    for i in range(shards):
        for bits in range(1, 1 << w):
            table[(i, bits)] = shard_to_ports(i, bits, num_ports, shards)
    return table


def num_rules(num_ports: int, shards: int) -> int:
    """§4.2: rules drop from ``2^p`` to ``s * 2^(p/s)``."""
    return shards * (1 << (num_ports // shards))


def multicast_ports(bitmap: int, num_ports: int, shards: int) -> List[int]:
    """End-to-end: encode a children bitmap into shard entries and decode the
    union of ports, exactly as the broadcast data plane would."""
    out: List[int] = []
    for i, bits in shard_bitmap(bitmap, num_ports, shards):
        out.extend(shard_to_ports(i, bits, num_ports, shards))
    return sorted(out)
