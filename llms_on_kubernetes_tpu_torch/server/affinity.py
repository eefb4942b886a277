"""The digest-membership bloom filter a replica advertises on ``/ready``
(the port's copy of ``BloomFilter`` in
``llms_on_kubernetes_tpu/server/affinity.py``).

The routers (``native/router/router.cpp`` and the JAX package's Python
router) parse the filter and send a request whose prefix chain it claims
to this replica, where the prefix cache holds its pages. The serialization
is byte-equal to the JAX engine's, and the page digests it holds are the
JAX allocator's (``engine/cache.PageAllocator``), so cache-aware placement
works on a port replica unchanged.
"""

from __future__ import annotations

import base64


class BloomFilter:
    """Membership summary over a replica's cached page digests.

    A key is a 32-byte chained sha256 page digest, so its k probe
    positions are the first k little-endian 8-byte words of the digest mod
    ``bits`` (``hashes`` is clamped to the 4 words there are). The bits
    serialize as standard base64 of ceil(bits / 8) bytes. A false positive
    costs one misrouted request (it re-prefills), never a wrong answer."""

    __slots__ = ("bits", "hashes", "data", "count")

    def __init__(self, bits: int = 8192, hashes: int = 4):
        self.bits = max(8, int(bits))
        self.hashes = min(4, max(1, int(hashes)))
        self.data = bytearray((self.bits + 7) // 8)
        self.count = 0

    def _positions(self, digest):
        digest = bytes(digest)
        for i in range(self.hashes):
            yield int.from_bytes(digest[8 * i:8 * i + 8], "little") % self.bits

    def add(self, digest) -> None:
        for pos in self._positions(digest):
            self.data[pos >> 3] |= 1 << (pos & 7)
        self.count += 1

    def contains(self, digest) -> bool:
        return all(self.data[pos >> 3] & (1 << (pos & 7)) for pos in self._positions(digest))

    def serialize(self) -> dict:
        """The wire form, the ``prefix_filter`` key of the /ready body."""
        return {"bits": self.bits, "hashes": self.hashes,
                "data": base64.b64encode(bytes(self.data)).decode("ascii"),
                "count": self.count}
