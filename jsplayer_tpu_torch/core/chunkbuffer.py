"""Append-only chunked byte buffer with random access.

TPU-native replacement for the reference's ``InputBuffer`` (InputBuffer.hx:7-163):
network/storage chunks are appended as they arrive and readers address the
logical byte stream by absolute position.  Unlike the reference we never
mutate/join chunks — reads that straddle chunk boundaries are assembled into a
fresh buffer (memoryview-based, zero-copy within a chunk).
"""

from __future__ import annotations

import bisect


class ChunkBuffer:
    """Logical byte stream assembled from appended chunks (InputBuffer.hx:7)."""

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._starts: list[int] = []  # absolute start of each chunk
        self._total = 0
        self._base = 0  # absolute position of the first byte we still hold

    def add_chunk(self, data: bytes) -> None:
        """InputBuffer.AddChunk (InputBuffer.hx:27-32)."""
        if not data:
            return
        self._starts.append(self._base + self._total)
        self._chunks.append(bytes(data))
        self._total += len(data)

    @property
    def total_size(self) -> int:
        return self._base + self._total

    def bytes_available(self, position: int) -> int:
        """InputBuffer.BytesAvailable (InputBuffer.hx:34-37)."""
        return self._base + self._total - position

    def clear(self) -> None:
        """InputBuffer.Clear (InputBuffer.hx:39-47)."""
        self._chunks.clear()
        self._starts.clear()
        self._total = 0
        self._base = 0

    def num_chunks(self) -> int:
        return len(self._chunks)

    def _find_chunk(self, position: int) -> int:
        i = bisect.bisect_right(self._starts, position) - 1
        if i < 0:
            raise IndexError(f"position {position} before buffer start")
        return i

    def read(self, position: int, length: int) -> bytes:
        """Read `length` bytes at absolute `position` (InputBuffer.ReadBytes)."""
        if length == 0:
            return b""
        if self.bytes_available(position) < length or position < self._base:
            raise IndexError(
                f"read [{position}, {position + length}) out of range "
                f"[{self._base}, {self._base + self._total})"
            )
        i = self._find_chunk(position)
        off = position - self._starts[i]
        chunk = self._chunks[i]
        if off + length <= len(chunk):
            return bytes(chunk[off : off + length])
        out = bytearray()
        while length > 0:
            take = min(length, len(chunk) - off)
            out += chunk[off : off + take]
            length -= take
            i += 1
            if length > 0:
                chunk = self._chunks[i]
                off = 0
        return bytes(out)

    def read_u32le(self, position: int) -> int:
        """InputBuffer.ReadInt (InputBuffer.hx:51-75) — little-endian u32."""
        b = self.read(position, 4)
        return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)

    def read_u32be(self, position: int) -> int:
        """InputBuffer.ReadIntBigEndian (InputBuffer.hx:127-131)."""
        b = self.read(position, 4)
        return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]

    def drop_before(self, position: int) -> None:
        """Release chunks fully below `position` (windowed-memory support;
        the reference instead nulls frame data in clear_memory,
        DataLoaderAVIIndexed.hx:656-673)."""
        while self._chunks and self._starts[0] + len(self._chunks[0]) <= position:
            c = self._chunks.pop(0)
            self._starts.pop(0)
            self._total -= len(c)
            self._base = self._starts[0] if self._starts else position
