"""Byte-range data sources.

TPU-native replacement for the reference's transport layer (PostStream.hx:18-196):
the browser XHR byte-range POST protocol (``s=<start>&e=<end>`` headers,
PostStream.LoadPart, PostStream.hx:140-159) maps here to range reads against
local files or object storage.  Data is delivered in bounded chunks so the
demux layer exercises the same incremental/resumable paths a network stream
would (the reference's 250 ms progress-timer chunking, PostStream.hx:42-67).
"""

from __future__ import annotations

import io
import os
from typing import Iterator, Optional


class ByteSource:
    """Abstract random-access byte source with range streaming."""

    def size(self) -> int:
        raise NotImplementedError

    def read_range(self, start: int, end: Optional[int] = None) -> bytes:
        """Read [start, end] inclusive, like PostStream.LoadPart's s/e protocol
        (PostStream.hx:140-159). ``end=None`` reads to EOF."""
        raise NotImplementedError

    def stream_range(
        self, start: int, end: Optional[int] = None, chunk_size: int = 1 << 16
    ) -> Iterator[bytes]:
        """Yield the range in chunks (models XHR progress events,
        PostStream.hx:60-67)."""
        data = self.read_range(start, end)
        for i in range(0, len(data), chunk_size):
            yield data[i : i + chunk_size]


class FileSource(ByteSource):
    """Local-file source; the moral equivalent of GCS range reads."""

    def __init__(self, path: str | os.PathLike):
        self._path = os.fspath(path)
        self._size = os.path.getsize(self._path)

    def size(self) -> int:
        return self._size

    def read_range(self, start: int, end: Optional[int] = None) -> bytes:
        last = self._size - 1 if end is None else min(end, self._size - 1)
        if start > last:
            return b""
        with open(self._path, "rb") as f:
            f.seek(start)
            return f.read(last - start + 1)


class MemorySource(ByteSource):
    """In-memory source for tests and fixtures."""

    def __init__(self, data: bytes):
        self._data = bytes(data)

    def size(self) -> int:
        return len(self._data)

    def read_range(self, start: int, end: Optional[int] = None) -> bytes:
        last = len(self._data) - 1 if end is None else min(end, len(self._data) - 1)
        if start > last:
            return b""
        return self._data[start : last + 1]


class HttpRangeSource(ByteSource):
    """HTTP byte-range source — the reference's network transport
    (PostStream.hx:18-196), both protocols:

    * ``protocol="range"`` (default): standard GET with a ``Range:
      bytes=s-e`` header — what any modern object store / CDN serves.
    * ``protocol="post"``: the reference's custom byte-range POST carrying
      ``s``/``e`` as request headers AND form body (PostStream.LoadPart,
      PostStream.hx:140-159), for Infognition's player_js backend.

    Size discovery: HEAD Content-Length, falling back to a 0-0 range
    probe's Content-Range total (the reference instead parses riff_size
    from the first chunk, DataLoaderAVIIndexed.hx:81)."""

    def __init__(self, url: str, protocol: str = "range", timeout: float = 30.0,
                 accept_full_body: bool = False):
        assert protocol in ("range", "post")
        self._url = url
        self._protocol = protocol
        self._timeout = timeout
        self._size: Optional[int] = None
        # A server that ignores Range returns 200 + the whole file; treating
        # that as the requested slice silently corrupts every seek.  By
        # default we reject; set accept_full_body=True to slice instead
        # (read_range only — acceptable for small files).
        self._accept_full_body = accept_full_body

    @staticmethod
    def _check_range_honored(r, start: int) -> bool:
        """True when the response is the requested slice; False when the
        server ignored Range and sent the whole entity (status 200)."""
        status = getattr(r, "status", None) or r.getcode()
        if status == 206:
            cr = r.headers.get("Content-Range", "")
            # "bytes s-e/total" — verify the slice starts where we asked
            if cr.startswith("bytes "):
                got = cr[6:].partition("-")[0]
                if got.strip().isdigit() and int(got) != start:
                    raise IOError(
                        f"server returned Content-Range {cr!r}, "
                        f"requested start {start}")
            return True
        if status == 200:
            return False
        raise IOError(f"unexpected HTTP status {status} for range request")

    def size(self) -> int:
        import urllib.request

        if self._size is None:
            req = urllib.request.Request(self._url, method="HEAD")
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                cl = r.headers.get("Content-Length")
                if cl is not None:
                    self._size = int(cl)
                else:
                    cr = r.headers.get("Content-Range", "")
                    self._size = int(cr.rpartition("/")[2]) if "/" in cr else 0
        return self._size

    def read_range(self, start: int, end: Optional[int] = None) -> bytes:
        import urllib.request

        if self._protocol == "post":
            # PostStream.hx:140-159: s/e ride as headers and form body; an
            # omitted end means "to EOF" (the reference sends e=riff end)
            e = "" if end is None else str(end)
            body = f"s={start}&e={e}".encode()
            req = urllib.request.Request(
                self._url, data=body, method="POST",
                headers={"s": str(start), "e": e,
                         "Content-Type": "application/x-www-form-urlencoded"})
        else:
            rng = f"bytes={start}-" if end is None else f"bytes={start}-{end}"
            req = urllib.request.Request(self._url, headers={"Range": rng})
        with urllib.request.urlopen(req, timeout=self._timeout) as r:
            body = r.read()
            if self._protocol == "range" and not self._check_range_honored(r, start):
                # whole-entity response: a full-file request (start=0, open
                # end) is equivalent; otherwise slice only if allowed
                if start == 0 and end is None:
                    return body
                if not self._accept_full_body:
                    raise IOError(
                        "server ignored Range header (status 200, full body); "
                        "pass accept_full_body=True to slice client-side")
                return body[start: None if end is None else end + 1]
            return body

    def stream_range(self, start: int, end: Optional[int] = None,
                     chunk_size: int = 1 << 16) -> Iterator[bytes]:
        """True streaming read: chunks yield as the socket delivers them
        (the XHR progress-event model, PostStream.hx:60-67)."""
        import urllib.request

        if self._protocol == "post":
            yield from super().stream_range(start, end, chunk_size)
            return
        rng = f"bytes={start}-" if end is None else f"bytes={start}-{end}"
        req = urllib.request.Request(self._url, headers={"Range": rng})
        with urllib.request.urlopen(req, timeout=self._timeout) as r:
            if not self._check_range_honored(r, start) and not (
                    start == 0 and end is None):
                raise IOError(
                    "server ignored Range header (status 200, full body) "
                    "on a streaming range request")
            while True:
                chunk = r.read(chunk_size)
                if not chunk:
                    return
                yield chunk


def open_source(path_or_url: str, **kw) -> ByteSource:
    """Source factory: http(s) URLs → HttpRangeSource (pass
    protocol="post" for the reference's player_js backend), file paths →
    FileSource."""
    if path_or_url.startswith(("http://", "https://")):
        return HttpRangeSource(path_or_url, **kw)
    return FileSource(path_or_url)
