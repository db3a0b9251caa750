"""Data loaders: demux orchestration, frame store, windowed memory, seek I/O.

Parity surface: DataLoader (DataLoader.hx:24-430), DataLoaderAVISeq
(DataLoaderAVISeq.hx:12-62) and DataLoaderAVIIndexed
(DataLoaderAVIIndexed.hx:21-688).

Control-flow redesign: the reference is event-driven from XHR progress timers
(on_progress, DataLoader.hx:144-187) with continuations parked in
``requested_*_action`` fields (DataLoaderAVIIndexed.hx:37-40, 491-507) because
JS cannot block.  Here the consumer PULLS: ``pump()`` fetches the next chunk
from the active byte-range stream, feeds the demuxer, and returns whether
progress was made — the Manager's worker loop calls it exactly where the
reference's callback chain would resume.  Windowed-memory semantics are kept
intact: 50 MB default compressed window (storage_limit,
DataLoaderAVIIndexed.hx:41), eviction outside [nearest keyframe, frame of
interest] (clear_memory, :656-673), stop once the window is full and a
keyframe beyond the playhead is resident (dont_load_too_much, :638-654), and
resume when the playhead reaches the last loaded keyframe
(NotifyPlayerPosition, :452-470).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

from ..av.audio_track import AudioTrack
from ..utils.logging import LOG
from ..av.mp3 import Mp3Parser
from .chunkbuffer import ChunkBuffer
from .riff import AviDemuxer, IndxData, parse_idx1, parse_ix
from .source import ByteSource
from .types import (
    CompressedFrame,
    FrameInfo,
    FrameStatus,
    Index,
    VideoInfo,
)

DEFAULT_STORAGE_LIMIT = 50_000_000  # DataLoaderAVIIndexed.hx:41
PROBE_RANGE_END = 999_999  # initial header probe (DataLoaderAVIIndexed.hx:81)
CHUNK_SIZE = 1 << 16


class DataLoader:
    """Base loader (DataLoader.hx:24-430): frame store + keyframe queries +
    audio piggyback + idle-frame scan."""

    def __init__(self) -> None:
        self.frames: list[Optional[CompressedFrame]] = []
        self.buffer = ChunkBuffer()
        self.sound_buffer = ChunkBuffer()
        self.audio_track = AudioTrack()
        self.mp3_parser = Mp3Parser(self.sound_buffer, self._on_sound_section)
        self.demuxer: Optional[AviDemuxer] = None
        self.indexes: Optional[list[Index]] = None
        self.audio_indexes: Optional[list[Index]] = None
        self.video_info: Optional[VideoInfo] = None
        self.decoder = None  # set by the Manager (DataLoader.hx:47)
        self.avi_parsing_pos = 0
        self.nframes = 0
        self.riff_size = 0xFFFFFFFF
        self.stop_loading = False
        self.reading_start_position = 0
        self._stream: Optional[Iterator[bytes]] = None
        self._video_info_cb: Optional[Callable[[VideoInfo], None]] = None

    # -- lifecycle -----------------------------------------------------------

    def open(self, source: ByteSource,
             on_video_info: Optional[Callable[[VideoInfo], None]] = None
             ) -> None:
        raise NotImplementedError

    def stop_and_clean(self) -> None:
        # DataLoader.StopAndClean (DataLoader.hx:63-71)
        self.frames = []
        self.buffer.clear()
        self.sound_buffer.clear()
        self.mp3_parser.reset()  # its positions pointed into sound_buffer
        self.stop_loading = True
        self.audio_track.stop_and_clean()
        self._stream = None
        self.demuxer = None

    # -- frame store queries ---------------------------------------------------

    def get_frame(self, num: int) -> FrameInfo:
        # DataLoader.GetFrame (DataLoader.hx:93-98).  num < 0 must not
        # python-negative-index the list (callers clamp, but a hostile
        # index from a fuzzer or a future caller stays NOT_READY)
        if num < 0 or num >= len(self.frames) or self.frames[num] is None \
                or self.frames[num].data is None:
            return FrameInfo(FrameStatus.NOT_READY)
        return FrameInfo(FrameStatus.READY, self.frames[num])

    def get_frame_not_loading(self, num: int) -> FrameInfo:
        return DataLoader.get_frame(self, num)

    def get_frame_changes(self, num: int) -> Optional[bool]:
        # DataLoader.GetFrameChanges (DataLoader.hx:109-112); same num < 0
        # guard as get_frame (a negative index would alias tail frames)
        if 0 <= num < len(self.frames) and self.frames[num] is not None:
            return self.frames[num].significant_changes
        return None

    def loaded_frames_end(self) -> int:
        return len(self.frames)

    def loaded_frames_start(self) -> int:
        return 0

    def get_nearest_keyframe(self, n: int) -> int:
        # DataLoader.GetNearestKeyframe (DataLoader.hx:125-132)
        if not self.frames:
            return 0
        n = min(n, len(self.frames) - 1)
        while n > 0 and (self.frames[n] is None or not self.frames[n].key):
            n -= 1
        return n

    def get_next_keyframe(self, n: int) -> int:
        # DataLoader.GetNextKeyFrame (DataLoader.hx:134-141)
        ln = len(self.frames)
        if ln == 0:
            return 0
        n = min(n, ln - 1)
        while n < ln - 1 and (self.frames[n] is None or not self.frames[n].key):
            n += 1
        return n

    def find_possible_change(self, pos_from: int):
        """→ ('change', i) | ('unknown', i) (FindPossibleChange,
        DataLoader.hx:239-252)."""
        for i in range(pos_from, len(self.frames)):
            f = self.frames[i]
            if f is None:
                return ("unknown", i)
            ch = f.significant_changes
            if ch is None:
                return ("unknown", i)
            if ch:
                return ("change", i)
        if self.frames:
            return ("change", len(self.frames) - 1)
        return ("unknown", pos_from)

    # -- audio -----------------------------------------------------------------

    def _on_sound_section(self, start: float, data: bytes, last: bool) -> None:
        sec = self.mp3_parser.sections[-1]
        self.audio_track.add_section(sec)

    def parse_sound(self) -> None:
        # DataLoader.ParseSound (DataLoader.hx:196-199)
        self.mp3_parser.parse(budget_bytes=1 << 18)

    def audio_time_loaded(self, fps: float) -> float:
        # DataLoader.AudioTimeLoaded (DataLoader.hx:201-207)
        if self.mp3_parser.no_more_sound() or not self.mp3_parser.started:
            return len(self.frames) / fps
        return self.audio_track.time_loaded

    # -- streaming plumbing ----------------------------------------------------

    def pump(self) -> bool:
        """Fetch one chunk from the active stream and advance the demuxer.
        → True if any progress (data consumed or demux advanced)."""
        if self.stop_loading or self.demuxer is None:
            return False
        progressed = False
        if self._stream is not None:
            chunk = next(self._stream, None)
            if chunk is None:
                self._stream = None
                self.demuxer.signal_eof()
                self._on_stream_end()
            else:
                self.buffer.add_chunk(chunk)
                LOG.count("bytes_fetched", len(chunk))
                LOG.count("chunks_fetched")
                progressed = True
        if self.demuxer is not None and self.demuxer.active:
            self.demuxer.pump()
            progressed = True
        return progressed

    def pump_all(self) -> None:
        while self.pump():
            pass

    def _on_stream_end(self) -> None:
        self.mp3_parser.on_data_end()

    def notify_player_position(self, pos: int) -> None:
        pass

    def set_on_load_complete(self, handler: Callable[[], None]) -> None:
        pass

    # -- demux event handlers --------------------------------------------------

    def _on_video_info(self, vi: VideoInfo) -> None:
        # DataLoader.on_video_info (DataLoader.hx:254-263)
        self.video_info = vi
        self.nframes = vi.nframes
        self.riff_size = vi.riff_size
        self.frames = [None] * vi.nframes
        if self._video_info_cb is not None:
            self._video_info_cb(vi)

    def _on_indx(self, data: IndxData) -> None:
        # DataLoader.on_indx_data (DataLoader.hx:266-299)
        if data.ckid & 0xFF0000 != 0x640000:
            self._on_audio_indx(data)
            return
        if data.super_entries is not None:
            self.indexes = []
            frame_num = 0
            for sie in data.super_entries:
                self.indexes.append(Index.from_super(sie, frame_num))
                frame_num += sie.duration
        elif data.std_entries is not None:
            self.indexes = [Index(first_frame=0,
                                  last_frame=len(data.std_entries) - 1,
                                  base_offset=data.std_offset,
                                  frames=data.std_entries)]
        self._on_index_loaded()

    def _on_audio_indx(self, data: IndxData) -> None:
        # DataLoaderAVIIndexed.on_audio_indx (DataLoaderAVIIndexed.hx:105-133)
        if data.ckid & 0xFF0000 != 0x770000:
            return
        if data.super_entries is not None:
            self.audio_indexes = []
            frame_num = 0
            for sie in data.super_entries:
                self.audio_indexes.append(Index.from_super(sie, frame_num))
                frame_num += sie.duration
        elif data.std_entries is not None:
            self.audio_indexes = [Index(first_frame=0,
                                        last_frame=len(data.std_entries) - 1,
                                        base_offset=data.std_offset,
                                        frames=data.std_entries)]

    def _on_index_loaded(self) -> None:
        pass

    def _on_ix_inline(self, payload: bytes, chunk_pos: int) -> None:
        # DataLoader.on_ix_read (DataLoader.hx:310-319): ix met inline while
        # reading; absolute position = stream start + position in stream
        ix_pos = self.reading_start_position + chunk_pos
        self._ingest_ix(payload, ix_pos)

    def _ingest_ix(self, payload: bytes, ix_pos: int) -> bool:
        # DataLoader.parse_ix (DataLoader.hx:321-361)
        if self.indexes is None:
            return False
        ckid, base_offset, entries = parse_ix(payload)
        index = self._find_index(ckid, ix_pos)
        if index is None:
            return False
        index.frames = entries
        index.base_offset = base_offset
        # identity scan: Index is an eq=True dataclass, so `.index()` would
        # compare field-by-field and could pick a different-but-equal segment
        # (e.g. an audio index with coincidentally identical fields)
        n = next((i for i, x in enumerate(self.indexes) if x is index), -1)
        if n >= 0:
            self.update_keyframes_info(n)
        return True

    def _find_index(self, ckid: int, ix_pos: int) -> Optional[Index]:
        # DataLoader.find_index (:363-372) + audio override
        # (DataLoaderAVIIndexed.hx:405-414)
        if ckid & 0xFF0000 == 0x640000 and self.indexes:
            for x in self.indexes:
                if x.idx_offset == ix_pos:
                    return x
        if ckid & 0xFF0000 == 0x770000 and self.audio_indexes:
            for x in self.audio_indexes:
                if x.idx_offset == ix_pos:
                    return x
        return None

    def update_keyframes_info(self, ixnum: int) -> None:
        # DataLoader.update_keyframes_info (DataLoader.hx:374-401)
        x = self.indexes[ixnum]
        for i, e in enumerate(x.frames):
            num = x.first_frame + i
            if num >= len(self.frames):
                break
            if self.frames[num] is not None:
                self.frames[num].key = e.key
                self.frames[num].ix = ixnum
                if e.size == 0:
                    self.frames[num].data = b""
            else:
                d = b"" if e.size == 0 else None
                self.frames[num] = CompressedFrame(key=e.key, data=d, ix=ixnum)

    # -- frame ingestion -------------------------------------------------------

    def _add_frame(self, data: bytes) -> None:
        """Shared frame-append semantics (DataLoaderAVISeq.add_frame,
        DataLoaderAVISeq.hx:32-49): skip zero-length placeholders created by
        index ingestion; keyframe flag from the decoder when no index."""
        if len(data) != 0:
            while (self.avi_parsing_pos < len(self.frames)
                   and self.frames[self.avi_parsing_pos] is not None
                   and self.frames[self.avi_parsing_pos].data is not None
                   and len(self.frames[self.avi_parsing_pos].data) == 0):
                self._frame_arrived(self.avi_parsing_pos)
                self.avi_parsing_pos += 1
        if self.avi_parsing_pos >= len(self.frames):
            self.frames.extend([None] * (self.avi_parsing_pos + 1 - len(self.frames)))
        slot = self.frames[self.avi_parsing_pos]
        if slot is not None:
            slot.data = data
        else:
            key = (self.avi_parsing_pos == 0) or (
                self.decoder is not None and self.decoder.is_key_frame(data)
            )
            self.frames[self.avi_parsing_pos] = CompressedFrame(
                key=key, data=data, ix=-1
            )
        LOG.count("frames_demuxed")
        self._frame_arrived(self.avi_parsing_pos)
        self.avi_parsing_pos += 1

    def _frame_arrived(self, num: int) -> None:
        pass


class DataLoaderAVISeq(DataLoader):
    """Sequential whole-file loader (DataLoaderAVISeq.hx:12-62)."""

    def open(self, source: ByteSource,
             on_video_info: Optional[Callable[[VideoInfo], None]] = None
             ) -> None:
        self._video_info_cb = on_video_info
        self.stop_loading = False
        self.demuxer = AviDemuxer(
            self.buffer,
            on_frame=self._add_frame,
            on_video_info=self._on_video_info,
            on_sound=self._on_sound,
            on_indx=self._on_indx,
            on_ix=self._on_ix_inline,
        )
        self.demuxer.start()
        self._stream = source.stream_range(0, None, CHUNK_SIZE)

    def _on_sound(self, chunk: bytes) -> None:
        # DataLoaderAVISeq.add_sound_chunk (DataLoaderAVISeq.hx:51-55)
        self.sound_buffer.add_chunk(chunk)

    def loaded_frames_end(self) -> int:
        return self.avi_parsing_pos


class DataLoaderAVIIndexed(DataLoader):
    """Random-access streaming loader with a windowed compressed-frame cache
    (DataLoaderAVIIndexed.hx:21-688)."""

    def __init__(self, storage_limit: int = DEFAULT_STORAGE_LIMIT):
        super().__init__()
        self.storage_limit = storage_limit
        self.source: Optional[ByteSource] = None
        self.is_index_loaded = False
        self.first_frame_loaded = 0
        self.sum_size_loaded = 0
        self.last_loaded_key_frame = -1
        self.cur_last_key_frame = -1
        self.last_requested_frame = 0
        self.foi_copy = 0
        self.requested_frame_num = -1
        self._on_load_complete: Optional[Callable[[], None]] = None
        self._first_frame_seen = False

    # -- open ------------------------------------------------------------------

    def open(self, source: ByteSource,
             on_video_info: Optional[Callable[[VideoInfo], None]] = None
             ) -> None:
        # DataLoaderAVIIndexed.Open (DataLoaderAVIIndexed.hx:60-82)
        self.source = source
        self._video_info_cb = on_video_info
        self.stop_loading = False
        self.first_frame_loaded = 0
        self.last_requested_frame = 0
        self.reading_start_position = 0
        self._first_frame_seen = False
        self.demuxer = AviDemuxer(
            self.buffer,
            on_frame=self._on_frame_chunk,
            on_video_info=self._on_video_info,
            on_sound=self._on_sound,
            on_indx=self._on_indx,
            on_ix=self._on_ix_inline,
        )
        self.demuxer.start()
        self._stream = source.stream_range(0, PROBE_RANGE_END, CHUNK_SIZE)

    def _on_sound(self, chunk: bytes) -> None:
        # add_sound_chunk (DataLoaderAVIIndexed.hx:208-217): only from the
        # file head (mid-file sound offsets are not time-mapped)
        if self.reading_start_position == 0:
            self.sound_buffer.add_chunk(chunk)
            self.sum_size_loaded += len(chunk)
            self._dont_load_too_much(False)

    # -- frame ingestion -------------------------------------------------------

    def _on_frame_chunk(self, data: bytes) -> None:
        """First frame triggers index loading (on_first_frame,
        DataLoaderAVIIndexed.hx:135-152); after that normal add_frame
        (:161-206) with window accounting."""
        if not self._first_frame_seen:
            self._first_frame_seen = True
            self._add_frame_indexed(data)
            if self.indexes is None:
                self._load_idx1()
            else:
                self._load_missing_ixs()
            return
        self._add_frame_indexed(data)

    def _add_frame_indexed(self, data: bytes) -> None:
        self._add_frame(data)
        self.sum_size_loaded += len(data)
        pos = self.avi_parsing_pos - 1  # frame just written
        if self.frames[pos] is not None and self.frames[pos].key:
            self.cur_last_key_frame = pos
        force_stop = (
            pos >= self.last_requested_frame
            and not (self.reading_start_position == 0
                     and self.riff_size <= PROBE_RANGE_END)
        )
        self._dont_load_too_much(force_stop)

    def _frame_arrived(self, num: int) -> None:
        if num == self.requested_frame_num and self._on_load_complete:
            cb = self._on_load_complete
            self._on_load_complete = None
            cb()

    # -- index loading ---------------------------------------------------------

    def _load_idx1(self) -> None:
        """Fetch + parse idx1 after movi (start_loading_idx1/parse_idx1,
        DataLoaderAVIIndexed.hx:219-231, 276-350).  Synchronous range read —
        the pull model makes the continuation chain unnecessary."""
        if self.demuxer.movi_size_pos < 0:
            return
        pos = self.demuxer.movi_size_pos + self.demuxer.movi_size + 4
        data = self.source.read_range(pos, None)
        # scan chunks for idx1
        p = 0
        while p + 8 <= len(data):
            ckid = data[p : p + 4]
            cksize = (int.from_bytes(data[p + 4 : p + 8], "little") + 1) & ~1
            if ckid == b"idx1":
                video, audio, first_off = parse_idx1(data[p + 8 : p + 8 + cksize])
                base = (self.demuxer.movi_size_pos + 4
                        if first_off < self.demuxer.movi_size_pos else 0)
                x = Index(first_frame=0, last_frame=len(video) - 1,
                          base_offset=base, frames=video)
                self.indexes = [x]
                if audio:
                    self.audio_indexes = [Index(first_frame=0,
                                                last_frame=len(audio) - 1,
                                                base_offset=base, frames=audio)]
                self.update_keyframes_info(0)
                self._on_index_loaded()
                return
            p += 8 + cksize

    def _load_missing_ixs(self) -> None:
        # start_loading_ixs (DataLoaderAVIIndexed.hx:360-374)
        if self.indexes is None:
            return
        for i, x in enumerate(self.indexes):
            if x.frames is None:
                self._load_ix(i)
        self.is_index_loaded = True

    def _load_ix(self, n: int) -> bool:
        # start_loading_ix (DataLoaderAVIIndexed.hx:376-387): range-read the
        # ix## chunk and ingest.  → True only if the index was actually
        # ingested — callers must not retry on False (truncated file,
        # corrupt ix payload, or idx_offset mismatch), else they recurse on
        # identical state re-issuing the same failing range read forever.
        x = self.indexes[n]
        raw = self.source.read_range(x.idx_offset,
                                     x.idx_offset + x.size_in_bytes - 1)
        if len(raw) < 8:
            return False
        try:
            return self._ingest_ix(raw[8:], x.idx_offset)  # skip chunk header
        except ValueError:
            # corrupt ix payload: seek into this segment degrades to
            # NOT_READY instead of killing playback (the demux path raises
            # the documented ValueError; this synchronous path must not)
            return False

    def _on_index_loaded(self) -> None:
        self.is_index_loaded = True

    # -- GetFrame with seek I/O ------------------------------------------------

    def get_frame(self, num: int) -> FrameInfo:
        # DataLoaderAVIIndexed.GetFrame (DataLoaderAVIIndexed.hx:416-441);
        # num < 0 guard as in DataLoader.get_frame
        if num < 0 or num >= len(self.frames):
            return FrameInfo(FrameStatus.NOT_READY)
        f = self.frames[num]
        if f is None or f.data is None:
            d = num - self.avi_parsing_pos
            if 0 <= d < 100 and self.demuxer is not None and self.demuxer.active \
                    and self._stream is not None:
                self.requested_frame_num = num
                return FrameInfo(FrameStatus.LOADING)
            self._initiate_loading(num)
            return FrameInfo(FrameStatus.LOADING)
        return FrameInfo(FrameStatus.READY, f)

    def get_frame_not_loading(self, num: int) -> FrameInfo:
        return DataLoader.get_frame(self, num)

    def notify_player_position(self, pos: int) -> None:
        # NotifyPlayerPosition (DataLoaderAVIIndexed.hx:452-470)
        self.foi_copy = pos
        if pos == self.last_loaded_key_frame and (
                self.demuxer is None or not self.demuxer.active
                or self._stream is None):
            i = pos
            ln = len(self.frames)
            while i < ln and self.frames[i] is not None \
                    and self.frames[i].data is not None:
                i += 1
            if i < ln:
                self.last_loaded_key_frame = -1
                self._initiate_loading(i)

    def set_on_load_complete(self, handler: Callable[[], None]) -> None:
        self._on_load_complete = handler

    def _initiate_loading(self, num: int) -> None:
        # initiate_loading (DataLoaderAVIIndexed.hx:482-618)
        self.requested_frame_num = num
        if not self.is_index_loaded:
            return  # header pump still in progress; caller keeps pumping
        # find the index segment containing `num`; load it if missing
        ix = -1
        for i, x in enumerate(self.indexes or []):
            if x.first_frame <= num <= x.last_frame:
                if x.frames is None:
                    self._load_ix(i)
                ix = i
                break
        if ix < 0:
            return
        # nearest keyframe at or before num
        i = num
        kix = ix
        while i > 0 and self.frames[i] is not None and self.frames[i].ix >= 0 \
                and not self.frames[i].key:
            kix = self.frames[i].ix
            i -= 1
        if self.frames[i] is None or self.frames[i].ix < 0:
            if kix == 0 or self.indexes[kix - 1].frames is not None \
                    or not self._load_ix(kix - 1):
                # no earlier segment, nothing NEW to load (already-ingested
                # segment didn't unblock the walk — hostile coverage gap),
                # or the ix is unusable (truncated/corrupt): stay NOT_READY
                # instead of recursing on identical state forever
                return
            # each recursion level ingests a previously-unloaded segment, so
            # depth is bounded by the number of index segments
            return self._initiate_loading(num)
        nk = i
        # first unloaded frame between keyframe and num
        while i <= num and self.frames[i] is not None \
                and self.frames[i].data is not None:
            i += 1
        nu = min(i, num)

        if self.frames[nu] is None or self.frames[nu].ix < 0:
            return  # segment index failed to load above: can't place nu

        self._clear_memory(nk, num)
        self.first_frame_loaded = nk
        self.cur_last_key_frame = nk

        x = self.indexes[self.frames[nu].ix]
        offset = x.base_offset + x.frames[nu - x.first_frame].off

        # end of range: next keyframe at/after the window limit
        # (DataLoaderAVIIndexed.hx:578-597)
        nxk = self.get_next_keyframe(num)
        end_offset = None
        while nxk < len(self.frames) - 1:
            if self.frames[nxk] is None:
                break
            nkix = self.frames[nxk].ix
            if nkix < 0 or self.indexes[nkix] is None \
                    or self.indexes[nkix].frames is None:
                break
            xx = self.indexes[nkix]
            off1 = xx.base_offset + xx.frames[nxk - xx.first_frame].off
            if off1 - offset >= self.storage_limit:
                end_offset = off1
                break
            nxk = self.get_next_keyframe(nxk + 1)

        self.avi_parsing_pos = nu
        self.reading_start_position = offset
        self.last_requested_frame = nxk - 1
        self.stop_loading = False
        if end_offset is None:
            end_offset = offset + self.storage_limit + 500_000
        # restart demux mid-file (StartFromMiddle, AVIParser.hx:202-207)
        self.buffer = ChunkBuffer()
        self.demuxer = AviDemuxer(
            self.buffer,
            on_frame=self._add_frame_indexed,
            on_sound=self._on_sound,
            on_ix=self._on_ix_inline,
        )
        self.demuxer.start_from_middle()
        self._stream = self.source.stream_range(offset, end_offset - 1,
                                                CHUNK_SIZE)

    # -- window management -----------------------------------------------------

    def _dont_load_too_much(self, force_stop: bool) -> None:
        # dont_load_too_much (DataLoaderAVIIndexed.hx:638-654)
        if not force_stop:
            if self.sum_size_loaded < self.storage_limit:
                return
            if self.cur_last_key_frame <= self.foi_copy:
                return
        self._stream = None  # close connection
        self.stop_loading = True
        self.mp3_parser.on_data_end()
        self.last_loaded_key_frame = self.get_nearest_keyframe(
            self.avi_parsing_pos)

    def _clear_memory(self, nk: int, num: int) -> None:
        # clear_memory (DataLoaderAVIIndexed.hx:656-673)
        for i in range(0, nk):
            f = self.frames[i]
            if f is not None and f.data is not None and len(f.data) != 0:
                f.data = None
        for i in range(num, len(self.frames)):
            f = self.frames[i]
            if f is not None and f.data is not None and len(f.data) != 0:
                f.data = None
        self.sum_size_loaded = 0
        for i in range(nk, num):
            f = self.frames[i]
            if f is not None and f.data is not None:
                self.sum_size_loaded += len(f.data)
        self.sound_buffer.clear()
        # the parser's pending frames/position reference the cleared buffer;
        # finalizing them later would IndexError out of Manager.worker's
        # parse_sound piggyback (seek-with-audio crash)
        self.mp3_parser.reset()
        self.audio_track.clear()

    def loaded_frames_end(self) -> int:
        return self.avi_parsing_pos

    def loaded_frames_start(self) -> int:
        return self.first_frame_loaded

    def audio_time_loaded(self, fps: float) -> float:
        # AudioTimeLoaded override (DataLoaderAVIIndexed.hx:680-686)
        if self.reading_start_position == 0:
            return super().audio_time_loaded(fps)
        return len(self.frames) / fps
