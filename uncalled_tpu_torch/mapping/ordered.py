"""Ordered chunked replay of batch reads (reference MapPoolOrd).

Maps fast5 reads as if they streamed in realtime chunk order: reads are
bucketed per channel, sorted by start sample, and fed one chunk per channel
per tick into the channel-pinned realtime mapper
(map_pool_ord.cpp:48-112). Used to exercise the streaming-normalization
path on recorded data.
"""

from __future__ import annotations

from ..config import Conf
from ..realtime.mapper import RealtimeMapper


class _OrdChunk:
    def __init__(self, channel, number, start, signal, read_id):
        self.channel = channel
        self.number = number
        self.start = start
        self.signal = signal
        self.read_id = read_id


def map_ordered(fmi, model, threshes, reads, conf: Conf | None = None,
                **over):
    """Generator over Paf results in completion order."""
    conf = conf or Conf()
    chunk_len = conf.reads.chunk_len

    # bucket per channel, sorted by start sample (map_pool_ord.cpp:48-59)
    per_ch: dict[int, list] = {}
    for r in reads:
        per_ch.setdefault(r.channel, []).append(r)
    for ch in per_ch:
        per_ch[ch].sort(key=lambda r: r.start_sample)

    channels = sorted(per_ch)
    if not channels:
        return
    ch_map = {ch: i + 1 for i, ch in enumerate(channels)}
    conf.reads.num_channels = max(len(channels), 1)
    rt = RealtimeMapper(fmi, model, threshes, conf, **over)

    # chunk cursors: (read_idx, chunk_idx) per channel
    cursors = {ch: [0, 0] for ch in channels}
    numbers = {ch: 0 for ch in channels}
    tick = 0
    active = True
    while active:
        active = False
        batch = []
        for ch in channels:
            ri, ci = cursors[ch]
            lst = per_ch[ch]
            if ri >= len(lst):
                continue
            r = lst[ri]
            st = ci * chunk_len
            if st >= r.raw_len:
                cursors[ch] = [ri + 1, 0]
                numbers[ch] += 1
                ri, ci = cursors[ch]
                if ri >= len(lst):
                    continue
                r = lst[ri]
                st = 0
            sig = r.signal[st : st + chunk_len]
            batch.append(
                (
                    ch_map[ch],
                    _OrdChunk(ch_map[ch], numbers[ch], r.start_sample + st,
                              sig, r.id),
                )
            )
            cursors[ch][1] += 1
            active = True
        now = tick * conf.reads.chunk_time
        if batch:
            rt.add_chunks(batch, now)
        for _, _, paf in rt.update(now):
            yield paf
        tick += 1

    # drain: remaining undecided channels keep mapping queued events
    for _ in range(64):
        done = True
        now = tick * conf.reads.chunk_time
        out = rt.update(now)
        for _, _, paf in out:
            yield paf
        for c in rt.channels:
            if c.number >= 0 and not c.done_reported:
                done = False
        if done:
            break
        tick += 1
    # anything still unfinished is emitted as ended/unmapped
    for i, c in enumerate(rt.channels):
        if c.number >= 0 and not c.done_reported:
            paf = rt._make_paf(i, c, None, False)
            paf.ended = True
            c.done_reported = True
            yield paf
