"""Live MinKNOW ReadUntil adapter (reference uncalled/minknow_client.py).

Wraps ONT's `read_until` API behind the same surface ClientSim provides,
so run_sim_loop drives either.  Adds the run-state machinery the bare
ReadUntilClient lacks (reference minknow_client.py:66-226):

* **wait-for-start**: poll MinKNOW's acquisition status; if the run is
  STARTING, push the desired chunk length (``break_reads_after_seconds``)
  into the analysis configuration before data flows; once PROCESSING,
  require a steady-state dwell before mapping begins.
* **mux-scan monitor**: a channel-states watcher counts channels per
  active well; when >scan_thresh of the off-zero channels agree on one
  mux, the flow cell is in a mux scan and ejections are suppressed
  (``should_eject() == False``) — ejecting during a scan wastes reads,
  the exact failure the reference guards against.
* **chunk dtype dispatch**: raw chunks arrive as float32 / int16 / int32
  depending on MinKNOW version; ints are widened to f32 *without*
  calibration, matching the reference (chunk.cpp:16-50 — its calibrate
  calls are commented out; the streaming normalizer's z-score makes
  per-channel scale/offset irrelevant to mapping).

The ONT packages (read_until_api, minknow_api, grpc) are optional; a
``connection_factory`` injection point lets tests drive the full state
machine with a fake client (tests/test_torch_live_client.py).
"""

from __future__ import annotations

import logging
import sys
import threading
import time

import numpy as np

from ..config import Conf

# MinKNOW acquisition status / run state enums (minknow_client.py:17-26)
MK_ERROR, MK_READY, MK_STARTING, MK_PROCESSING, MK_FINISHING = range(5)
RN_STARTING, RN_RUNNING, RN_FINISHING, RN_COMPLETED = range(4)

log = logging.getLogger("uncalled_tpu_torch.live")


def chunk_signal_f32(raw_data, signal_dtype) -> np.ndarray:
    """Decode a raw chunk buffer to f32 (chunk.cpp:16-50 dtype dispatch).

    int16/int32 values pass through numerically unchanged — the reference
    does NOT calibrate live chunks (its calibrate calls are commented
    out) because global/streaming normalization removes scale+offset.
    """
    dt = np.dtype(signal_dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.int16),
                  np.dtype(np.int32)):
        raise ValueError(f"unsupported raw signal dtype {dt}")
    return np.frombuffer(raw_data, dtype=dt).astype(np.float32)


def calibrate_fast5(int_data: np.ndarray, digitisation: float, range_: float,
                    offset: float) -> np.ndarray:
    """Fast5 calibration incl. the reference's u16 wrap quirk
    (read_buffer.cpp:239: ``for (u16 raw : int_data)`` reinterprets the
    signed samples, so -3 becomes 65533 before calibration)."""
    u16 = int_data.astype(np.int16).view(np.uint16).astype(np.float32)
    return (range_ * (u16 + offset) / digitisation).astype(np.float32)


class MuxScanMonitor:
    """Channel-state watcher -> in_scan flag (minknow_client.py:101-163).

    Consumes channel-state update batches; tracks each channel's active
    well (mux) and flags a mux scan when one well holds more than
    ``scan_thresh`` of all channels not in well 0."""

    def __init__(self, num_channels: int, scan_thresh: float = 0.99):
        self.scan_thresh = scan_thresh
        self.ch_mux = np.zeros(num_channels, dtype=int)
        self.mux_counts = np.zeros(5, dtype=float)
        self.mux_counts[0] = num_channels
        self.in_scan = True  # conservative until states arrive
        self.last_scan = time.time()

    def update(self, channel_states) -> None:
        """channel_states: iterable of (channel_1based, well) pairs."""
        for ch, well in channel_states:
            old = self.ch_mux[ch - 1]
            if old != well:
                self.mux_counts[old] -= 1
                self.mux_counts[well] += 1
                self.ch_mux[ch - 1] = well
        m = int(np.argmax(self.mux_counts))
        off_zero = len(self.ch_mux) - self.mux_counts[0]
        self.in_scan = bool(
            m != 0 and off_zero > 0
            and self.mux_counts[m] / off_zero > self.scan_thresh
        )
        if self.in_scan:
            self.last_scan = time.time()


class MinknowClient:
    """ClientSim-shaped surface over ReadUntilClient + run-state machinery.

    get_read_chunks()/unblock_read()/stop_receiving_read()/should_eject()
    /is_running()/get_runtime().  ``connection_factory`` (tests) must
    return an object with the ReadUntilClient surface plus
    ``.connection`` exposing acquisition/analysis_configuration/data.
    """

    def __init__(self, conf: Conf, host: str, port: int, chunk_time: float,
                 scan_thresh: float = 0.99, connection_factory=None):
        self.conf = conf
        self.chunk_time = chunk_time
        self.num_channels = conf.reads.num_channels
        # run_sim_loop sizes its per-channel state by len(client.channels),
        # as ClientSim has it; the JAX client lacks the attribute, so its
        # `realtime` command stops with an AttributeError before the loop
        self.channels = range(1, self.num_channels + 1)
        if connection_factory is None:
            try:
                from read_until import ReadUntilClient  # type: ignore
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "live realtime mode needs ONT's read_until/minknow_api "
                    "packages; use `sim` for the hardware-free simulator"
                ) from e

            def connection_factory():
                return ReadUntilClient(
                    mk_host=host, mk_port=port, one_chunk=False,
                    filter_strands=True,
                )

        self._client = connection_factory()
        self.monitor = MuxScanMonitor(self.num_channels, scan_thresh)
        self._mon_thread = None
        self._mon_running = threading.Event()
        self._t0 = None

    # ---------------------------------------------------------- run state
    def _mk_status(self):
        return self._client.connection.acquisition.current_status().status

    def _run_state(self):
        return self._client.connection.acquisition.get_acquisition_info().state

    def _update_chunk_len(self, change=True) -> bool:
        """Align MinKNOW's chunk length with ours; True if they differed
        (minknow_client.py:208-226)."""
        anl = self._client.connection.analysis_configuration
        try:
            cfg = anl.get_analysis_configuration()
        except Exception:
            log.warning(
                "failed to check chunk size; if MinKNOW uses 1 s chunks "
                "this is fine"
            )
            return False
        cur = cfg.read_detection.break_reads_after_seconds.value
        if cur != self.chunk_time:
            if change:
                cfg.read_detection.break_reads_after_seconds.value = (
                    self.chunk_time
                )
                anl.set_analysis_configuration(cfg)
                log.info("set chunk size to %.2f s", self.chunk_time)
            return True
        return False

    def wait_for_start(self, steady=10.0, refresh=0.01,
                       clock=time.monotonic, sleep=time.sleep) -> bool:
        """Block until MinKNOW reaches steady PROCESSING
        (minknow_client.py:174-206).  Pushes the chunk length while the
        run is STARTING; refuses a mid-run chunk-length change."""
        if self._mk_status() == MK_PROCESSING:
            log.info("run already in progress")
            if self._update_chunk_len(change=False):
                sys.stderr.write(
                    "ERROR: cannot set chunk size mid-run; restart the "
                    "sequencing run with UNCALLED already waiting\n"
                )
                return False
            return True

        proc_since = None
        log.info("waiting for run to start")
        while True:
            status = self._mk_status()
            if status == MK_STARTING or self._run_state() == RN_STARTING:
                self._update_chunk_len(change=True)
            if status == MK_PROCESSING:
                if proc_since is None:
                    proc_since = clock()
                    log.info("waiting for steady state")
                elif clock() - proc_since >= steady:
                    return True
            else:
                proc_since = None
            sleep(refresh)

    # ------------------------------------------------------ scan monitor
    def _monitor_loop(self):
        stream = self._client.connection.data.get_channel_states(
            first_channel=1, last_channel=self.num_channels,
            use_channel_states_ids=False,
        )
        try:
            for batch in stream:
                if not self._mon_running.is_set():
                    break
                self.monitor.update(
                    (s.channel, int(s.config.well))
                    for s in batch.channel_states
                )
                if self._mk_status() != MK_PROCESSING:
                    self._mon_running.clear()
                    stop = getattr(self._client, "running", None)
                    if stop is not None:
                        stop.clear()
                    break
        except Exception:
            log.exception("channel monitor failed")
        finally:
            cancel = getattr(stream, "cancel", None)
            if cancel:
                cancel()

    def _start_monitor(self):
        self._mon_running.set()
        self._mon_thread = threading.Thread(
            target=self._monitor_loop, name="channel_monitor", daemon=True
        )
        self._mon_thread.start()

    # ----------------------------------------------------------- surface
    def run(self, steady_wait=10.0, refresh=0.5) -> bool:
        if not self.wait_for_start(steady_wait, refresh):
            return False
        self._start_monitor()
        self._client.run(last_channel=self.num_channels)
        self._t0 = time.monotonic()
        return True

    def reset(self):
        if self._mon_thread is not None:
            self._mon_running.clear()
            self._mon_thread.join(timeout=5)
            self._mon_thread = None
        reset = getattr(self._client, "reset", None)
        if reset:
            reset()

    def is_running(self):
        return bool(self._client.is_running)

    def get_runtime(self):
        return time.monotonic() - self._t0 if self._t0 else 0.0

    def should_eject(self):
        return not self.monitor.in_scan

    def get_read_chunks(self):
        out = []
        for channel, read in self._client.get_read_chunks(
            batch_size=self._client.queue_length, last=True
        ):
            sig = chunk_signal_f32(read.raw_data, self._client.signal_dtype)
            chunk = type(
                "Chunk", (), {
                    "channel": channel,
                    "number": read.number,
                    "start": read.chunk_start_sample,
                    "signal": sig,
                    "read_id": read.id,
                },
            )()
            out.append((channel, chunk))
        return out

    def unblock_read(self, ch, number):
        self._client.unblock_read(ch, number)
        return None  # no delay to report on live runs (scripts/uncalled:233)

    def stop_receiving_read(self, ch, number):
        self._client.stop_receiving_read(ch, number)


def run_realtime(args):
    """CLI entry (`python -m uncalled_tpu_torch realtime`).  Like the JAX
    entry it builds its own Conf from ``--conf`` and leaves the reflected
    ``--<section>-<field>`` overrides unread."""
    from ..index.fmindex import load_index
    from ..mapping.thresholds import load_uncl
    from ..poremodel import load_default
    from .mapper import RealtimeMapper
    from .sim import run_sim_loop

    conf = Conf()
    if getattr(args, "conf", None):
        conf.load_toml(args.conf)
    conf.reads.chunk_time = args.chunk_time
    conf.engine.evt_block = args.evt_block

    fmi = load_index(args.bwa_prefix)
    threshes = load_uncl(args.bwa_prefix + ".uncl", args.idx_preset)
    client = MinknowClient(conf, args.host, args.port, args.chunk_time)
    rt = RealtimeMapper(
        fmi, load_default(), threshes, conf,
        P=args.max_paths, C=args.max_paths, R=args.seed_rows, CL=args.clusters,
        device=args.device,
    )
    run_sim_loop(
        client, rt, conf, deplete=not args.enrich, even=args.even,
        odd=args.odd, duration=args.duration,
    )
