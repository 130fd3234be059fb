"""HTTP serving daemon for the port's artifacts and live pipelines
(stdlib only; port of ``vsr_tpu/serve.py``).

A long-lived process that owns the card, keeps its programs loaded and warm,
and serves volumes over the network. It fronts exported artifacts
(``vsr_tpu_torch.export``: ``torch.export`` programs with their weights; no
model code or checkpoint at serving time) and live pipelines (net +
checkpoint through ``infer.make_pipeline``) behind a small HTTP API:

  GET  /healthz          liveness + loaded-program summary (503 until warm)
  GET  /v1/meta          every program's metadata (shapes, factor, modes)
  GET  /metrics          Prometheus text exposition (requests, latency,
                         volumes, batching)
  POST /v1/sr            super-resolve one volume
  POST /v1/stream/open, /v1/stream/<id>/push|flush|reset, DELETE
  /v1/stream/<id>        frame-at-a-time sessions (``vsr_tpu_torch.stream``)
  POST /debug/profile?seconds=S   a ``torch.profiler`` chrome trace of the
                         live traffic, zipped

``/v1/sr`` takes a raw ``.npy`` body (float HR frames ``(N, H, W)``,
``Content-Type: application/x-npy``) or a NIfTI volume (``.nii`` /
``.nii.gz`` bytes, any other content type), preprocessed as the infer CLI
and ``export --run`` do (outlier clip + /12 center crop). The response
mirrors the request's format (override with ``?format=npy|nii``).

Serving semantics:
- Programs are shape-specialized. Requests route to a program whose
  ``(H, W)`` matches; frame counts are bridged by batching the volume
  through the program's frame dim, padding the last call by repeating its
  final granule and slicing the SR back.
- One device executor: HTTP I/O is threaded, device calls are serialized
  under one lock, so queueing shows in /metrics.
- Dynamic batching: concurrent requests coalesce into shared program calls
  at each program's sound granule (frames for per-frame programs, whole
  T-frame sequences for video / window programs; volume programs serve
  their exact size only). ``--batch-wait-ms`` optionally waits to fill.
- Programs are warmed at startup (one call on zeros), so the first request
  does not pay the card's first-call costs.

Differences from the JAX daemon: ``/debug/profile`` records with
``torch.profiler``; ``--device`` (default ``cuda``) names the card; the
mesh-sharded live mode is not ported and is refused by name; ``--preset``
/ ``--preset-file`` fill the live ``--net``'s knobs from the card's table
(``presets.py``). The live backend serves ``--int8`` and ``--w8a8-scales`` (with
``--w8a8-kernels``); a quantized artifact carries its kernels in its
program.

CLI:
  python -m vsr_tpu_torch.serve --artifact drf_x2.pt2.zip [--artifact ...] \
      [--net ... --checkpoint ... --frames-shape N,H,W] \
      [--stream-net ...] [--host 127.0.0.1] [--port 8973] [--no-warmup]
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from vsr_tpu_torch.export import ExportedServing

_LAT_BUCKETS = (0.05, 0.25, 1.0, 5.0, 30.0, float("inf"))


class Metrics:
    """Tiny thread-safe Prometheus-style registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = {}  # (endpoint, status) -> count
        self.lat_sum = 0.0
        self.lat_count = 0
        self.lat_buckets = [0] * len(_LAT_BUCKETS)
        self.volumes = 0
        self.padded_frames = 0
        self.inflight = 0
        self.batch_calls = 0          # device dispatches through batchers
        self.coalesced_requests = 0   # segments that shared a dispatch

    def observe(self, endpoint: str, status: int, seconds: float) -> None:
        with self._lock:
            key = (endpoint, status)
            self.requests[key] = self.requests.get(key, 0) + 1
            if endpoint == "/v1/sr" and status == 200:
                self.lat_sum += seconds
                self.lat_count += 1
                # Per-bucket counts; render() cumulates for the exposition.
                for i, b in enumerate(_LAT_BUCKETS):
                    if seconds <= b:
                        self.lat_buckets[i] += 1
                        break

    @staticmethod
    def _label(value: str) -> str:
        """Escape a Prometheus label value (backslash, quote, newline)."""
        return (value.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def render(self) -> str:
        with self._lock:
            lines = ["# TYPE vsr_requests_total counter"]
            for (ep, st), n in sorted(self.requests.items()):
                lines.append(f'vsr_requests_total{{endpoint='
                             f'"{self._label(ep)}",status="{st}"}} {n}')
            lines.append("# TYPE vsr_sr_latency_seconds histogram")
            acc = 0
            for i, b in enumerate(_LAT_BUCKETS):
                acc += self.lat_buckets[i]
                le = "+Inf" if b == float("inf") else repr(b)
                lines.append(f'vsr_sr_latency_seconds_bucket{{le="{le}"}} {acc}')
            lines.append(f"vsr_sr_latency_seconds_sum {self.lat_sum}")
            lines.append(f"vsr_sr_latency_seconds_count {self.lat_count}")
            lines.append("# TYPE vsr_volumes_served_total counter")
            lines.append(f"vsr_volumes_served_total {self.volumes}")
            lines.append("# TYPE vsr_padded_frames_total counter")
            lines.append(f"vsr_padded_frames_total {self.padded_frames}")
            lines.append("# TYPE vsr_batched_calls_total counter")
            lines.append(f"vsr_batched_calls_total {self.batch_calls}")
            lines.append("# TYPE vsr_coalesced_requests_total counter")
            lines.append(
                f"vsr_coalesced_requests_total {self.coalesced_requests}")
            lines.append("# TYPE vsr_inflight_requests gauge")
            lines.append(f"vsr_inflight_requests {self.inflight}")
            return "\n".join(lines) + "\n"


class LivePipeline:
    """A live serving program built from net + checkpoint: the daemon's
    second backend (``build_serving_net`` + ``infer.make_pipeline``, on
    ``device``). ``meta`` mirrors :class:`ExportedServing`'s, so
    :class:`ArtifactPool` routes both kinds alike."""

    def __init__(self, *, net_name: str, net_kwargs: dict, checkpoint: str,
                 frames_shape, factor: int, dataset: str = "acdc",
                 video_t=None, window=None, volume=None, chunk: int = 0,
                 int8: bool = False, w8a8=False, w8a8_kernels=None,
                 device: torch.device | str = "cuda"):
        from vsr_tpu_torch.infer import build_serving_net, make_pipeline

        if w8a8 is True:
            raise ValueError(
                "live serving warms programs on zero batches — lazy "
                "first-batch W8A8 calibration would bake degenerate "
                "scales; pass precomputed static scales (a {path: scale} "
                "dict / --w8a8-scales)")
        self.device = torch.device(device)
        net = build_serving_net(net_name, net_kwargs, checkpoint,
                                device=self.device)
        self._pipe = make_pipeline(net, factor, dataset, video_t=video_t or 0,
                                   window=window, volume=volume, chunk=chunk,
                                   int8=int8, w8a8=w8a8,
                                   w8a8_kernels=w8a8_kernels)
        self.meta = {
            "frames_shape": list(frames_shape),
            "factor": factor,
            "dataset": dataset,
            "net": net_name,
            "video_t": video_t,
            "window": list(window) if window else None,
            "volume": list(volume) if volume else None,
            "chunk": chunk,
            "int8": int8,
            "w8a8_convs": len(w8a8) if isinstance(w8a8, dict) else 0,
            "mesh": None,
            "device": self.device.type,
            "live": True,
        }

    def __call__(self, frames):
        frames = torch.as_tensor(frames, dtype=torch.float32)
        return self._pipe(frames.to(self.device))


class StreamManager:
    """Streaming (online) sessions over one net spec (``stream.py``).

    One template stream is built lazily from the spec; every session is a
    ``fork()`` of it: the net shared, the temporal state per session, on
    the device. Device calls are serialized under the pool's device lock
    like the batch endpoints."""

    MAX_SESSIONS = 16

    def __init__(self, spec: dict | None, device: torch.device | str = "cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._counter = 0
        self._template = None

    def _build_template(self):
        if self._template is None:
            from vsr_tpu_torch.infer import build_serving_net
            from vsr_tpu_torch.stream import make_stream

            s = self.spec
            net = build_serving_net(s["net"], s.get("net_kwargs", {}),
                                    s.get("checkpoint", ""),
                                    device=self.device)
            self._template = make_stream(
                net, factor=s.get("factor", 2),
                dataset=s.get("dataset", "acdc"),
                windows=s.get("windows", 0), order=s.get("order", "middle"))
        return self._template

    def open(self) -> str:
        if self.spec is None:
            raise LookupError(
                "no streaming net configured (--stream-net ...)")
        with self._lock:
            if len(self._sessions) >= self.MAX_SESSIONS:
                raise RuntimeError(
                    f"session limit reached ({self.MAX_SESSIONS}); close "
                    "idle sessions (DELETE /v1/stream/<id>)")
            template = self._build_template()
            sid = f"s{self._counter}"
            self._counter += 1
            self._sessions[sid] = {"stream": template.fork(), "pushed": 0}
            return sid

    def get(self, sid: str):
        with self._lock:
            if sid not in self._sessions:
                raise KeyError(f"unknown stream session {sid!r}")
            return self._sessions[sid]

    def close(self, sid: str) -> None:
        with self._lock:
            if self._sessions.pop(sid, None) is None:
                raise KeyError(f"unknown stream session {sid!r}")

    def push(self, sid: str, frames: np.ndarray, device_lock):
        """Push one (N, H, W) time point; returns ``(t, sr)`` or ``None``
        while a window stream's context is filling."""
        sess = self.get(sid)
        with device_lock:
            # the counter lives under the device lock so concurrent pushes
            # to one session get indices matching device execution order
            out = sess["stream"].push(frames)
            t = sess["pushed"]
            sess["pushed"] += 1
        if out is None:
            return None
        if len(out) == 3:  # window stream: (t_out, lr, sr)
            t = out[0]
        return t, out[-1].cpu().numpy()

    def flush(self, sid: str, device_lock):
        """End the sequence: returns ``(indices, srs)`` for the deferred
        boundary frames (empty for recurrent/per-frame streams) and resets
        the session for the next sequence."""
        sess = self.get(sid)
        with device_lock:
            outs = sess["stream"].flush()
        sess["stream"].reset()  # no-op for window streams (flush resets)
        sess["pushed"] = 0
        return ([t for t, _lr, _sr in outs],
                [sr.cpu().numpy() for _t, _lr, sr in outs])

    @property
    def meta(self):
        if self.spec is None:
            return None
        return {**self.spec, "sessions": len(self._sessions),
                "max_sessions": self.MAX_SESSIONS}


def _regroup_t(meta: dict) -> int | None:
    """The per-slice T a sequence-regrouping program assumes for its
    N = D*T frame dim (volume / whole-sequence video / MISR window modes),
    or None for per-frame programs."""
    if meta.get("volume"):
        return int(meta["volume"][1])
    if meta.get("video_t"):
        return int(meta["video_t"])
    if meta.get("window"):
        return int(meta["window"][1])
    return None


def _coalesce_unit(meta: dict) -> int | None:
    """The frame granule at which independent requests can share one program
    call, or None when cross-request coalescing is unsound.

    - per-frame programs: every frame is an independent batch sample -> 1;
    - whole-sequence video / MISR window programs: the program regroups
      N = D*T frames into D INDEPENDENT per-slice sequences (infer.py
      make_prep), so whole T-frame sequences from different requests
      compose exactly -> T;
    - volume programs: D is the net's depth axis — concatenating frames
      from two patients would splice them into ONE volume and the 3D conv
      halos would bleed across the boundary -> None (exact-size only).
    """
    if meta.get("volume"):
        return None
    t = _regroup_t(meta)
    return int(t) if t else 1


class _Item:
    __slots__ = ("frames", "out", "err", "done")

    def __init__(self, frames):
        self.frames = frames
        self.out = None
        self.err = None
        self.done = threading.Event()


class _Batcher:
    """Dynamic cross-request batching for ONE serving program.

    Concurrent requests' frame segments coalesce into a single device call
    (leader-follower: the thread whose segment completes the fill — or the
    first whose fill-wait expires — dispatches everything pending). With
    ``wait_s == 0`` batching is still opportunistic and latency-free:
    segments that queue up while the card is busy with the previous call go
    out together in the next one, so a program of several volumes a call
    fills its batch from independent single-volume requests instead of
    padding most of every call.

    Exactness: segments are whole coalescing granules (frames for per-frame
    programs, T-frame sequences for video/window programs — every granule
    is an independent batch sample of the program), the remainder is padded
    by repeating the final granule, and each requester gets back exactly
    its own output rows. Per-request results are bitwise identical to a
    batch the request filled alone wherever the program repeats its own
    bits: on the CPU, and on the card for programs whose kernels are
    deterministic. cuDNN's default f32 transposed convs (DRFNet's k6 s2
    deconvs) are not, so on the card such a program agrees with itself,
    and a request with its solo batch, to >= 99.9 % exact grey and <= 1
    grey unless ``torch.backends.cudnn.deterministic`` is set.
    """

    def __init__(self, call_fn, cap: int, unit: int, wait_s: float,
                 metrics_ref):
        self._call = call_fn                  # (cap, H, W) -> (cap, H, W)
        self.cap = (cap // unit) * unit       # usable, granule-aligned
        self.unit = unit
        self.wait_s = wait_s
        self._metrics_ref = metrics_ref       # () -> Metrics | None
        self._cond = threading.Condition()
        self._pending: list[_Item] = []
        self._size = 0
        self._dispatching = False

    def submit(self, frames: np.ndarray) -> np.ndarray:
        """Blocking: returns this segment's SR rows. ``frames`` must be a
        multiple of the granule and at most ``cap`` frames."""
        n = frames.shape[0]
        if not 0 < n <= self.cap or n % self.unit:
            # An over-cap segment can never join a batch: _dispatch_locked
            # would spin on an empty prefix forever. Enforce the contract
            # here instead of hanging the caller.
            raise ValueError(
                f"segment of {n} frames violates the batcher contract "
                f"(granule {self.unit}, cap {self.cap})")
        item = _Item(frames)
        with self._cond:
            self._pending.append(item)
            self._size += frames.shape[0]
            if self._size >= self.cap:
                self._cond.notify_all()       # wake a fill-waiting leader
            elif self.wait_s > 0:
                deadline = time.monotonic() + self.wait_s
                while (not item.done.is_set() and self._size < self.cap):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            # Dispatch loop: whoever holds the lock while its item is still
            # queued and no dispatch is in flight becomes the leader.
            while not item.done.is_set():
                if item in self._pending and not self._dispatching:
                    self._dispatch_locked()
                else:
                    self._cond.wait(0.05)
        if item.err is not None:
            raise item.err
        return item.out

    def _dispatch_locked(self):
        """Take a FIFO prefix of pending segments that fits the program,
        run the call outside the lock, scatter outputs. Caller holds
        ``self._cond``."""
        batch: list[_Item] = []
        total = 0
        for it in self._pending:
            if total + it.frames.shape[0] > self.cap:
                break
            batch.append(it)
            total += it.frames.shape[0]
        for it in batch:
            self._pending.remove(it)
        self._size -= total
        self._dispatching = True
        self._cond.release()
        try:
            x = np.concatenate([it.frames for it in batch], axis=0)
            pad = self.cap - total
            if pad:
                x = np.concatenate(
                    [x, np.tile(x[-self.unit:],
                                (pad // self.unit, 1, 1))], axis=0)
            sr = self._call(np.ascontiguousarray(x, np.float32))
            m = self._metrics_ref()
            if m is not None:
                with m._lock:
                    m.batch_calls += 1
                    m.padded_frames += pad
                    if len(batch) > 1:
                        m.coalesced_requests += len(batch)
            off = 0
            for it in batch:
                n = it.frames.shape[0]
                it.out = sr[off:off + n]
                off += n
        except Exception as exc:  # surface to every waiting requester
            for it in batch:
                it.err = exc
        finally:
            self._cond.acquire()
            self._dispatching = False
            for it in batch:
                it.done.set()
            self._cond.notify_all()


class ArtifactPool:
    """Loaded artifacts + routing + the serialized device executor."""

    def __init__(self, paths, warmup: bool = True, live=(),
                 allow_empty: bool = False, batch_wait_ms: float = 0.0,
                 device: torch.device | str = "cuda"):
        if not paths and not live and not allow_empty:
            raise ValueError(
                "at least one --artifact or live --net serving is required")
        # An artifact is a file, or an ExportedServing already loaded (a
        # caller that holds one need not pay the program's load again).
        self.servings = [p if isinstance(p, ExportedServing)
                         else ExportedServing(p, device=device)
                         for p in paths] + list(live)
        self.paths = [str(getattr(p, "path", p)) for p in paths] + [
            f"live:{s.meta['net']}" for s in live]
        self._device_lock = threading.Lock()
        self._warmed: set = set()  # ids of servings run at least once
        self.metrics = None        # attached by make_server
        self._batch_wait_s = float(batch_wait_ms) / 1000.0
        self._batchers: dict[int, _Batcher] = {}
        self._batchers_lock = threading.Lock()
        if warmup:
            self.warmup()

    @property
    def warm(self) -> bool:
        """True once every program has compiled (at startup, or — under
        --no-warmup — lazily as requests exercise each artifact)."""
        return len(self._warmed) == len(self.servings)

    def warmup(self) -> None:
        for s in self.servings:
            zeros = np.zeros(s.meta["frames_shape"], np.float32)
            self._call(s, zeros)

    def _call(self, serving, frames: np.ndarray) -> np.ndarray:
        # The host-to-device copy and the copy back stay OUTSIDE the device
        # lock; the lock covers the program's launches, so one request's
        # copies overlap the next request's program.
        x = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(
            serving.device)
        with self._device_lock:
            _, sr = serving(x)
            self._warmed.add(id(serving))
        return sr.cpu().numpy()

    def route(self, frames_shape, req_t: int | None = None
              ) -> ExportedServing | LivePipeline:
        """Pick the artifact for an (M, H, W) input: exact shape first, then
        same (H, W) with the largest frame dim <= M (fewest padded calls),
        then the smallest frame dim (one padded call).

        ``req_t``: the request's frames-per-slice (known for NIfTI
        requests) — an exact-N sequence-regrouping program whose T differs
        is NOT a match (it would scramble the (D, T) order), so routing
        falls through to bridgeable per-frame programs instead of failing
        later."""
        n, h, w = frames_shape
        same_hw = [s for s in self.servings
                   if tuple(s.meta["frames_shape"][1:]) == (h, w)]
        if not same_hw:
            have = sorted({tuple(s.meta["frames_shape"][1:])
                           for s in self.servings})
            raise LookupError(
                f"no artifact for HR geometry {h}x{w}; loaded: {have}")
        exact = [s for s in same_hw if s.meta["frames_shape"][0] == n
                 and (req_t is None
                      or _regroup_t(s.meta) in (None, req_t))]
        if exact:
            return exact[0]
        # Mismatched frame counts bridge at the program's coalescing
        # granule (_coalesce_unit): per-frame programs chunk freely;
        # video/window programs accept any whole number of T-frame
        # sequences (each sequence is an independent batch sample, padding
        # repeats whole sequences — exact); volume programs serve their
        # exact D*T only (depth is structural, see _coalesce_unit).
        def _bridge_ok(s):
            unit = _coalesce_unit(s.meta)
            if unit is None:
                return False
            if unit > 1 and (n % unit or req_t not in (None, unit)):
                return False
            return True

        bridgeable = [s for s in same_hw if _bridge_ok(s)]
        if not bridgeable:
            raise LookupError(
                f"no program bridges {n} frames at {h}x{w}: volume-mode "
                f"programs serve their exact D*T frame count only, and "
                f"video/window programs need a whole number of matching "
                f"T-frame sequences; add a program per geometry")
        fits = [s for s in bridgeable if s.meta["frames_shape"][0] <= n]
        if fits:
            return max(fits, key=lambda s: s.meta["frames_shape"][0])
        return min(bridgeable, key=lambda s: s.meta["frames_shape"][0])

    def sr_volume(self, frames: np.ndarray, metrics: Metrics,
                  nii_geom=None) -> np.ndarray:
        """Super-resolve (M, H, W) HR frames through the routed artifact,
        bridging M to the artifact's frame dim by edge-padded chunking.

        ``nii_geom``: the request's (h, w, d, t) when it arrived as NIfTI —
        validated against sequence-regrouping programs so an exact-N match
        with a DIFFERENT (d, t) factorization is refused instead of
        silently scrambling slices/time."""
        serving = self.route(
            frames.shape,
            req_t=nii_geom[3] if nii_geom is not None else None)
        want_t = _regroup_t(serving.meta)
        if want_t and nii_geom is not None and nii_geom[3] != want_t:
            raise LookupError(
                f"program expects sequences of T={want_t} frames per "
                f"slice; this volume has t={nii_geom[3]} (d={nii_geom[2]})"
                " — regrouping would scramble the (D, T) order")
        unit = _coalesce_unit(serving.meta)
        if unit is None:
            # Volume program: route guarantees the exact frame count
            # (cross-request coalescing is unsound — see _coalesce_unit).
            sr = self._call(serving,
                            np.ascontiguousarray(frames, np.float32))
        else:
            if frames.shape[0] % unit:
                raise LookupError(   # unreachable via route(); guards
                    f"{frames.shape[0]} frames is not a whole number of "
                    f"T={unit} sequences")  # direct pool callers
            batcher = self._batcher_for(serving)
            segs = [frames[i:i + batcher.cap]
                    for i in range(0, frames.shape[0], batcher.cap)]
            if len(segs) == 1:
                sr = batcher.submit(segs[0])
            else:
                # Submit every segment concurrently: chunk i+1's host->
                # device transfer overlaps chunk i's program, and segments
                # can coalesce with other requests' calls in flight.
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(min(len(segs), 8)) as ex:
                    outs = list(ex.map(batcher.submit, segs))
                sr = np.concatenate(outs, axis=0)
        with metrics._lock:
            metrics.volumes += 1
        return sr

    def _batcher_for(self, serving) -> _Batcher:
        with self._batchers_lock:
            b = self._batchers.get(id(serving))
            if b is None:
                b = _Batcher(
                    lambda x, s=serving: self._call(s, x),
                    int(serving.meta["frames_shape"][0]),
                    _coalesce_unit(serving.meta),
                    self._batch_wait_s,
                    lambda: self.metrics,
                )
                self._batchers[id(serving)] = b
            return b


def _parse_volume(body: bytes, content_type: str):
    """Request body -> (frames (M, H, W) float32, response_kind, nii_geom).

    ``nii_geom`` is the (h, w, d, t) of a NIfTI request (frames are the
    preprocessed d*t stack) — needed to fold SR frames back into a volume.
    """
    if content_type == "application/x-npy":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim != 3 or 0 in arr.shape:
            raise ValueError(
                f"expected non-empty (N, H, W) frames, got {arr.shape}")
        return np.asarray(arr, np.float32), "npy", None
    # Anything else: treat as NIfTI bytes (.nii or .nii.gz).
    from vsr_tpu_torch.infer import load_hr_frames

    suffix = ".nii.gz" if body[:2] == b"\x1f\x8b" else ".nii"
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(body)
        f.flush()
        frames, geom = load_hr_frames(Path(f.name))
    return np.asarray(frames, np.float32), "nii", geom


def _encode_volume(sr: np.ndarray, kind: str, nii_geom):
    """SR frames come back at the input HR geometry (the pipeline is
    HR -> k-space downscale -> SR back to HR, as ``export --run`` writes
    them), so no factor scaling on the way out."""
    if kind == "npy":
        buf = io.BytesIO()
        np.save(buf, sr)
        return buf.getvalue(), "application/x-npy"
    from vsr_tpu_torch.io.nifti import save_nifti

    if nii_geom is not None:
        h, w, d, t = nii_geom
        vol = np.moveaxis(sr, 0, -1).reshape(h, w, d, t)
    else:
        vol = np.moveaxis(sr, 0, -1)
    with tempfile.NamedTemporaryFile(suffix=".nii.gz") as f:
        save_nifti(vol, f.name)
        f.seek(0)
        return Path(f.name).read_bytes(), "application/gzip"


def make_server(artifact_paths, host: str = "127.0.0.1", port: int = 0,
                warmup: bool = True, live=(),
                stream_spec: dict | None = None,
                batch_wait_ms: float = 0.0,
                device: torch.device | str = "cuda") -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``.serve_forever()`` it or
    run it in a thread (tests). ``port=0`` binds an ephemeral port.
    ``live``: extra :class:`LivePipeline` servings (net + checkpoint)
    pooled alongside the artifacts. ``stream_spec``:
    enables the ``/v1/stream`` session endpoints (:class:`StreamManager`)
    for frame-at-a-time serving of that net. ``batch_wait_ms``: how long a
    partially-filled cross-request batch waits for more work before
    dispatching (0 = dispatch immediately; coalescing still happens for
    requests that queue while the card is busy). ``device``: where the
    artifacts and stream sessions serve (live pipelines carry their own)."""
    pool = ArtifactPool(artifact_paths, warmup=warmup, live=live,
                        allow_empty=stream_spec is not None,
                        batch_wait_ms=batch_wait_ms, device=device)
    streams = StreamManager(stream_spec, device=device)
    metrics = Metrics()
    pool.metrics = metrics  # batcher padding/coalescing counters
    profile_lock = threading.Lock()  # one /debug/profile capture at a time

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logging.info("%s - %s", self.address_string(), fmt % args)

        def _send(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, obj) -> None:
            self._send(status, json.dumps(obj).encode(),
                       "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            t0 = time.perf_counter()
            if path == "/healthz":
                status = 200 if pool.warm else 503
                self._send_json(status, {
                    "status": "ok" if pool.warm else "warming",
                    "artifacts": [
                        {"path": p, "frames_shape": s.meta["frames_shape"],
                         "factor": s.meta["factor"]}
                        for p, s in zip(pool.paths, pool.servings)],
                    "stream": streams.meta,
                })
            elif path == "/v1/meta":
                status = 200
                self._send_json(200, [s.meta for s in pool.servings])
            elif path == "/metrics":
                status = 200
                self._send(200, metrics.render().encode(),
                           "text/plain; version=0.0.4")
            else:
                status = 404
                self._send_json(404, {"error": f"unknown path {path}"})
                path = "<other>"  # one label for all unknown paths: a URL
                # scanner must not grow the counter dict without bound
            metrics.observe(path, status, time.perf_counter() - t0)

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _stream_request(self, path: str) -> None:
            """POST /v1/stream/open | /v1/stream/<id>/push | .../flush |
            .../reset — the online serving sessions (StreamManager)."""
            t0 = time.perf_counter()
            status = 500
            try:
                parts = path.split("/")[3:]  # after /v1/stream
                if parts == ["open"]:
                    try:
                        sid = streams.open()
                    except LookupError as exc:
                        status = 404
                        self._send_json(404, {"error": str(exc)})
                        return
                    except RuntimeError as exc:  # session limit
                        status = 429
                        self._send_json(429, {"error": str(exc)})
                        return
                    status = 200
                    self._send_json(200, {
                        "id": sid,
                        "family": type(streams.get(sid)["stream"]).__name__})
                    return
                if len(parts) != 2 or parts[1] not in ("push", "flush",
                                                       "reset"):
                    status = 404
                    self._send_json(404, {"error": f"unknown path {path}"})
                    return
                sid, verb = parts
                try:
                    if verb == "push":
                        try:
                            frames = np.load(io.BytesIO(self._read_body()),
                                             allow_pickle=False)
                            frames = np.ascontiguousarray(frames, np.float32)
                        except Exception as exc:
                            status = 400
                            self._send_json(400, {"error": f"bad frame: {exc}"})
                            return
                        out = streams.push(sid, frames, pool._device_lock)
                        if out is None:  # window context still filling
                            status = 204
                            self.send_response(204)
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            return
                        t, sr = out
                        buf = io.BytesIO()
                        np.save(buf, sr)
                        status = 200
                        self.send_response(200)
                        self.send_header("Content-Type", "application/x-npy")
                        self.send_header("X-VSR-Frame-Index", str(t))
                        body = buf.getvalue()
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif verb == "flush":
                        idx, srs = streams.flush(sid, pool._device_lock)
                        buf = io.BytesIO()
                        np.save(buf, np.stack(srs) if srs
                                else np.zeros((0,), np.float32))
                        status = 200
                        self.send_response(200)
                        self.send_header("Content-Type", "application/x-npy")
                        self.send_header("X-VSR-Frame-Indices",
                                         ",".join(map(str, idx)))
                        body = buf.getvalue()
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:  # reset
                        sess = streams.get(sid)
                        sess["stream"].reset()
                        sess["pushed"] = 0
                        status = 200
                        self._send_json(200, {"ok": True})
                except KeyError as exc:
                    status = 404
                    self._send_json(404, {"error": str(exc)})
                except ValueError as exc:  # geometry / short-sequence errors
                    status = 400
                    self._send_json(400, {"error": str(exc)})
            except Exception as exc:  # internal error
                logging.exception("stream request failed")
                try:
                    self._send_json(500, {"error": str(exc)})
                except Exception:
                    pass
            finally:
                metrics.observe("/v1/stream", status,
                                time.perf_counter() - t0)

        def do_DELETE(self):
            path = urlparse(self.path).path
            parts = path.split("/")
            if len(parts) == 4 and parts[1:3] == ["v1", "stream"]:
                try:
                    streams.close(parts[3])
                    self._send_json(200, {"ok": True})
                    metrics.observe("/v1/stream", 200, 0.0)
                except KeyError as exc:
                    self._send_json(404, {"error": str(exc)})
                    metrics.observe("/v1/stream", 404, 0.0)
                return
            # Counted before the answer, so a client that reads /metrics
            # right after its 404 sees it.
            metrics.observe("<other>", 404, 0.0)
            self._send_json(404, {"error": f"unknown path {path}"})

        def _profile_request(self, query: str) -> None:
            """POST /debug/profile?seconds=S — record a torch.profiler trace
            (CPU + CUDA activity) WHILE live traffic runs (the device lock is
            NOT held, so concurrent /v1/sr requests are what gets traced)
            and return its chrome trace, zipped. One capture at a time."""
            import shutil

            try:
                seconds = float(parse_qs(query).get("seconds", ["3"])[0])
            except ValueError:
                self._send_json(400, {"error": "seconds must be a number"})
                return
            if not 0.5 <= seconds <= 60:
                self._send_json(
                    400, {"error": "seconds must be in [0.5, 60]"})
                return
            if not profile_lock.acquire(blocking=False):
                self._send_json(
                    409, {"error": "a profile capture is already running"})
                return
            try:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                with tempfile.TemporaryDirectory() as td:
                    trace_dir = Path(td) / "trace"
                    trace_dir.mkdir()
                    with profile(activities=activities) as prof:
                        time.sleep(seconds)
                    prof.export_chrome_trace(str(trace_dir / "trace.json"))
                    zip_base = Path(td) / "profile"
                    shutil.make_archive(str(zip_base), "zip", td, "trace")
                    payload = (zip_base.with_suffix(".zip")).read_bytes()
                self._send(200, payload, "application/zip")
                metrics.observe("/debug/profile", 200, seconds)
            except Exception as exc:
                logging.exception("profile capture failed")
                self._send_json(500, {"error": str(exc)})
                metrics.observe("/debug/profile", 500, 0.0)
            finally:
                profile_lock.release()

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path.startswith("/v1/stream/"):
                self._stream_request(parsed.path)
                return
            if parsed.path == "/debug/profile":
                self._profile_request(parsed.query)
                return
            if parsed.path != "/v1/sr":
                metrics.observe("<other>", 404, 0.0)
                self._send_json(404, {"error": f"unknown path {parsed.path}"})
                return
            t0 = time.perf_counter()
            status = 500
            with metrics._lock:
                metrics.inflight += 1
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                try:
                    frames, kind, geom = _parse_volume(body, ctype)
                except Exception as exc:
                    status = 400
                    self._send_json(400, {"error": f"bad volume: {exc}"})
                    return
                fmt = parse_qs(parsed.query).get("format", [kind])[0]
                if fmt not in ("npy", "nii"):
                    status = 400
                    self._send_json(400, {"error": f"unknown format {fmt!r}"})
                    return
                try:
                    sr = pool.sr_volume(frames, metrics, nii_geom=geom)
                except LookupError as exc:  # no artifact for this geometry
                    status = 400
                    self._send_json(400, {"error": str(exc)})
                    return
                payload, out_ctype = _encode_volume(sr, fmt, geom)
                status = 200
                self._send(200, payload, out_ctype)
            except Exception as exc:  # internal error
                logging.exception("sr request failed")
                try:
                    self._send_json(500, {"error": str(exc)})
                except Exception:
                    pass
            finally:
                with metrics._lock:
                    metrics.inflight -= 1
                metrics.observe("/v1/sr", status, time.perf_counter() - t0)

    server = ThreadingHTTPServer((host, port), Handler)
    server.pool = pool  # type: ignore[attr-defined]
    server.metrics = metrics  # type: ignore[attr-defined]
    return server


def live_from_args(args) -> list:
    """``--net ...`` CLI flags -> a list of :class:`LivePipeline`, one per
    ``--frames-shape`` geometry (requests route by shape like artifacts)."""
    if not args.net:
        return []
    if not args.frames_shape:
        raise SystemExit("--net (live serving) needs --frames-shape N,H,W")
    from vsr_tpu_torch.infer import resolve_volume

    net_kwargs = json.loads(args.net_kwargs) if args.net_kwargs else {}
    if args.bf16:
        net_kwargs["dtype"] = "bfloat16"
    window = None
    if args.windows:
        if not args.seq_t:
            raise SystemExit("--windows needs --seq-t")
        window = (args.windows, args.seq_t, args.window_order)
    w8a8: dict | bool = False
    if args.w8a8_scales:
        with open(args.w8a8_scales) as f:
            w8a8 = {k: float(v) for k, v in json.load(f).items()}
    w8a8_kernels = ({int(s) for s in args.w8a8_kernels.split(",")}
                    if args.w8a8_kernels else None)
    live = []
    for spec in args.frames_shape:
        shape = tuple(int(s) for s in spec.split(","))
        if len(shape) != 3:
            raise SystemExit(f"--frames-shape must be N,H,W, got {spec!r}")
        volume = resolve_volume(args.net, video=bool(args.video_t),
                                windows=args.windows, seq_t=args.seq_t,
                                chunk=args.chunk, n_frames=shape[0],
                                exc=SystemExit)
        live.append(LivePipeline(
            net_name=args.net, net_kwargs=net_kwargs,
            checkpoint=args.checkpoint, frames_shape=shape,
            factor=args.factor, dataset=args.dataset,
            video_t=args.video_t or None, window=window, volume=volume,
            chunk=args.chunk, int8=args.int8, w8a8=w8a8,
            w8a8_kernels=w8a8_kernels, device=args.device))
    return live


# JAX daemon flags this port does not serve: dest -> flag.
_NOT_PORTED = {"mesh": "--mesh"}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="HTTP serving daemon for artifacts and live "
                    "(net + checkpoint) pipelines (PyTorch port)")
    p.add_argument("--artifact", action="append", default=[],
                   help="path to an artifact of vsr_tpu_torch.export "
                        "(repeatable — one per serving geometry; requests "
                        "route by shape)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8973)
    p.add_argument("--device", default="cuda",
                   help="device to serve on (cuda, cpu); artifacts must "
                        "have been traced for its type")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip one warm-up call of every program at startup")
    p.add_argument("--net", default="",
                   help="serve a live pipeline for this registered net "
                        "instead of / alongside artifacts")
    p.add_argument("--net-kwargs", default="", help="JSON net kwargs")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint to load into the live net (the port's "
                        "or vsr_tpu's flax msgpack file)")
    p.add_argument("--frames-shape", action="append", default=[],
                   help="serving geometry N,H,W (repeatable — one live "
                        "program per geometry)")
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--dataset", choices=["acdc", "dsb15"], default="acdc")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--video-t", dest="video_t", type=int, default=0,
                   help="whole-sequence (VSR) live serving: frames are "
                        "D*video_t slice-sequences")
    p.add_argument("--windows", type=int, default=0,
                   help="MISR live serving: circular N-frame windows")
    p.add_argument("--seq-t", dest="seq_t", type=int, default=0,
                   help="frames per slice sequence (with --windows and the "
                        "volumetric nets)")
    p.add_argument("--window-order", dest="window_order",
                   choices=["middle", "last"], default="middle")
    p.add_argument("--chunk", type=int, default=0,
                   help="feed the live net this many frames/windows at a "
                        "time")
    p.add_argument("--stream-net", dest="stream_net", default="",
                   help="enable frame-at-a-time streaming sessions for "
                        "this registered net (recurrent nets stream via "
                        "their carry; --stream-windows serves circular MISR "
                        "windows; other nets per frame)")
    p.add_argument("--stream-net-kwargs", dest="stream_net_kwargs",
                   default="", help="JSON net kwargs for --stream-net")
    p.add_argument("--stream-checkpoint", dest="stream_checkpoint",
                   default="")
    p.add_argument("--stream-factor", dest="stream_factor", type=int,
                   default=2)
    p.add_argument("--stream-dataset", dest="stream_dataset",
                   choices=["acdc", "dsb15"], default="acdc")
    p.add_argument("--stream-windows", dest="stream_windows", type=int,
                   default=0)
    p.add_argument("--stream-order", dest="stream_order",
                   choices=["middle", "last"], default="middle")
    p.add_argument("--stream-bf16", dest="stream_bf16", action="store_true")
    p.add_argument("--batch-wait-ms", dest="batch_wait_ms", type=float,
                   default=0.0,
                   help="wait up to this long for concurrent requests to "
                        "fill a shared program call before dispatching "
                        "(0 = immediate; queued requests still coalesce "
                        "while the card is busy)")
    p.add_argument("--mesh", default="", help="not yet ported")
    p.add_argument("--int8", action="store_true",
                   help="live pipelines serve the kernels held in int8")
    p.add_argument("--w8a8-scales", dest="w8a8_scales", default="",
                   help="live pipelines serve W8A8 convs with these "
                        "precomputed {module_path: scale} activation scales "
                        "(JSON)")
    p.add_argument("--w8a8-kernels", dest="w8a8_kernels", default="",
                   help="with --w8a8-scales: quantize only convs of these "
                        "spatial kernel sizes (e.g. '6')")
    p.add_argument("--preset", choices=["tuned", "fast"], default="",
                   help="apply the live --net's serving knobs measured on "
                        "the card (vsr_tpu_torch/presets.py); explicit "
                        "flags win. W8A8 here needs --w8a8-scales")
    p.add_argument("--preset-file", dest="preset_file", default="",
                   help="JSON of {net: preset_entry} measured on this "
                        "machine (python -m vsr_tpu_torch.tune); implies "
                        "--preset tuned")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s",
                        level=logging.INFO, datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    for dest, flag in _NOT_PORTED.items():
        if getattr(args, dest):
            raise SystemExit(f"{flag} is not yet ported to vsr_tpu_torch "
                             "(serve it with python -m vsr_tpu.serve)")
    if args.batch_wait_ms < 0:
        raise SystemExit("--batch-wait-ms must be >= 0")
    if args.preset_file and not args.net:
        raise SystemExit(
            "--preset-file applies to live --net serving; stream sessions "
            "take their own --stream-* flags and artifacts bake their "
            "knobs at export time")
    if args.net:
        from vsr_tpu_torch.presets import apply_cli_preset

        apply_cli_preset(args)
    live = live_from_args(args)
    stream_spec = None
    if args.stream_net:
        from vsr_tpu_torch.infer import VOLUME_NETS

        if args.stream_net in VOLUME_NETS and args.stream_windows:
            raise SystemExit(
                "the volumetric nets stream one (D, H, W) volume per "
                "push — --stream-windows does not apply")
        kw = (json.loads(args.stream_net_kwargs)
              if args.stream_net_kwargs else {})
        if args.stream_bf16:
            kw["dtype"] = "bfloat16"
        stream_spec = {
            "net": args.stream_net, "net_kwargs": kw,
            "checkpoint": args.stream_checkpoint,
            "factor": args.stream_factor, "dataset": args.stream_dataset,
            "windows": args.stream_windows, "order": args.stream_order,
        }
    server = make_server(args.artifact, args.host, args.port,
                         warmup=not args.no_warmup, live=live,
                         stream_spec=stream_spec,
                         batch_wait_ms=args.batch_wait_ms,
                         device=args.device)
    logging.info(f"serving {len(args.artifact)} artifact(s) + "
                 f"{len(live)} live pipeline(s)"
                 + (f" + streaming sessions ({args.stream_net})"
                    if stream_spec else "") + " on "
                 f"http://{args.host}:{server.server_address[1]}")
    import signal

    def _term(_sig, _frm):  # container/orchestrator stop -> clean exit
        logging.info("SIGTERM: shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
