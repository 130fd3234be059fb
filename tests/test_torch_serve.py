"""The port's HTTP serving daemon (``vsr_tpu_torch/serve.py``) on the CPU:
the cases of ``tests/test_serve.py`` (the JAX daemon's) other than the mesh
and W8A8 ones, against the port's server and artifacts (tiny EDSR programs
of ``vsr_tpu_torch.export``, traced on the CPU). Health / meta / metrics,
npy and NIfTI round trips equal to the direct ``ExportedServing`` call
(bit-equal), frame-count bridging, shape routing, volume programs exact
size only, dynamic batching (coalescing, errors, padding), the stream
session endpoints against a direct stream, ``/debug/profile`` with
``torch.profiler``, the CLI's refusals, and ``Metrics.render()`` equal to
the JAX daemon's text for the same observations."""

from __future__ import annotations

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests._torch_cases import run_cases, subdir
from vsr_tpu_torch.export import ExportedServing, export_serving, save_artifact
from vsr_tpu_torch.infer import build_serving_net
from vsr_tpu_torch.serve import make_server

N, H, W = 6, 24, 24  # HR frames the artifact is specialized to (24 = /12)
FACTOR = 2
EDSR_KW = {"in_channels": 1, "out_channels": 1, "num_resblocks": 1,
           "num_features": 4, "upscale_factor": FACTOR}


def _make_artifact(tmp_path, frames=N, name="tiny.pt2.zip"):
    net = build_serving_net("EDSRNet", EDSR_KW, device="cpu")
    program, meta = export_serving(net, (frames, H, W), FACTOR)
    path = tmp_path / name
    save_artifact(path, program, {**meta, "net": "EDSRNet"})
    return path


def _direct(path):
    serving = ExportedServing(path, device="cpu")
    return lambda frames: (None, serving(frames)[1].numpy())


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    paths = [_make_artifact(tmp),
             _make_artifact(tmp, frames=2, name="b.pt2.zip")]
    srv = make_server(paths, port=0, warmup=True, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _post_npy(server, arr, query=""):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(
        _url(server, "/v1/sr" + query), data=buf.getvalue(),
        headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req) as resp:
        return resp.status, resp.read(), resp.headers.get("Content-Type")


def _case_healthz_and_meta(server):
    with urllib.request.urlopen(_url(server, "/healthz")) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok"
    assert {tuple(a["frames_shape"]) for a in health["artifacts"]} == {
        (N, H, W), (2, H, W)}
    with urllib.request.urlopen(_url(server, "/v1/meta")) as resp:
        metas = json.loads(resp.read())
    assert len(metas) == 2 and metas[0]["factor"] == FACTOR


def _case_sr_npy_matches_direct_call(server):
    rng = np.random.default_rng(0)
    frames = np.round(rng.random((N, H, W)) * 255).astype(np.float32)
    status, body, ctype = _post_npy(server, frames)
    assert status == 200 and ctype == "application/x-npy"
    sr = np.load(io.BytesIO(body))
    assert sr.shape == (N, H, W)  # SR comes back at the input HR geometry

    direct = _direct(server.pool.paths[0])
    _, want = direct(frames)
    np.testing.assert_array_equal(sr, want)


def _case_sr_bridges_frame_count_with_padding(server):
    """A 10-frame volume routes to the 6-frame artifact (largest <= M) and
    is served in 2 edge-padded chunks; result equals direct chunked calls."""
    rng = np.random.default_rng(1)
    frames = np.round(rng.random((10, H, W)) * 255).astype(np.float32)
    before = server.metrics.padded_frames
    status, body, _ = _post_npy(server, frames)
    assert status == 200
    sr = np.load(io.BytesIO(body))
    assert sr.shape == (10, H, W)
    assert server.metrics.padded_frames == before + 2

    direct = _direct(server.pool.paths[0])
    _, a = direct(frames[:6])
    _, b = direct(np.pad(frames[6:], ((0, 2), (0, 0), (0, 0)), mode="edge"))
    np.testing.assert_array_equal(sr, np.concatenate([a, b[:4]], axis=0))


def _case_sr_routes_exact_frame_match(server):
    """A 2-frame volume uses the 2-frame artifact — no padding."""
    before = server.metrics.padded_frames
    frames = np.zeros((2, H, W), np.float32)
    status, body, _ = _post_npy(server, frames)
    assert status == 200
    assert np.load(io.BytesIO(body)).shape == (2, H, W)
    assert server.metrics.padded_frames == before


def _case_sr_nifti_roundtrip(server, tmp_path):
    from vsr_tpu_torch.infer import load_hr_frames
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti

    rng = np.random.default_rng(2)
    vol = np.round(rng.random((H, W, 2, 3)) * 255).astype(np.float32)
    path = tmp_path / "vol.nii.gz"
    save_nifti(vol, path)
    req = urllib.request.Request(
        _url(server, "/v1/sr"), data=path.read_bytes(),
        headers={"Content-Type": "application/gzip"})
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 200
        body = resp.read()
    out_path = tmp_path / "sr.nii.gz"
    out_path.write_bytes(body)
    sr = load_nifti(out_path)
    assert sr.shape == (H, W, 2, 3)
    frames, _ = load_hr_frames(path)
    _, want = _direct(server.pool.paths[0])(frames.astype(np.float32))
    np.testing.assert_array_equal(np.moveaxis(sr.reshape(H, W, 6), -1, 0),
                                  want)


def _case_sr_rejects_unknown_geometry(server):
    frames = np.zeros((4, 36, 36), np.float32)
    buf = io.BytesIO()
    np.save(buf, frames)
    req = urllib.request.Request(
        _url(server, "/v1/sr"), data=buf.getvalue(),
        headers={"Content-Type": "application/x-npy"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 400
    assert "no artifact" in json.loads(err.value.read())["error"]


def _case_sr_rejects_bad_body(server):
    req = urllib.request.Request(
        _url(server, "/v1/sr"), data=b"not a volume",
        headers={"Content-Type": "application/x-npy"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 400


def _case_sr_rejects_empty_volume(server):
    # A (0, H, W) npy is a malformed input (400), not an internal error:
    # without the _parse_volume guard it reaches np.concatenate([]) -> 500.
    with pytest.raises(urllib.error.HTTPError) as err:
        _post_npy(server, np.zeros((0, 16, 16), np.float32))
    assert err.value.code == 400


def _case_batcher_refuses_contract_violations():
    from vsr_tpu_torch.serve import _Batcher

    calls = []
    b = _Batcher(lambda x: (calls.append(x.shape), x * 2)[1],
                 cap=4, unit=2, wait_s=0.0, metrics_ref=lambda: None)
    # Over-cap and off-granule segments must raise, not hang the leader
    # loop on an empty dispatch prefix.
    with pytest.raises(ValueError):
        b.submit(np.zeros((6, 4, 4), np.float32))
    with pytest.raises(ValueError):
        b.submit(np.zeros((3, 4, 4), np.float32))
    with pytest.raises(ValueError):
        b.submit(np.zeros((0, 4, 4), np.float32))
    out = b.submit(np.ones((2, 4, 4), np.float32))
    assert out.shape == (2, 4, 4) and float(out[0, 0, 0]) == 2.0


def _case_metrics_exposition(server):
    with urllib.request.urlopen(_url(server, "/metrics")) as resp:
        text = resp.read().decode()
    assert 'vsr_requests_total{endpoint="/v1/sr",status="200"}' in text
    assert "vsr_volumes_served_total" in text
    assert "vsr_sr_latency_seconds_count" in text
    assert text.rstrip().splitlines()[-1].startswith("vsr_inflight_requests")


def _case_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(_url(server, "/nope"))
    assert err.value.code == 404
    # Unknown paths share one counter label — a URL scanner must not grow
    # the metrics dict (or inject raw paths into the exposition).
    with urllib.request.urlopen(_url(server, "/metrics")) as resp:
        text = resp.read().decode()
    assert 'endpoint="<other>",status="404"' in text
    assert "/nope" not in text


def _case_metrics_histogram_and_label_escaping():
    """Bucket counts are cumulative exactly once (observe stores per-bucket,
    render cumulates) and label values are Prometheus-escaped."""
    from vsr_tpu_torch.serve import Metrics

    m = Metrics()
    m.observe("/v1/sr", 200, 0.01)
    m.observe("/v1/sr", 200, 0.5)
    text = m.render()
    assert 'vsr_sr_latency_seconds_bucket{le="0.05"} 1' in text
    assert 'vsr_sr_latency_seconds_bucket{le="0.25"} 1' in text
    assert 'vsr_sr_latency_seconds_bucket{le="1.0"} 2' in text
    assert 'vsr_sr_latency_seconds_bucket{le="+Inf"} 2' in text
    assert "vsr_sr_latency_seconds_count 2" in text

    m.observe('bad"path\nnew', 404, 0.0)
    escaped = m.render()
    assert 'endpoint="bad\\"path\\nnew"' in escaped
    assert 'bad"path\n' not in escaped


def _case_live_pipeline_rejects_lazy_w8a8():
    from vsr_tpu_torch.serve import LivePipeline

    with pytest.raises(ValueError, match="lazy"):
        LivePipeline(net_name="EDSRNet", net_kwargs={}, checkpoint="",
                     frames_shape=(2, H, W), factor=FACTOR, w8a8=True,
                     device="cpu")


def _case_no_warmup_becomes_warm_lazily(tmp_path):
    """Under --no-warmup, /healthz starts 503 ('warming') and flips to 200
    once every artifact has compiled through real requests."""
    paths = [_make_artifact(tmp_path, frames=2, name="lazy_a.pt2.zip"),
             _make_artifact(tmp_path, frames=3, name="lazy_b.pt2.zip")]
    srv = make_server(paths, port=0, warmup=False, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(_url(srv, "/healthz"))
        assert err.value.code == 503
        assert json.loads(err.value.read())["status"] == "warming"

        status, _, _ = _post_npy(srv, np.zeros((2, H, W), np.float32))
        assert status == 200
        with pytest.raises(urllib.error.HTTPError) as err:  # one of two warm
            urllib.request.urlopen(_url(srv, "/healthz"))
        assert err.value.code == 503

        status, _, _ = _post_npy(srv, np.zeros((3, H, W), np.float32))
        assert status == 200
        with urllib.request.urlopen(_url(srv, "/healthz")) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        srv.shutdown()


# ---------------------------------------------------------------- streaming


@pytest.fixture(scope="module")
def stream_server():
    """A daemon with ONLY streaming sessions configured (recurrent DRF)."""
    srv = make_server([], port=0, warmup=True, device="cpu", stream_spec={
        "net": "DRFNet",
        "net_kwargs": {"in_channels": 1, "out_channels": 1,
                       "num_features": 4, "num_groups": 1,
                       "upscale_factor": 2},
        "checkpoint": "", "factor": 2, "dataset": "acdc", "windows": 0,
    })
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()


def _stream_post(server, path, arr=None):
    data = b""
    if arr is not None:
        buf = io.BytesIO()
        np.save(buf, arr)
        data = buf.getvalue()
    req = urllib.request.Request(
        _url(server, path), data=data,
        headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def _case_stream_sessions_match_direct_stream(stream_server):
    """open -> push x3 -> close: SR frames equal the Python-API stream
    with the same (deterministic template-init) params."""
    from vsr_tpu_torch.stream import make_stream

    status, body, _ = _stream_post(stream_server, "/v1/stream/open")
    sid = json.loads(body)["id"]
    assert json.loads(body)["family"] == "RecurrentStream"

    net = build_serving_net(
        "DRFNet", {"in_channels": 1, "out_channels": 1, "num_features": 4,
                   "num_groups": 1, "upscale_factor": 2}, "", device="cpu")
    direct = make_stream(net, factor=2)

    rng = np.random.default_rng(3)
    for t in range(3):
        stack = np.round(rng.random((2, 24, 24)) * 255).astype(np.float32)
        status, body, headers = _stream_post(
            stream_server, f"/v1/stream/{sid}/push", stack)
        assert status == 200
        assert headers["X-VSR-Frame-Index"] == str(t)
        got = np.load(io.BytesIO(body))
        _lr, want = direct.push(stack)
        np.testing.assert_array_equal(got, want.numpy())

    # flush on a recurrent stream: no deferred frames, resets indexing
    status, body, headers = _stream_post(
        stream_server, f"/v1/stream/{sid}/flush")
    assert status == 200 and headers["X-VSR-Frame-Indices"] == ""
    stack = np.round(rng.random((2, 24, 24)) * 255).astype(np.float32)
    status, _, headers = _stream_post(
        stream_server, f"/v1/stream/{sid}/push", stack)
    assert headers["X-VSR-Frame-Index"] == "0"

    req = urllib.request.Request(_url(stream_server, f"/v1/stream/{sid}"),
                                 method="DELETE")
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 200


def _case_stream_sessions_are_isolated(stream_server):
    """Two interleaved sessions carry independent state (fork semantics):
    interleaved pushes equal a serial single-session run."""
    rng = np.random.default_rng(4)
    seq = [np.round(rng.random((2, 24, 24)) * 255).astype(np.float32)
           for _ in range(2)]

    _, body, _ = _stream_post(stream_server, "/v1/stream/open")
    a = json.loads(body)["id"]
    _, body, _ = _stream_post(stream_server, "/v1/stream/open")
    b = json.loads(body)["id"]
    outs_a, outs_b = [], []
    for s in seq:  # interleave identical sequences
        _, body, _ = _stream_post(stream_server, f"/v1/stream/{a}/push", s)
        outs_a.append(np.load(io.BytesIO(body)))
        _, body, _ = _stream_post(stream_server, f"/v1/stream/{b}/push", s)
        outs_b.append(np.load(io.BytesIO(body)))
    np.testing.assert_array_equal(np.stack(outs_a), np.stack(outs_b))
    for sid in (a, b):
        req = urllib.request.Request(
            _url(stream_server, f"/v1/stream/{sid}"), method="DELETE")
        urllib.request.urlopen(req)


def _case_stream_error_paths(stream_server, server):
    # unknown session
    with pytest.raises(urllib.error.HTTPError) as exc:
        _stream_post(stream_server, "/v1/stream/nope/push",
                     np.zeros((2, 24, 24), np.float32))
    assert exc.value.code == 404
    # geometry change mid-sequence -> 400
    _, body, _ = _stream_post(stream_server, "/v1/stream/open")
    sid = json.loads(body)["id"]
    _stream_post(stream_server, f"/v1/stream/{sid}/push",
                 np.zeros((2, 24, 24), np.float32))
    with pytest.raises(urllib.error.HTTPError) as exc:
        _stream_post(stream_server, f"/v1/stream/{sid}/push",
                     np.zeros((2, 24, 36), np.float32))
    assert exc.value.code == 400
    # reset clears the geometry pin
    status, body, _ = _stream_post(stream_server, f"/v1/stream/{sid}/reset")
    assert status == 200
    status, _, _ = _stream_post(stream_server, f"/v1/stream/{sid}/push",
                                np.zeros((2, 24, 36), np.float32))
    assert status == 200
    # a server without a stream spec: open -> 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _stream_post(server, "/v1/stream/open")
    assert exc.value.code == 404
    # healthz reports the stream spec + session count
    with urllib.request.urlopen(_url(stream_server, "/healthz")) as resp:
        health = json.loads(resp.read())
    assert health["stream"]["net"] == "DRFNet"
    assert health["stream"]["sessions"] >= 1


def _case_route_volume_programs_exact_only():
    """Volume-mode programs serve their exact D*T frame count: routing
    never bridges a mismatched request through them."""
    import pytest

    from vsr_tpu_torch.serve import ArtifactPool

    class _Fake:
        def __init__(self, meta):
            self.meta = meta

    vol = _Fake({"frames_shape": [6, 24, 24], "volume": ["3d", 3],
                 "net": "Volume3DSRNet"})
    plain = _Fake({"frames_shape": [4, 24, 24], "volume": None,
                   "net": "EDSRNet"})
    pool = ArtifactPool([], warmup=False, live=[vol, plain],
                        allow_empty=False, device="cpu")
    assert pool.route((6, 24, 24)) is vol          # exact match wins
    assert pool.route((9, 24, 24)) is plain        # bridge via plain only
    pool_vol_only = ArtifactPool([], warmup=False, live=[vol],
                                 allow_empty=False, device="cpu")
    with pytest.raises(LookupError, match="exact"):
        pool_vol_only.route((9, 24, 24))
    # video/window programs regroup N = D*T into INDEPENDENT per-slice
    # sequences: any whole number of matching-T sequences bridges (batched
    # granule-aligned calls); partial or mismatched-T sequences do not.
    vid = _Fake({"frames_shape": [6, 24, 24], "video_t": 3, "volume": None,
                 "net": "DRFNet"})
    pool_vid = ArtifactPool([], warmup=False, live=[vid], allow_empty=False,
                            device="cpu")
    assert pool_vid.route((6, 24, 24)) is vid
    assert pool_vid.route((9, 24, 24)) is vid       # 3 sequences of T=3
    with pytest.raises(LookupError, match="sequences"):
        pool_vid.route((8, 24, 24))                 # partial sequence
    with pytest.raises(LookupError, match="sequences"):
        pool_vid.route((9, 24, 24), req_t=4)        # mismatched T


def _case_sr_volume_refuses_mismatched_dt_geometry():
    """Exact-N route to a regrouping program still refuses a NIfTI whose
    (d, t) factorization differs from the program's per-slice T."""
    import pytest

    from vsr_tpu_torch.serve import ArtifactPool, Metrics

    class _Fake:
        def __init__(self, meta):
            self.meta = meta

    vol = _Fake({"frames_shape": [12, 24, 24], "volume": ["3d", 4],
                 "net": "Volume3DSRNet"})
    pool = ArtifactPool([], warmup=False, live=[vol], allow_empty=False,
                        device="cpu")
    frames = np.zeros((12, 24, 24), np.float32)
    # Only the wrong-T volume program exists: clean routing error.
    with pytest.raises(LookupError, match="exact"):
        pool.sr_volume(frames, Metrics(), nii_geom=(24, 24, 4, 3))
    # Same t: the exact volume program routes (geometry check passes).
    assert pool.route((12, 24, 24), req_t=4) is vol
    # With a bridgeable per-frame program alongside, the mismatched-T
    # request routes THERE instead of 400ing on the volume program.
    plain = _Fake({"frames_shape": [6, 24, 24], "volume": None,
                   "net": "EDSRNet"})
    pool2 = ArtifactPool([], warmup=False, live=[vol, plain],
                         allow_empty=False, device="cpu")
    assert pool2.route((12, 24, 24), req_t=3) is plain


def _case_volume_artifact_over_http(tmp_path):
    """A volume-mode artifact serves over /v1/sr: exact-N npy requests
    work; a mismatched frame count gets a clean 400 (no bridging through
    the regrouping program)."""
    net = build_serving_net("Volume3DSRNet", EDSR_KW, device="cpu")
    program, meta = export_serving(net, (N, H, W), FACTOR, volume=("3d", 3))
    path = tmp_path / "vol.pt2.zip"
    save_artifact(path, program, meta)
    srv = make_server([path], port=0, warmup=True, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        frames = np.round(
            np.random.default_rng(0).random((N, H, W)) * 255
        ).astype(np.float32)
        status, body, ctype = _post_npy(srv, frames)
        assert status == 200 and ctype == "application/x-npy"
        sr = np.load(io.BytesIO(body))
        assert sr.shape == (N, H, W)
        ref = ExportedServing(path, device="cpu")(frames)[1].numpy()
        np.testing.assert_array_equal(sr, ref)
        # Mismatched N: volume programs never bridge.
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_npy(srv, frames[:4])
        assert e.value.code == 400
        assert "exact" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()


def _case_debug_profile_endpoint(server):
    """POST /debug/profile returns a torch.profiler chrome trace, zipped;
    bad requests get clean errors."""
    req = urllib.request.Request(
        _url(server, "/debug/profile?seconds=0.6"), data=b"")
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 200
        assert resp.headers.get("Content-Type") == "application/zip"
        body = resp.read()
    import zipfile as _zf

    with _zf.ZipFile(io.BytesIO(body)) as zf:
        assert "trace/trace.json" in zf.namelist()
        assert "traceEvents" in json.loads(zf.read("trace/trace.json"))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            _url(server, "/debug/profile?seconds=999"), data=b""))
    assert e.value.code == 400


# ---------------------------------------------------------------------------
# Dynamic cross-request batching (_Batcher / ArtifactPool coalescing)
# ---------------------------------------------------------------------------

def _run_threads(fns):
    results = [None] * len(fns)
    errs = []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except Exception as exc:  # pragma: no cover - surfaced by assert
            errs.append(exc)

    ts = [threading.Thread(target=wrap, args=(i, fn))
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not errs, errs
    return results


def _case_batcher_coalesces_and_is_exact():
    """Concurrent sub-capacity segments share one call; each gets exactly
    its own rows; padding repeats the final granule and is dropped."""
    from vsr_tpu_torch.serve import _Batcher

    calls = []

    def call_fn(x):
        calls.append(np.array(x))
        return x * 2.0  # any deterministic per-frame map

    b = _Batcher(call_fn, cap=6, unit=1, wait_s=5.0, metrics_ref=lambda: None)
    a = np.full((2, 4, 4), 1.0, np.float32)
    c = np.full((4, 4, 4), 3.0, np.float32)
    out_a, out_c = _run_threads([lambda: b.submit(a), lambda: b.submit(c)])
    assert len(calls) == 1 and calls[0].shape == (6, 4, 4)
    np.testing.assert_array_equal(out_a, a * 2)
    np.testing.assert_array_equal(out_c, c * 2)

    # partial batch alone: padded by repeating the last granule, sliced back
    calls.clear()
    b0 = _Batcher(call_fn, cap=6, unit=3, wait_s=0.0,
                  metrics_ref=lambda: None)
    seq = np.arange(3 * 16, dtype=np.float32).reshape(3, 4, 4)
    out = b0.submit(seq)
    assert calls[0].shape == (6, 4, 4)
    np.testing.assert_array_equal(calls[0][3:], seq)  # tiled last unit
    np.testing.assert_array_equal(out, seq * 2)


def _case_batcher_error_propagates_and_recovers():
    from vsr_tpu_torch.serve import _Batcher

    state = {"fail": True}

    def call_fn(x):
        if state["fail"]:
            raise RuntimeError("chip fell over")
        return x + 1.0

    b = _Batcher(call_fn, cap=4, unit=1, wait_s=2.0, metrics_ref=lambda: None)
    x = np.zeros((2, 4, 4), np.float32)

    def one():
        return b.submit(x)

    errs = []

    def wrap():
        try:
            one()
        except RuntimeError as exc:
            errs.append(exc)

    ts = [threading.Thread(target=wrap) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert len(errs) == 2  # both coalesced requesters see the failure
    state["fail"] = False
    np.testing.assert_array_equal(one(), x + 1.0)  # batcher not poisoned


def _case_pool_coalesces_concurrent_http_requests(tmp_path):
    """Two concurrent 3-frame requests to a 6-frame artifact share one
    device call (with --batch-wait) and each result equals the request
    served alone."""
    paths = [_make_artifact(tmp_path, frames=6, name="c6.pt2.zip")]
    srv = make_server(paths, port=0, warmup=True, batch_wait_ms=2000,
                      device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(7)
        f1 = np.round(rng.random((3, H, W)) * 255).astype(np.float32)
        f2 = np.round(rng.random((3, H, W)) * 255).astype(np.float32)
        before_calls = srv.metrics.batch_calls

        r1, r2 = _run_threads([lambda: _post_npy(srv, f1),
                               lambda: _post_npy(srv, f2)])
        assert r1[0] == 200 and r2[0] == 200
        sr1 = np.load(io.BytesIO(r1[1]))
        sr2 = np.load(io.BytesIO(r2[1]))
        assert srv.metrics.batch_calls == before_calls + 1
        assert srv.metrics.coalesced_requests >= 2

        direct = _direct(paths[0])
        _, w1 = direct(np.pad(f1, ((0, 3), (0, 0), (0, 0)), mode="edge"))
        _, w2 = direct(np.pad(f2, ((0, 3), (0, 0), (0, 0)), mode="edge"))
        # each request's rows are bitwise those of ANY batch containing
        # them at the same offsets; compare against the solo-call rows
        joint = np.concatenate([f1, f2], axis=0)
        _, wj = direct(joint)
        np.testing.assert_array_equal(sr1, wj[:3])
        np.testing.assert_array_equal(sr2, wj[3:])
        # and equals the padded solo call on the same rows (per-frame
        # program: batch composition cannot change a frame's result)
        np.testing.assert_array_equal(sr1, w1[:3])
        np.testing.assert_array_equal(sr2, w2[:3])
    finally:
        srv.shutdown()


def _case_pool_batching_single_request_unchanged(tmp_path):
    """batch_wait_ms=0: a lone request flows straight through (no stall),
    bit-identical to the direct padded call, with padding counted."""
    paths = [_make_artifact(tmp_path, frames=4, name="c4.pt2.zip")]
    srv = make_server(paths, port=0, warmup=True, batch_wait_ms=0,
                      device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(8)
        frames = np.round(rng.random((6, H, W)) * 255).astype(np.float32)
        before = srv.metrics.padded_frames
        status, body, _ = _post_npy(srv, frames)
        assert status == 200
        sr = np.load(io.BytesIO(body))
        assert sr.shape == (6, H, W)
        assert srv.metrics.padded_frames == before + 2
        direct = _direct(paths[0])
        _, a = direct(frames[:4])
        _, b = direct(np.pad(frames[4:], ((0, 2), (0, 0), (0, 0)),
                             mode="edge"))
        np.testing.assert_array_equal(sr, np.concatenate([a, b[:2]], axis=0))
    finally:
        srv.shutdown()


def _case_metrics_render_equals_the_jax_daemons_text():
    from vsr_tpu.serve import Metrics as JaxMetrics
    from vsr_tpu_torch.serve import Metrics

    ours, theirs = Metrics(), JaxMetrics()
    observations = [("/v1/sr", 200, 0.01), ("/v1/sr", 200, 0.3),
                    ("/v1/sr", 200, 7.5), ("/v1/sr", 400, 0.0),
                    ("/healthz", 503, 0.0), ("/v1/stream", 200, 0.02),
                    ('odd"path\\x\n', 404, 0.0), ("/v1/sr", 200, 100.0)]
    for m in (ours, theirs):
        for obs in observations:
            m.observe(*obs)
        m.volumes, m.padded_frames, m.inflight = 4, 3, 1
        m.batch_calls, m.coalesced_requests = 5, 2
    assert ours.render() == theirs.render()


def _case_live_pipeline_and_checkpoint_over_http(tmp_path):
    """A live pipeline built from a checkpoint of the port's format serves
    what the same net served directly serves."""
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.serve import LivePipeline
    from vsr_tpu_torch.utils.checkpoint import save_checkpoint

    net = build_serving_net("EDSRNet", EDSR_KW, device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.01)
    ckpt = tmp_path / "model_best.ckpt"
    save_checkpoint(ckpt, {"net": net.state_dict(), "optimizer": None})
    live = LivePipeline(net_name="EDSRNet", net_kwargs=EDSR_KW,
                        checkpoint=str(ckpt), frames_shape=(N, H, W),
                        factor=FACTOR, device="cpu")
    assert live.meta["live"] and live.meta["device"] == "cpu"
    srv = make_server([], port=0, warmup=True, live=[live], device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        frames = np.round(np.random.default_rng(9).random((N, H, W)) * 255
                          ).astype(np.float32)
        status, body, _ = _post_npy(srv, frames)
        assert status == 200
        want = make_pipeline(net, FACTOR, "acdc")(torch.from_numpy(frames))[1]
        np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                      want.numpy())
    finally:
        srv.shutdown()


def _case_cli_refuses_unported_flags():
    """``--mesh`` stays refused; ``--preset`` fills a live ``--net``'s
    knobs (``--preset-file`` alone implies ``tuned`` and applies to live
    serving only)."""
    from vsr_tpu_torch import serve
    from vsr_tpu_torch.presets import SERVING_PRESETS, apply_cli_preset

    with pytest.raises(SystemExit, match="--mesh"):
        serve.main(["--device", "cpu", "--mesh", "data=4"])
    with pytest.raises(SystemExit, match="--preset-file applies to live"):
        serve.main(["--device", "cpu", "--preset-file", "p.json"])
    args = serve.parse_args(["--device", "cpu", "--net", "EDSRNet",
                             "--net-kwargs", json.dumps(EDSR_KW),
                             "--frames-shape", f"{N},{H},{W}",
                             "--preset", "tuned"])
    notes = apply_cli_preset(args)
    entry = SERVING_PRESETS["EDSRNet"]
    assert args.chunk == entry.get("chunk", 0)
    assert json.loads(args.net_kwargs) == {**EDSR_KW,
                                           **entry.get("net_kwargs", {})}
    assert all(n.startswith(("net_kwargs", "chunk")) for n in notes)
    (live,) = serve.live_from_args(args)
    assert live.meta["chunk"] == args.chunk


# The cases above run inside four tests, every case run and each failure
# named (tests/_torch_cases.py): pytest-xdist's ``--dist load`` hands a
# worker its first tests as one run of consecutive ones sized by the
# suite's count, so the count decides which heavy modules share a worker
# (ROADMAP.md, queue 3). Each case keeps its name and its own tmp_path
# subdirectory.


def test_artifact_endpoints(server, tmp_path):
    """Health / meta, npy and NIfTI round trips, bridging, routing, the
    error paths, /metrics, unknown paths and /debug/profile of a daemon
    over two artifacts."""
    cases = [(c.__name__, lambda c=c: c(server)) for c in (
        _case_healthz_and_meta, _case_sr_npy_matches_direct_call,
        _case_sr_bridges_frame_count_with_padding,
        _case_sr_routes_exact_frame_match, _case_sr_rejects_unknown_geometry,
        _case_sr_rejects_bad_body, _case_sr_rejects_empty_volume)]
    cases.append(("_case_sr_nifti_roundtrip",
                  lambda: _case_sr_nifti_roundtrip(server, tmp_path)))
    cases += [(c.__name__, lambda c=c: c(server)) for c in (
        _case_metrics_exposition, _case_unknown_path_404,
        _case_debug_profile_endpoint)]
    run_cases(cases)


def test_daemons_of_their_own(tmp_path):
    """Lazy warm-up, a volume artifact, coalescing of concurrent requests,
    a lone request, a live pipeline from a checkpoint."""
    run_cases([(c.__name__, lambda c=c: c(subdir(tmp_path, c.__name__)))
               for c in (_case_no_warmup_becomes_warm_lazily,
                         _case_volume_artifact_over_http,
                         _case_pool_coalesces_concurrent_http_requests,
                         _case_pool_batching_single_request_unchanged,
                         _case_live_pipeline_and_checkpoint_over_http)])


def test_stream_sessions(stream_server, server):
    run_cases([
        ("_case_stream_sessions_match_direct_stream",
         lambda: _case_stream_sessions_match_direct_stream(stream_server)),
        ("_case_stream_sessions_are_isolated",
         lambda: _case_stream_sessions_are_isolated(stream_server)),
        ("_case_stream_error_paths",
         lambda: _case_stream_error_paths(stream_server, server))])


def test_daemon_parts():
    """The batcher, the metrics registry (against the JAX daemon's text),
    routing, the live pipeline's and the CLI's refusals."""
    run_cases([(c.__name__, c) for c in (
        _case_batcher_refuses_contract_violations,
        _case_batcher_coalesces_and_is_exact,
        _case_batcher_error_propagates_and_recovers,
        _case_metrics_histogram_and_label_escaping,
        _case_metrics_render_equals_the_jax_daemons_text,
        _case_route_volume_programs_exact_only,
        _case_sr_volume_refuses_mismatched_dt_geometry,
        _case_live_pipeline_rejects_lazy_w8a8,
        _case_cli_refuses_unported_flags)])
