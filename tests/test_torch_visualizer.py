"""The port's viewer and parquet_to_ply: the viewer's controls (as
tests/test_visualizer_and_cli.py drives the JAX viewer), its frames
against the JAX viewer's after the same keys at rtol 2e-3 / atol 1e-4
(scene depths on a bucket ladder: tied keys may blend in another order),
its HTTP handler on localhost, and the PLY written by the port against the
JAX scene's `to_ply` of the same parquet."""

import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.models.scene import (
    GaussianPointCloudScene as JScene)
from taichi_3d_gaussian_splatting_torch import parquet_to_ply
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene, SceneConfig)
from taichi_3d_gaussian_splatting_torch.visualizer import (
    VisualizerState, make_handler)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _write_scene(tmp_path, seed, n=20):
    """A parquet of n splats; depths on a ladder 5 sort buckets (at the
    default 100 per unit) apart, mid-bucket, odd rungs for seed 1, so that
    no two points of the two scenes tie."""
    rng = np.random.default_rng(seed)
    z = 1.505 + 0.05 * (2 * rng.permutation(n) + seed)
    pc = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), z[:, None]],
                        1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-2.5, -1.5, (n, 3))
    feats[:, 7] = 2.0
    feats[:, 8] = rng.normal(size=n) + 2.0
    feats[:, 24] = rng.normal(size=n)
    path = str(tmp_path / f"scene_{seed}.parquet")
    TScene.from_arrays(pc, SceneConfig(), point_cloud_features=feats,
                       device="cpu").to_parquet(path)
    return path


@pytest.fixture
def scenes(tmp_path):
    return [_write_scene(tmp_path, 0), _write_scene(tmp_path, 1)]


def test_visualizer_state_controls(scenes):
    state = VisualizerState(scenes, width=32, height=32, focal=24.0,
                            device="cpu")
    assert state.handle_key("x") == "ignored x"
    png = state.frame_png()
    assert png[:4] == b"\x89PNG"

    # a camera move changes every pose
    t_before = state.ts.copy()
    assert state.handle_key("w").startswith("move")
    assert not np.allclose(state.ts, t_before)

    # with object 1 selected, motion moves only that object's pose
    assert "object 1" in state.handle_key("1")
    t_before = state.ts.copy()
    state.handle_key("d")
    assert np.allclose(state.ts[0], t_before[0])
    assert not np.allclose(state.ts[1], t_before[1])

    # rotation changes the quaternion and keeps it normalized
    q_before = state.qs.copy()
    state.handle_key("ArrowLeft")
    assert not np.allclose(state.qs[1], q_before[1])
    np.testing.assert_allclose(np.linalg.norm(state.qs, axis=1), 1.0,
                               atol=1e-5)

    # hide and show the selected object
    shown = state.frame()
    assert "hidden" in state.handle_key("h")
    assert not torch.equal(state.frame(), shown)
    assert "shown" in state.handle_key("p")
    assert torch.equal(state.frame(), shown)

    # scale the selected object
    assert "scale 1.10" in state.handle_key("]")

    # reset restores identity poses
    state.handle_key("r")
    assert np.allclose(state.ts, 0)

    # an out-of-range object is refused
    assert "no object" in state.handle_key("7")

    # a drag rotates the selected target only (object 1 is still selected)
    q_before = state.qs.copy()
    assert "object 1" in state.handle_drag(40.0, 0.0)
    assert np.allclose(state.qs[0], q_before[0])
    assert not np.allclose(state.qs[1], q_before[1])
    np.testing.assert_allclose(np.linalg.norm(state.qs, axis=1), 1.0,
                               atol=1e-5)
    # back to the camera: a drag moves every pose
    state.handle_key("`")
    q_before = state.qs.copy()
    assert "camera" in state.handle_drag(0.0, -25.0)
    assert not np.allclose(state.qs, q_before)


def _jax_frame(state):
    """The JAX viewer's current frame, as its frame_png renders it."""
    invalid = state.invalid.copy()
    for i, hidden in enumerate(state.hidden):
        if hidden:
            invalid[np.asarray(state.obj) == i] = 1
    return np.asarray(state._render(jnp.asarray(state.qs),
                                    jnp.asarray(state.ts),
                                    jnp.asarray(invalid),
                                    jnp.asarray(state.scales)))


def test_frames_match_jax_viewer(scenes):
    """After each key the port's frame equals the JAX viewer's at rtol
    2e-3 / atol 1e-4, and the two hold the same poses."""
    from visualizer import VisualizerState as JVisualizerState
    jstate = JVisualizerState(scenes, width=32, height=32, focal=24.0)
    tstate = VisualizerState(scenes, width=32, height=32, focal=24.0,
                             device="cpu")
    covered = 0
    for key in ("", "w", "ArrowLeft", "1", "d", "]", "]", "h", "p", "0",
                "[", "s"):
        if key:
            assert tstate.handle_key(key) == jstate.handle_key(key)
        np.testing.assert_allclose(tstate.ts, jstate.ts, atol=1e-6)
        np.testing.assert_allclose(tstate.qs, jstate.qs, atol=1e-6)
        got = tstate.frame().numpy()
        want = _jax_frame(jstate)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4,
                                   err_msg=f"after key {key!r}")
        covered += int((want > 0.05).any())
    assert covered == 12


def test_http_handler_on_localhost(scenes):
    """The page, a key, a drag and a PNG frame through the HTTP server."""
    from http.server import ThreadingHTTPServer
    import PIL.Image
    import io
    state = VisualizerState(scenes, width=48, height=32, focal=24.0,
                            device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                return resp.read()
        assert b'width="48"' in get("/")
        assert get("/key?k=w") == b"move w"
        assert get("/drag?dx=3&dy=x") == b"drag rotate camera"
        img = PIL.Image.open(io.BytesIO(get("/frame.png?t=1")))
        assert img.size == (48, 32)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_parquet_to_ply_matches_jax(scenes, tmp_path):
    """The port's CLI and the JAX scene's to_ply write the same vertices
    (every array equal after from_ply)."""
    ply_t = str(tmp_path / "port.ply")
    ply_j = str(tmp_path / "jax.ply")
    parquet_to_ply.main(["--parquet_path", scenes[0], "--ply_path", ply_t,
                         "--device", "cpu"])
    JScene.from_parquet(scenes[0]).to_ply(ply_j)
    got, want = JScene.from_ply(ply_t), JScene.from_ply(ply_j)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = TScene.from_ply(ply_t, device="cpu")
    assert back.num_valid_points() == 20
    np.testing.assert_array_equal(back.point_cloud.numpy()[:20],
                                  np.asarray(want.point_cloud)[:20])
