"""The port's SIBR remote-viewer server (moss_torch/train/network_gui.py),
the viewer's camera and the Trainer's viewer hook, on the CPU: the
counterparts of tests/test_network_gui.py.

  * A loopback client and NetworkGUI: a length-prefixed JSON header in, the
    H*W*3 RGB bytes and the length-prefixed source path out; a client that
    hangs up mid-message is dropped and the server goes on.
  * Camera.from_viewer_spec against moss_tpu's, bit for bit, on an identity
    spec and on a training camera's matrices.
  * A Trainer(gui=...) run: the client sends a camera (the first train
    frame's matrices, at scale_modifier 1 and 0.5) while the trainer trains,
    and the bytes it gets equal the uint8 quantization of render_frame at
    that camera and the trainer's state.
"""
import json
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from moss_tpu.render.camera import Camera as JCamera
from moss_torch.config import Config, ModelConfig, OptimConfig
from moss_torch.data.synthetic import make_frames, make_scene
from moss_torch.ops import lpips
from moss_torch.render.camera import Camera
from moss_torch.render.render import render_frame
from moss_torch.train.network_gui import NetworkGUI, quantize
from moss_torch.train.trainer import Trainer
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"


def _send_msg(sock, msg: dict):
    body = json.dumps(msg).encode("utf-8")
    sock.sendall(struct.pack("<I", len(body)) + body)


def _viewer_msg(H, W, train=True, keep_alive=False, view=None, proj=None, scale=1.0):
    view = np.eye(4, dtype=np.float32) if view is None else view
    proj = np.eye(4, dtype=np.float32) if proj is None else proj
    return {"resolution_x": W, "resolution_y": H, "train": train, "fov_y": 0.8, "fov_x": 0.9,
            "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
            "keep_alive": keep_alive, "scale_modifier": scale,
            "view_matrix": np.asarray(view, np.float32).reshape(-1).tolist(),
            "view_projection_matrix": np.asarray(proj, np.float32).reshape(-1).tolist()}


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server hung up"
        buf += chunk
    return buf


def _recv_reply(sock, H, W):
    img = np.frombuffer(_recv_exact(sock, H * W * 3), np.uint8).reshape(H, W, 3)
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return img, _recv_exact(sock, n).decode("ascii")


def test_roundtrip():
    gui = NetworkGUI(port=0)
    gui.init()
    port = gui.listener.getsockname()[1]
    client = socket.create_connection(("127.0.0.1", port), timeout=5)
    client.settimeout(5)
    H, W = 8, 16
    _send_msg(client, _viewer_msg(H, W, train=True))
    calls = {}

    def render_fn(spec):
        calls["spec"] = spec
        assert spec["height"] == H and spec["width"] == W and spec["scale_modifier"] == 1.0
        img = torch.zeros((H, W, 3))
        img[0, 0] = torch.tensor([1.0, 0.5, 0.0])
        return img

    assert gui.poll(render_fn, "/data/subject", training_done=False)
    img, path = _recv_reply(client, H, W)
    assert tuple(img[0, 0]) == (255, 127, 0) and img.sum() == 255 + 127
    assert path == "/data/subject" and "spec" in calls
    client.close()
    gui.close()


def test_a_viewer_that_hangs_up_is_dropped(capsys):
    gui = NetworkGUI(port=0)
    gui.init()
    port = gui.listener.getsockname()[1]
    client = socket.create_connection(("127.0.0.1", port), timeout=5)
    client.sendall(struct.pack("<I", 100) + b"{")  # a header cut short
    client.close()
    assert gui.poll(lambda spec: None, "/x", training_done=False)
    assert gui.conn is None and "viewer disconnected" in capsys.readouterr().err
    gui.poll(lambda spec: None, "/x", training_done=False)  # nothing connects: no wait
    gui.close()


def _assert_camera_equal(cam, jcam):
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)),
                                      err_msg=f)
    assert (cam.height, cam.width) == (jcam.height, jcam.width)


def test_camera_from_viewer_spec_is_moss_tpus():
    spec = {"width": 64, "height": 32, "fovy": 0.8, "fovx": 0.9, "znear": 0.01, "zfar": 100.0,
            "world_view_transform": np.eye(4, dtype=np.float32),
            "full_proj_transform": np.eye(4, dtype=np.float32), "scale_modifier": 1.0}
    cam = Camera.from_viewer_spec(spec, device=CPU)
    _assert_camera_equal(cam, JCamera.from_viewer_spec(spec))
    np.testing.assert_allclose(cam.tan_fovx.numpy(), np.tan(0.45), rtol=1e-6)
    np.testing.assert_allclose(cam.cam_center.numpy(), 0.0, atol=1e-6)
    rng = np.random.default_rng(0)
    K = np.array([[80.0, 0, 40], [0, 80.0, 30], [0, 0, 1]])
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    train_cam = Camera.from_KRT(K, R, rng.normal(size=3), 60, 80, device=CPU)
    spec = dict(spec, world_view_transform=train_cam.world_view.numpy(),
                full_proj_transform=train_cam.full_proj.numpy())
    _assert_camera_equal(Camera.from_viewer_spec(spec, device=CPU),
                         JCamera.from_viewer_spec(spec))


def test_trainer_poll_serves_the_quantized_render():
    scene = make_scene(n_verts=64, device=CPU)
    frames, _ = make_frames(scene, n_frames=2, H=64, W=64, crop=32)
    cfg = Config(model=ModelConfig(sh_degree=1, capacity=128, n_init_points=64),
                 optim=OptimConfig(iterations=2, densify_from_iter=1000, densify_until_iter=0))
    gui = NetworkGUI(port=0)
    gui.init()
    port = gui.listener.getsockname()[1]
    tr = Trainer(scene, frames[:1], frames[1:], cfg, lpips.init_random(3407, CPU),
                 crop_hw=(32, 32), gui=gui, source_path="/syn", device=CPU)
    cam = frames[0].camera
    H = W = cam.height
    got, err = [], []

    def client():
        try:
            c = socket.create_connection(("127.0.0.1", port), timeout=300)
            c.settimeout(300)
            # one message a poll: at iteration 1, then at 2, the last, where
            # keep_alive off lets training end
            for scale, keep in ((1.0, True), (0.5, False)):
                _send_msg(c, _viewer_msg(H, W, train=True, keep_alive=keep,
                                         view=cam.world_view.numpy(),
                                         proj=cam.full_proj.numpy(), scale=scale))
                got.append(_recv_reply(c, H, W))
            c.close()
        except Exception as e:  # surfaced by the assertion below
            err.append(e)

    specs = []
    render = tr._gui_render
    tr._gui_render = lambda spec: specs.append(spec) or render(spec)
    t = threading.Thread(target=client)
    t.start()
    tr.train(2, eval_iters=[])
    t.join(timeout=300)
    gui.close()
    assert not err and len(got) == 2 and len(specs) == 2, (err, len(got), len(specs))
    # the last render was of the final state: render it again outside the viewer
    spec = specs[-1]
    assert spec["scale_modifier"] == 0.5
    ts = tr.ts
    with torch.no_grad():
        out = render_frame(ts.params["gauss"], ts.gstate.valid, ts.params["mlps"], scene,
                           frames[0].smpl_params, Camera.from_viewer_spec(spec, device=CPU),
                           tr.bg, cfg.model.sh_degree, scaling_modifier=0.5, device=CPU)
    img, path = got[-1]
    assert path == "/syn" and img.sum() > 0
    np.testing.assert_array_equal(img, quantize(out["render"]))
    assert not np.array_equal(got[0][0], img)  # scale_modifier 0.5 renders other bytes
