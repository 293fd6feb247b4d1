"""SMCReader: the DNA-Rendering capture files (.smc, HDF5), the port's own
copy of moss_tpu/data/smc.py:21-76.

It reads what the training reader needs: the actor's attributes, a camera's
calibration (K, D, RT, Color_Calibration), JPEG/PNG-encoded frames decoded
with cv2.imdecode (the same decoder as moss_tpu's, so the pixels agree bit
for bit), masks (the max over the decoded mask's channels) and the per-frame
SMPL-X block. h5py is imported when a file is opened, so the module imports
on a machine without it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class SMCReader:
    def __init__(self, path: str):
        import h5py

        self.smc = h5py.File(path, "r")
        attrs = self.smc.attrs
        self.actor_info = {k: attrs.get(a) for k, a in (
            ("id", "actor_id"), ("perf_id", "performance_id"), ("age", "age"),
            ("gender", "gender"), ("height", "height"), ("weight", "weight"))}

    def get_Calibration(self, camera_id) -> Dict[str, np.ndarray]:
        g = self.smc["Camera_Parameter"][f"{int(camera_id):02d}"]
        return {k: g[k][()] for k in ("D", "K", "RT", "Color_Calibration")}

    @staticmethod
    def _decode(buf) -> np.ndarray:
        return cv2.imdecode(buf, cv2.IMREAD_COLOR)

    def get_img(self, camera_group: str, camera_id, image_type: str = "color",
                frame_id=0) -> np.ndarray:
        """A frame of one camera: decoded (BGR, as cv2 gives it) for
        'color', the stored array otherwise."""
        data = self.smc[camera_group][str(int(camera_id))][image_type][str(int(frame_id))][()]
        return self._decode(data) if image_type == "color" else data

    def get_mask(self, camera_id, frame_id=0) -> Optional[np.ndarray]:
        """(H, W) uint8 mask, None when the file has no Mask group."""
        if "Mask" not in self.smc:
            return None
        buf = self.smc["Mask"][str(int(camera_id))]["mask"][str(int(frame_id))][()]
        return np.max(self._decode(buf), axis=2)

    def get_SMPLx(self, frame_id=None) -> Dict[str, np.ndarray]:
        """betas, expression, fullpose, transl (one frame's, or all frames'
        when frame_id is None) and scale."""
        g = self.smc["SMPLx"]
        out = {}
        for key in ("betas", "expression", "fullpose", "transl"):
            arr = g[key][()]
            out[key] = arr if frame_id is None else arr[int(frame_id)]
        out["scale"] = g["scale"][()]
        return out

    def release(self):
        self.smc.close()
