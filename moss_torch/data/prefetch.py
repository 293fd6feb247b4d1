"""Streaming frames: a host thread decodes ahead into a bounded queue (port
of moss_tpu/data/prefetch.py).

A worker thread decodes frame i + depth (FrameSpec.load: cv2, which
releases the interpreter lock) while the device works on frame i, so a
split's frames are never resident at once. Frames that are already loaded
pass through untouched, so eager and lazy splits share one interface.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple


def iter_frames(items: Iterable, crop_hw: Optional[Tuple[int, int]] = None, depth: int = 2,
                device=None) -> Iterator:
    """Yield Frames: FrameSpecs decoded `depth` ahead on a worker thread onto
    `device`, items without a `load` (Frames) as they are."""
    items = list(items)
    if not any(hasattr(it, "load") for it in items):
        yield from items
        return

    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    done = object()
    stop = threading.Event()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for it in items:
                if stop.is_set():
                    return
                if not put(it.load(crop_hw, device) if hasattr(it, "load") else it):
                    return
        except BaseException as e:  # raised again on the consumer's side
            put((done, e))
            return
        put((done, None))

    t = threading.Thread(target=worker, daemon=True, name="moss-frame-prefetch")
    t.start()
    try:
        while True:
            got = q.get()
            if isinstance(got, tuple) and len(got) == 2 and got[0] is done:
                if got[1] is not None:
                    raise got[1]
                return
            yield got
    finally:
        stop.set()  # the consumer finished or left early: stop decoding
        t.join(timeout=5.0)
